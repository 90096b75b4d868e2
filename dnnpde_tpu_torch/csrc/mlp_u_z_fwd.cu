// K1: fused sine-MLP forward plus Z-sweep, (u, Z_full) = (net(x), grad_x net(x)).
//
// Replaces dnnpde_tpu/ops/mlp_kernel.py::mlp_u_z_fwd_pallas (kernel body
// _fwd_kernel). For x = [t, X] (B, n0) and a sine MLP with L dense layers:
//   p_k = bf16(a_{k-1}) bf16(W_k) + b_k,  a_k = sin(p_k)        k < L-1
//   u   = bf16(a_{L-2}) bf16(W_{L-1}) + b_{L-1}
//   r   = W_{L-1}[:, 0];  r <- bf16(r * cos p_k) bf16(W_k)^T    k = L-2 .. 0
//   Z_full = r
// with f32 accumulation and f32 bias, sin and cos.
//
// Bound on an H100 SXM: at B = 4096 and [101, 256 x 4, 1] the dots are
// 2 * B * (101*256 + 3*256^2 + 256) * 2 ~ 3.7 GFLOP against ~4 MB of x, Z and
// weights, so the work is bound by operations (3.7 us at the bf16 tensor-core
// peak, 1.3 us for the bytes).
//
// Design of this first version: one block of 256 threads per tile of 16 rows.
// The tile's activations and every hidden layer's cos(p_k), which the sweep
// needs, stay in dynamic shared memory (96 KB at full width), so nothing but
// x, u and Z touches device memory. The weights (0.9 MB in f32) are read from
// L2 by every block and rounded to bf16 on the fly. The dots run on the CUDA
// cores in f32 FMAs (exact bf16 products), one output column per thread with
// the 16 row sums in registers. Tensor cores (mma.sync / wgmma) and TMA are
// what would close the gap to the bound.
#include "common.cuh"

namespace {

constexpr int kTile = 16;

template <int TILE>
__global__ void __launch_bounds__(DNNPDE_THREADS)
mlp_u_z_fwd_kernel(const float* __restrict__ x, float* __restrict__ u,
                   float* __restrict__ z, const MlpWeights w, int B, int ld) {
  extern __shared__ __align__(16) float smem[];
  const int L = w.L;
  const int n0 = w.width[0];
  float* buf0 = smem;
  float* buf1 = buf0 + TILE * ld;
  float* cosp = buf1 + TILE * ld;  // cos p_k, k = 0 .. L-2, back to back
  const int row0 = blockIdx.x * TILE;
  const int lda0 = dnnpde_round4(n0);

  for (int i = threadIdx.x; i < TILE * lda0; i += blockDim.x) {
    const int b = i / lda0, c = i - b * lda0;
    const int r = row0 + b;
    buf0[i] = (r < B && c < n0) ? bf16_round(x[(size_t)r * n0 + c]) : 0.f;
  }
  __syncthreads();

  // forward through the hidden layers
  float* a = buf0;
  float* nxt = buf1;
  float* cp = cosp;
  for (int k = 0; k < L - 1; ++k) {
    const int K = w.width[k], n = w.width[k + 1];
    const int lda = dnnpde_round4(K), ldn = dnnpde_round4(n);
    const float* bias = w.b[k];
    tile_dot<TILE>(a, lda, K, w.W[k], n, 1, n, [&](int b, int o, float acc) {
      const float p = acc + __ldg(bias + o);
      cp[b * n + o] = cosf(p);
      nxt[b * ldn + o] = bf16_round(sinf(p));
    });
    __syncthreads();
    float* tmp = a; a = nxt; nxt = tmp;
    cp += TILE * n;
  }

  // u = a_{L-2} W_{L-1} + b_{L-1}
  const int H = w.width[L - 1];
  const float b_out = __ldg(w.b[L - 1]);
  tile_head<TILE>(a, dnnpde_round4(H), H, w.W[L - 1], [&](int b, float s) {
    if (row0 + b < B) u[row0 + b] = s + b_out;
  });
  __syncthreads();

  // Z-sweep; q = bf16(r * cos p_k) is the A operand of q W_k^T
  cp -= TILE * H;  // cos p_{L-2}
  float* q = a == buf0 ? buf1 : buf0;
  const int ldh = dnnpde_round4(H);
  for (int i = threadIdx.x; i < TILE * ldh; i += blockDim.x) {
    const int b = i / ldh, j = i - b * ldh;
    q[i] = j < H ? bf16_round(__ldg(w.W[L - 1] + j) * cp[b * H + j]) : 0.f;
  }
  __syncthreads();
  float* qn = q == buf0 ? buf1 : buf0;
  for (int k = L - 2; k >= 0; --k) {
    const int K = w.width[k + 1], n = w.width[k];
    const int lda = dnnpde_round4(K), ldn = dnnpde_round4(n);
    if (k > 0) {
      float* cprev = cp - TILE * n;  // cos p_{k-1}
      tile_dot<TILE>(q, lda, K, w.W[k], 1, K, n, [&](int b, int o, float acc) {
        qn[b * ldn + o] = bf16_round(acc * cprev[b * n + o]);
      });
      cp = cprev;
    } else {
      tile_dot<TILE>(q, lda, K, w.W[0], 1, K, n, [&](int b, int o, float acc) {
        if (row0 + b < B) z[(size_t)(row0 + b) * n0 + o] = acc;
      });
    }
    __syncthreads();
    float* tmp = q; q = qn; qn = tmp;
  }
}

}  // namespace

// Launches K1 on `stream`. x (B, n0), u (B, 1), z (B, n0): f32, contiguous,
// on the current device. Returns cudaGetLastError() after the launch.
extern "C" int mlp_u_z_fwd(const float* x, float* u, float* z, const void* const* Ws,
                           const void* const* bs, const int* widths, int L, int B,
                           void* stream) {
  MlpWeights w;
  cudaError_t err = dnnpde_fill_weights(&w, Ws, bs, widths, L);
  if (err != cudaSuccess) return err;
  if (B <= 0) return cudaErrorInvalidValue;
  int ld = 0, hidden = 0;
  for (int k = 0; k < L; ++k) ld = ld > dnnpde_round4(w.width[k]) ? ld : dnnpde_round4(w.width[k]);
  for (int k = 1; k < L; ++k) hidden += w.width[k];
  const size_t smem = sizeof(float) * (size_t)kTile * (2 * (size_t)ld + hidden);
  if (smem > DNNPDE_MAX_SMEM) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(mlp_u_z_fwd_kernel<kTile>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + kTile - 1) / kTile);
  mlp_u_z_fwd_kernel<kTile><<<grid, DNNPDE_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, u, z, w, B, ld);
  return cudaGetLastError();
}
