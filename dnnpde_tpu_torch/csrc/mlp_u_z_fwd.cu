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
// peak, 1.3 us for the bytes). At the training batch, B = 100, the bound is
// the 0.9 MB of weights (0.3 us). What bounds the kernel in practice is
// different: each 16-row tile works on one SM through 2(L-1) dependent layer
// passes, each a chain of 32-row weight chunks (an L2 round trip of f32
// weights, the bf16 store, the MMAs) and then the sines, and streams all
// 1.8 MB of weights through that SM (forward and sweep). At small B that
// chain is the time, about 0.06 ms on an H100 from B = 1 to 100; at large B
// it is the 1.8 MB per tile times the tiles per SM.
//
// Design: one block of 16 warps per 16-row tile, all in shared memory: the
// tile's bf16 activations (ping-pong), every hidden layer's cos(p_k) in f32
// for the sweep (64 KB at full width) and the weight-staging buffers, 121 KB
// in all. Each layer is one row16_layer (common.cuh's tc_layer, which K2's
// recompute shares, so K2 differentiates this forward exactly): the weights arrive in
// chunks of 32 k rows, f32 from L2 rounded to bf16 in shared memory, with
// the next chunk's loads in flight while the warps run mma.sync on the
// current one; the 16 warps split the layer's output columns (16 each at
// width 256), so all of them issue tensor-core work on the one tile, and 16
// warps hide the latency of the loads, the MMAs and the sines between them.
// The sweep stages the same weight rectangles and reads them without the
// transpose. One design serves every B; nothing but x, u and Z touches
// device memory.
#include "common.cuh"

namespace {

constexpr int kTile = 16;  // rows per block
constexpr int kStageElems = kRow16StageElems;

__global__ void __launch_bounds__(kTcThreads)
mlp_u_z_fwd_kernel(const float* __restrict__ x, float* __restrict__ u,
                   float* __restrict__ z, const MlpWeights w, int B, int lda) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* stage = reinterpret_cast<bf16*>(smem);
  bf16* buf0 = stage + kStageElems;
  bf16* buf1 = buf0 + kTile * lda;
  float* cosp = reinterpret_cast<float*>(buf1 + kTile * lda);  // cos p_k, k = 0 .. L-2
  const int L = w.L;
  const int n0 = w.width[0];
  const int row0 = blockIdx.x * kTile;

  const int n0p = dnnpde_round16(n0);
  for (int i = threadIdx.x; i < kTile * n0p; i += blockDim.x) {
    const int b = i / n0p, c = i - b * n0p;
    const int r = row0 + b;
    buf0[b * lda + c] = __float2bfloat16_rn(r < B && c < n0 ? x[(size_t)r * n0 + c] : 0.f);
  }
  __syncthreads();

  // forward through the hidden layers
  bf16* a = buf0;
  bf16* nxt = buf1;
  float* cp = cosp;
  for (int k = 0; k < L - 1; ++k) {
    const int K = w.width[k], n = w.width[k + 1];
    const float* bias = w.b[k];
    row16_layer<false>(a, lda, K, w.W[k], n, n, stage, [&](int b, int o, float acc) {
      float s = 0.f;
      if (o < n) {
        const float p = acc + __ldg(bias + o);
        cp[b * n + o] = cosf(p);
        s = sinf(p);
      }
      nxt[b * lda + o] = __float2bfloat16_rn(s);
    });
    bf16* tmp = a; a = nxt; nxt = tmp;
    cp += kTile * n;
  }

  // u = a_{L-2} W_{L-1} + b_{L-1}
  const int H = w.width[L - 1];
  const float b_out = __ldg(w.b[L - 1]);
  tile_head<kTile>(a, lda, H, w.W[L - 1], [&](int b, float s) {
    if (row0 + b < B) u[row0 + b] = s + b_out;
  });

  // Z-sweep; q = bf16(r * cos p_k) is the A operand of q W_k^T
  cp -= kTile * H;  // cos p_{L-2}
  bf16* q = nxt;
  const int hp = dnnpde_round16(H);
  for (int i = threadIdx.x; i < kTile * hp; i += blockDim.x) {
    const int b = i / hp, j = i - b * hp;
    q[b * lda + j] = __float2bfloat16_rn(j < H ? __ldg(w.W[L - 1] + j) * cp[b * H + j] : 0.f);
  }
  __syncthreads();  // also ends the head's reads of a, which becomes qn
  bf16* qn = a;
  for (int k = L - 2; k >= 0; --k) {
    const int K = w.width[k + 1], n = w.width[k];
    if (k > 0) {
      const float* cprev = cp - kTile * n;  // cos p_{k-1}
      row16_layer<true>(q, lda, K, w.W[k], K, n, stage, [&](int b, int o, float acc) {
        qn[b * lda + o] = __float2bfloat16_rn(o < n ? acc * cprev[b * n + o] : 0.f);
      });
      cp -= kTile * n;
    } else {
      row16_layer<true>(q, lda, K, w.W[0], K, n, stage, [&](int b, int o, float acc) {
        if (o < n && row0 + b < B) z[(size_t)(row0 + b) * n0 + o] = acc;
      });
    }
    bf16* tmp = q; q = qn; qn = tmp;
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
  int width = 0, hidden = 0;
  for (int k = 0; k < L; ++k) width = width > w.width[k] ? width : w.width[k];
  for (int k = 1; k < L; ++k) hidden += w.width[k];
  const int lda = dnnpde_round16(width) + 8;  // rows 16 bytes apart modulo 128
  const size_t smem = sizeof(bf16) * ((size_t)kStageElems + 2 * (size_t)kTile * lda) +
                      sizeof(float) * (size_t)kTile * hidden;
  if (smem > DNNPDE_MAX_SMEM) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(mlp_u_z_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + kTile - 1) / kTile);
  mlp_u_z_fwd_kernel<<<grid, kTcThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, u, z, w, B, lda);
  return cudaGetLastError();
}
