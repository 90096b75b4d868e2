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
//
// The NAIS-Net block (mlp_u_z_fwd_nais_kernel, the same body instantiated
// for the block kind): layer 0 is the MLP's; each layer k of 1 .. L-2 is a
// block on the concatenation [x, a_k] with the weight [U_k; 0; -A_k] of
// round16(n0) + H rows (the x columns padded with zero rows to a whole MMA
// step), and a residual:
//   p_k = bf16([x, a_k]) bf16(W_k) + b_k,  a_{k+1} = sin p_k + a_k
// The tile's operand buffers keep bf16(x) in their first round16(n0)
// columns for the whole forward pass, and the a_k follow it; the residual
// stream a_k stays f32 in shared memory and is rounded only as an operand.
// The sweep runs each block as two products on the same q_k = bf16(r_{k+1}
// cos p_k): by the a rows of W_k, r_k = r_{k+1} + q_k (-A_k)^T, the f32
// identity path, and by the x rows, whose products are summed over the
// blocks in f32 (Z_x); layer 0 ends with Z = q_0 W_0^T + Z_x.
#include "common.cuh"

namespace {

constexpr int kTile = 16;  // rows per block
constexpr int kStageElems = kRow16StageElems;

// One 16-row tile of either net: NAIS = false is the sine MLP, NAIS = true
// the NAIS-Net (see the note above); shared memory as mlp_u_z_fwd sizes it.
template <bool NAIS>
__device__ __forceinline__ void fwd_tile(const float* __restrict__ x, float* __restrict__ u,
                                         float* __restrict__ z, const MlpWeights& w, int B,
                                         int lda) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* stage = reinterpret_cast<bf16*>(smem);
  bf16* buf0 = stage + kStageElems;
  bf16* buf1 = buf0 + kTile * lda;
  float* cosp = reinterpret_cast<float*>(buf1 + kTile * lda);  // cos p_k, k = 0 .. L-2
  const int L = w.L;
  const int n0 = w.width[0];
  const int row0 = blockIdx.x * kTile;

  const int n0p = dnnpde_round16(n0);
  // NAIS: a_k's first column in an operand row; the f32 residual stream a_k
  // (the sweep's r_k after it) and the sum of the blocks' x products, after cosp
  const int xo = NAIS ? n0p : 0;
  const int H = w.width[1];
  int hidden = 0;
  for (int k = 1; k < L; ++k) hidden += w.width[k];
  float* res = cosp + kTile * hidden;
  float* zx = res + kTile * H;
  for (int i = threadIdx.x; i < kTile * n0p; i += blockDim.x) {
    const int b = i / n0p, c = i - b * n0p;
    const int r = row0 + b;
    const bf16 v = __float2bfloat16_rn(r < B && c < n0 ? x[(size_t)r * n0 + c] : 0.f);
    buf0[b * lda + c] = v;
    if (NAIS) buf1[b * lda + c] = v;
  }
  __syncthreads();

  // forward through the hidden layers
  bf16* a = buf0;
  bf16* nxt = buf1;
  float* cp = cosp;
  for (int k = 0; k < L - 1; ++k) {
    const int K = NAIS && k > 0 ? n0p + w.width[k] : w.width[k], n = w.width[k + 1];
    const float* bias = w.b[k];
    row16_layer<false>(a, lda, K, w.W[k], n, n, stage, [&](int b, int o, float acc) {
      float s = 0.f;
      if (o < n) {
        const float p = acc + __ldg(bias + o);
        cp[b * n + o] = cosf(p);
        s = sinf(p);
        if (NAIS) {
          if (k > 0) s += res[b * n + o];
          res[b * n + o] = s;
        }
      }
      nxt[b * lda + xo + o] = __float2bfloat16_rn(s);
    });
    bf16* tmp = a; a = nxt; nxt = tmp;
    cp += kTile * n;
  }

  // u = a_{L-2} W_{L-1} + b_{L-1}
  const int Hl = w.width[L - 1];
  const float b_out = __ldg(w.b[L - 1]);
  tile_head<kTile>(a + xo, lda, Hl, w.W[L - 1], [&](int b, float s) {
    if (row0 + b < B) u[row0 + b] = s + b_out;
  });

  // Z-sweep; q = bf(r * cos p_k) is the A operand of q W_k^T
  const float* wtop = w.W[L - 1];
  cp -= kTile * Hl;  // cos p_{L-2}
  bf16* q = nxt;
  const int hp = dnnpde_round16(Hl);
  for (int i = threadIdx.x; i < kTile * hp; i += blockDim.x) {
    const int b = i / hp, j = i - b * hp;
    q[b * lda + j] = __float2bfloat16_rn(j < Hl ? __ldg(wtop + j) * cp[b * Hl + j] : 0.f);
  }
  __syncthreads();  // also ends the head's reads of a, which becomes qn
  bf16* qn = a;
  for (int k = L - 2; k >= 0; --k) {
    const int K = w.width[k + 1], n = w.width[k];
    if (k > 0) {
      const float* cprev = cp - kTile * n;  // cos p_{k-1}
      if (NAIS) {
        // the x rows: this block's share of Z_x
        row16_layer<true>(q, lda, K, w.W[k], K, n0, stage, [&](int b, int o, float acc) {
          if (o < n0) zx[b * n0 + o] = k == L - 2 ? acc : zx[b * n0 + o] + acc;
        });
        // the a rows: r_k = r_{k+1} + q (-A_k)^T, in f32 (r_{L-1} = W_{L-1}[:, 0])
        row16_layer<true>(q, lda, K, w.W[k] + (size_t)n0p * K, K, n, stage,
                          [&](int b, int o, float acc) {
          float v = 0.f;
          if (o < n) {
            const float r = (k == L - 2 ? __ldg(wtop + o) : res[b * n + o]) + acc;
            res[b * n + o] = r;
            v = r * cprev[b * n + o];
          }
          qn[b * lda + o] = __float2bfloat16_rn(v);
        });
      } else {
        row16_layer<true>(q, lda, K, w.W[k], K, n, stage, [&](int b, int o, float acc) {
          qn[b * lda + o] = __float2bfloat16_rn(o < n ? acc * cprev[b * n + o] : 0.f);
        });
      }
      cp -= kTile * n;
    } else {
      row16_layer<true>(q, lda, K, w.W[0], K, n, stage, [&](int b, int o, float acc) {
        if (o < n && row0 + b < B)
          z[(size_t)(row0 + b) * n0 + o] = NAIS ? acc + zx[b * n0 + o] : acc;
      });
    }
    bf16* tmp = q; q = qn; qn = tmp;
  }
}

__global__ void __launch_bounds__(kTcThreads)
mlp_u_z_fwd_kernel(const float* __restrict__ x, float* __restrict__ u,
                   float* __restrict__ z, const MlpWeights w, int B, int lda) {
  fwd_tile<false>(x, u, z, w, B, lda);
}

__global__ void __launch_bounds__(kTcThreads)
mlp_u_z_fwd_nais_kernel(const float* __restrict__ x, float* __restrict__ u,
                        float* __restrict__ z, const MlpWeights w, int B, int lda) {
  fwd_tile<true>(x, u, z, w, B, lda);
}

// K1 for either net; the NAIS-Net's weights are W_0 (n0 x H), the blocks'
// (round16(n0) + H) x H and W_{L-1} (H x 1), with widths [n0, H, ..., H, 1].
int launch(const float* x, float* u, float* z, const void* const* Ws, const void* const* bs,
           const int* widths, int L, int B, void* stream, bool nais) {
  MlpWeights w;
  cudaError_t err = dnnpde_fill_weights(&w, Ws, bs, widths, L);
  if (err != cudaSuccess) return err;
  if (B <= 0 || (nais && L < 3)) return cudaErrorInvalidValue;
  int width = 0, hidden = 0;
  for (int k = 0; k < L; ++k) width = width > w.width[k] ? width : w.width[k];
  for (int k = 1; k < L; ++k) hidden += w.width[k];
  const int n0 = w.width[0], H = w.width[1];
  // the widest operand row: [x, a_k] for the NAIS-Net's blocks
  if (nais) width = dnnpde_round16(n0) + dnnpde_round16(H);
  const int lda = dnnpde_round16(width) + 8;  // rows 16 bytes apart modulo 128
  size_t smem = sizeof(bf16) * ((size_t)kStageElems + 2 * (size_t)kTile * lda) +
                sizeof(float) * (size_t)kTile * hidden;
  if (nais) smem += sizeof(float) * (size_t)kTile * (H + n0);  // the residual stream, Z_x
  if (smem > DNNPDE_MAX_SMEM) return cudaErrorInvalidValue;
  const auto kernel = nais ? mlp_u_z_fwd_nais_kernel : mlp_u_z_fwd_kernel;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + kTile - 1) / kTile);
  kernel<<<grid, kTcThreads, smem, static_cast<cudaStream_t>(stream)>>>(x, u, z, w, B, lda);
  return cudaGetLastError();
}

}  // namespace

// Launches K1 on `stream`. x (B, n0), u (B, 1), z (B, n0): f32, contiguous,
// on the current device. Returns cudaGetLastError() after the launch.
extern "C" int mlp_u_z_fwd(const float* x, float* u, float* z, const void* const* Ws,
                           const void* const* bs, const int* widths, int L, int B,
                           void* stream) {
  return launch(x, u, z, Ws, bs, widths, L, B, stream, false);
}

// The same for the NAIS-Net (mlp_u_z_fwd_nais_kernel): widths [n0, H, ...,
// H, 1] with at least one block, the weights as launch() states.
extern "C" int mlp_u_z_fwd_nais(const float* x, float* u, float* z, const void* const* Ws,
                                const void* const* bs, const int* widths, int L, int B,
                                void* stream) {
  return launch(x, u, z, Ws, bs, widths, L, B, stream, true);
}
