// K3: N GBM Euler-Maruyama steps plus a sine-MLP read u(t_n, X_n) at each of
// the N+1 times, in one launch.
//
// Replaces dnnpde_tpu/ops/rollout_kernel.py::rollout_paths_pallas (kernel
// body _rollout_kernel). For paths m < M, starting from the one state x0 (D,):
//   Y[m, n] = u(n*dt, X_n),   X_{n+1} = X_n + (mu_c*dt) X_n + (sig_c X_n) dW_n
// where u is the sine MLP with bf16 dot operands and f32 accumulation, and the
// t column enters as bf16(t) * bf16(W_0[0, :]) outside the X dot. dW is either
// read from dWs (M, N, D) or drawn in the kernel: counter-based Philox4x32-10
// with key = seed and counter = (path, step, dim / 4, j), j = 0 giving the
// first uniforms and j = 1 the second, then 23-bit uniforms and single-branch
// Box-Muller scaled by sqrt(dt). The stream does not depend on the tile size.
//
// Bound on an H100 SXM: at M = 16384, N = 50, [101, 256 x 4, 1] the dots are
// 2 * M * (N+1) * (100*256 + 3*256^2 + 256) ~ 0.37 TFLOP, 0.38 ms at the bf16
// tensor-core peak; the bytes (Y, and dWs in the explicit variant, 0.33 GB)
// take at most 0.1 ms. So it is bound by operations. What bounds the kernel
// in practice is the work beside the dots: 0.86 G accurate sinf (one per
// hidden unit and path-step, each a few dozen dependent instructions) and, in
// the seed variant, 2 Philox calls and a Box-Muller pair per 4 increments;
// then the weight stream, which every block reads again at every step.
//
// Design: one block of 16 warps per tile of 128 paths (at M = 16384, 128
// blocks: one wave on 132 SMs), a loop over the N+1 times inside the block,
// and the tile's f32 state X and bf16 activations (ping-pong) in shared
// memory for the whole rollout (215 KB at full width). Each layer is one
// tc_layer (common.cuh): mma.sync on tensor cores, each warp owning 32 paths
// x 64 columns, with the weights streamed from L2 in chunks of 32 k rows,
// rounded to bf16 into shared memory, the next chunk's loads in flight while
// the current one is multiplied. A block reads the 0.9 MB of f32 weights
// once per step for 128 paths, where a 16-path tile read them for 16: about
// 6 GB of L2 reads at the shapes above instead of 47. The sines run in
// tc_layer's rolled epilogue, where their code stays in the instruction
// cache; with one block per SM, 16 warps are what hides their latency and
// that of the Philox draws and the update. A net whose 128-path tile does
// not fit shared memory (hidden widths above 272 at D = 100) takes 16-path
// tiles instead, 16 warps across the columns as in K1, which hold widths up
// to 2992 at D = 100.
#include "common.cuh"

namespace {

constexpr int kWarps = kTcThreads / 32;
constexpr int kNW = 256;  // columns a tc_layer pass covers, in both tilings
constexpr int kStageElems = TcStage<kNW, false>::kElems;

// A tile of kRows = WM * MW * 16 paths: WM x WN warps, each MW m-tiles x NP
// column pairs. Full: 4 x 4 warps of 32 paths x 64 columns; narrow, for wide
// nets: 1 x 16 warps of 16 paths x 16 columns.
template <int MW_, int NP_, int WM_, int WN_>
struct Tiling {
  static constexpr int MW = MW_, NP = NP_, WM = WM_, WN = WN_;
  static constexpr int kRows = WM * MW * 16;
  static_assert(WN * NP * 16 == kNW, "one staging size for both tilings");
};
using FullTile = Tiling<2, 4, 4, 4>;
using NarrowTile = Tiling<1, 1, 1, 16>;

template <class T, typename Post>
__device__ __forceinline__ void layer(const bf16* A, int lda, int K, const float* W, int ldw,
                                      int n, bf16* stage, Post post) {
  tc_layer<T::MW, T::NP, T::WM, T::WN, false>(A, lda, K, W, ldw, n, stage, post);
}

__device__ __forceinline__ float em_step(float x, float drift, float sig_c, float dw) {
  return __fadd_rn(__fadd_rn(x, __fmul_rn(drift, x)), __fmul_rn(__fmul_rn(sig_c, x), dw));
}

template <class T, bool RNG>
__global__ void __launch_bounds__(kTcThreads, 1)
rollout_kernel(const float* __restrict__ x0, const float* __restrict__ dWs,
               float* __restrict__ Y, const MlpWeights w, int M, int N, float dt,
               float drift, float sig_c, float sqrt_dt, uint32_t key0, uint32_t key1,
               int lda) {
  constexpr int kRows = T::kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = w.L;
  const int D = w.width[0] - 1;
  const int ldx = dnnpde_round4(D);
  const int dpad = dnnpde_round16(D);
  bf16* stage = reinterpret_cast<bf16*>(smem);
  bf16* buf0 = stage + kStageElems;  // (kRows, lda) activations, ping
  bf16* buf1 = buf0 + kRows * lda;   // pong; bf16(X) for layer 0
  float* X = reinterpret_cast<float*>(buf1 + kRows * lda);  // (kRows, ldx) state, f32
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRows;
  const int n1 = w.width[1];
  const float* W0x = w.W[0] + n1;  // rows 1..D of W_0: the X rows
  const float* b0 = w.b[0];
  const int H = w.width[L - 1];
  const float b_out = __ldg(w.b[L - 1]);

  // X and its bf16 copy, zero beyond D
  for (int b = warp; b < kRows; b += kWarps)
    for (int d = lane; d < dpad; d += 32) {
      const float x = d < D ? __ldg(x0 + d) : 0.f;
      if (d < ldx) X[b * ldx + d] = x;
      buf1[b * lda + d] = __float2bfloat16_rn(x);
    }
  __syncthreads();

  for (int n = 0; n <= N; ++n) {
    // layer 0: [t, X] W_0 + b_0 with the t row outside the dot
    const float tb = bf16_round(static_cast<float>(n) * dt);
    layer<T>(buf1, lda, D, W0x, n1, n1, stage, [&](int b, int o, float acc) {
      float v = 0.f;
      if (o < n1) v = sinf((acc + tb * bf16_round(__ldg(w.W[0] + o))) + __ldg(b0 + o));
      buf0[b * lda + o] = __float2bfloat16_rn(v);
    });
    bf16* a = buf0;
    bf16* nxt = buf1;
    for (int k = 1; k < L - 1; ++k) {
      const int K = w.width[k], nk = w.width[k + 1];
      const float* bias = w.b[k];
      layer<T>(a, lda, K, w.W[k], nk, nk, stage, [&](int b, int o, float acc) {
        nxt[b * lda + o] = __float2bfloat16_rn(o < nk ? sinf(acc + __ldg(bias + o)) : 0.f);
      });
      bf16* tmp = a; a = nxt; nxt = tmp;
    }
    tile_head<kRows>(a, lda, H, w.W[L - 1], [&](int b, float s) {
      if (row0 + b < M) Y[(size_t)(row0 + b) * (N + 1) + n] = s + b_out;
    });
    if (n == N) break;
    __syncthreads();  // the head's reads of a (which may be buf1) are done

    // X <- X + (mu_c dt) X + (sig_c X) dW, and bf16(X) into buf1 for the next step
    if (RNG) {
      const int groups = (D + 3) >> 2;
      for (int i = threadIdx.x; i < kRows * groups; i += kTcThreads) {
        const int b = i / groups, g = i - b * groups;
        const uint32_t m = static_cast<uint32_t>(row0 + b);
        const uint4 r1 = philox4x32_10(make_uint4(m, n, g, 0u), key0, key1);
        const uint4 r2 = philox4x32_10(make_uint4(m, n, g, 1u), key0, key1);
        const uint32_t u1[4] = {r1.x, r1.y, r1.z, r1.w};
        const uint32_t u2[4] = {r2.x, r2.y, r2.z, r2.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = 4 * g + j;
          if (d < D) {
            const float dw = sqrt_dt * box_muller(u1[j], u2[j]);
            const float x = em_step(X[b * ldx + d], drift, sig_c, dw);
            X[b * ldx + d] = x;
            buf1[b * lda + d] = __float2bfloat16_rn(x);
          }
        }
      }
      for (int b = warp; b < kRows; b += kWarps)
        for (int d = D + lane; d < dpad; d += 32) buf1[b * lda + d] = __float2bfloat16_rn(0.f);
    } else {
      for (int b = warp; b < kRows; b += kWarps) {
        const int m = row0 + b;
        for (int d = lane; d < dpad; d += 32) {
          float x = 0.f;
          if (d < D) {
            const float dw = m < M ? __ldg(dWs + ((size_t)m * N + n) * D + d) : 0.f;
            x = em_step(X[b * ldx + d], drift, sig_c, dw);
            X[b * ldx + d] = x;
          }
          buf1[b * lda + d] = __float2bfloat16_rn(x);
        }
      }
    }
    __syncthreads();
  }
}

template <class T>
size_t tile_smem(int lda, int ldx) {
  return sizeof(bf16) * ((size_t)kStageElems + 2 * (size_t)T::kRows * lda) +
         sizeof(float) * (size_t)T::kRows * ldx;
}

template <class T>
cudaError_t launch(const float* x0, const float* dWs, float* Y, const MlpWeights& w, int M,
                   int N, float dt, float drift, float sig_c, float sqrt_dt,
                   unsigned long long seed, bool use_seed, int lda, size_t smem,
                   cudaStream_t s) {
  const uint32_t k0 = static_cast<uint32_t>(seed), k1 = static_cast<uint32_t>(seed >> 32);
  const dim3 grid((M + T::kRows - 1) / T::kRows);
  auto kernel = use_seed ? rollout_kernel<T, true> : rollout_kernel<T, false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kTcThreads, smem, s>>>(x0, use_seed ? nullptr : dWs, Y, w, M, N, dt, drift,
                                        sig_c, sqrt_dt, k0, k1, lda);
  return cudaGetLastError();
}

}  // namespace

// Launches K3 on `stream`. x0 (D,), dWs (M, N, D) or null with use_seed,
// Y (M, N+1): f32, contiguous, on the current device. drift = mu_c * dt.
// Returns cudaGetLastError() after the launch.
extern "C" int rollout_paths(const float* x0, const float* dWs, float* Y,
                             const void* const* Ws, const void* const* bs,
                             const int* widths, int L, int M, int N, float dt, float drift,
                             float sig_c, float sqrt_dt, unsigned long long seed,
                             int use_seed, void* stream) {
  MlpWeights w;
  cudaError_t err = dnnpde_fill_weights(&w, Ws, bs, widths, L);
  if (err != cudaSuccess) return err;
  if (M <= 0 || N < 0 || L < 3 || w.width[0] < 2) return cudaErrorInvalidValue;
  if (!use_seed && dWs == nullptr) return cudaErrorInvalidValue;
  int width = w.width[0] - 1;
  for (int k = 1; k < L; ++k) width = width > w.width[k] ? width : w.width[k];
  const int lda = dnnpde_round16(width) + 8;  // rows 16 bytes apart modulo 128
  const int ldx = dnnpde_round4(w.width[0] - 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t full = tile_smem<FullTile>(lda, ldx), narrow = tile_smem<NarrowTile>(lda, ldx);
  if (full <= DNNPDE_MAX_SMEM)
    return launch<FullTile>(x0, dWs, Y, w, M, N, dt, drift, sig_c, sqrt_dt, seed, use_seed,
                            lda, full, s);
  if (narrow <= DNNPDE_MAX_SMEM)
    return launch<NarrowTile>(x0, dWs, Y, w, M, N, dt, drift, sig_c, sqrt_dt, seed, use_seed,
                              lda, narrow, s);
  return cudaErrorInvalidValue;
}
