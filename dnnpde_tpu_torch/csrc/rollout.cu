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
// take at most 0.1 ms. So it is bound by operations.
//
// Design of this first version: one block of 256 threads per tile of 16 paths,
// a loop over the N+1 times inside the block, and the tile's X and activations
// in shared memory for the whole rollout. The dots run on the CUDA cores in f32
// FMAs (exact bf16 products). What bounds it in practice is that every block
// re-reads the 0.9 MB of f32 weights from L2 at every step (about 47 GB of L2
// reads at the shapes above); bf16 weights staged in shared memory or held
// across a persistent block, and tensor cores, are the next steps.
#include "common.cuh"

namespace {

constexpr int kTile = 16;

template <int TILE, bool RNG>
__global__ void __launch_bounds__(DNNPDE_THREADS)
rollout_kernel(const float* __restrict__ x0, const float* __restrict__ dWs,
               float* __restrict__ Y, const MlpWeights w, int M, int N, float dt,
               float drift, float sig_c, float sqrt_dt, uint32_t key0, uint32_t key1,
               int ld) {
  extern __shared__ __align__(16) float smem[];
  const int L = w.L;
  const int D = w.width[0] - 1;
  const int ldx = dnnpde_round4(D);
  float* X = smem;                 // (TILE, D) state, f32
  float* ax = X + TILE * ldx;      // (TILE, ldx) bf16(X)
  float* buf0 = ax + TILE * ldx;   // (TILE, ld) activations, ping
  float* buf1 = buf0 + TILE * ld;  // pong
  const int row0 = blockIdx.x * TILE;
  const int n1 = w.width[1];
  const float* W0x = w.W[0] + n1;  // rows 1..D of W_0: the X rows
  const int H = w.width[L - 1];
  const float b_out = __ldg(w.b[L - 1]);

  for (int i = threadIdx.x; i < TILE * ldx; i += blockDim.x) {
    const int d = i % ldx;
    X[i] = d < D ? __ldg(x0 + d) : 0.f;
  }
  __syncthreads();

  for (int n = 0; n <= N; ++n) {
    for (int i = threadIdx.x; i < TILE * ldx; i += blockDim.x) ax[i] = bf16_round(X[i]);
    __syncthreads();

    // layer 0: [t, X] W_0 + b_0 with the t row outside the dot
    const float tb = bf16_round(static_cast<float>(n) * dt);
    const float* b0 = w.b[0];
    const int ld1 = dnnpde_round4(n1);
    tile_dot<TILE>(ax, ldx, D, W0x, n1, 1, n1, [&](int b, int o, float acc) {
      const float p = (acc + tb * bf16_round(__ldg(w.W[0] + o))) + __ldg(b0 + o);
      buf0[b * ld1 + o] = bf16_round(sinf(p));
    });
    __syncthreads();
    float* a = buf0;
    float* nxt = buf1;
    for (int k = 1; k < L - 1; ++k) {
      const int K = w.width[k], nk = w.width[k + 1];
      const int ldk = dnnpde_round4(nk);
      const float* bias = w.b[k];
      tile_dot<TILE>(a, dnnpde_round4(K), K, w.W[k], nk, 1, nk, [&](int b, int o, float acc) {
        nxt[b * ldk + o] = bf16_round(sinf(acc + __ldg(bias + o)));
      });
      __syncthreads();
      float* tmp = a; a = nxt; nxt = tmp;
    }
    tile_head<TILE>(a, dnnpde_round4(H), H, w.W[L - 1], [&](int b, float s) {
      if (row0 + b < M) Y[(size_t)(row0 + b) * (N + 1) + n] = s + b_out;
    });

    if (n < N) {
      if (RNG) {
        const int groups = (D + 3) >> 2;
        for (int i = threadIdx.x; i < TILE * groups; i += blockDim.x) {
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
              const float x = X[b * ldx + d];
              const float dw = sqrt_dt * box_muller(u1[j], u2[j]);
              X[b * ldx + d] = __fadd_rn(__fadd_rn(x, __fmul_rn(drift, x)),
                                         __fmul_rn(__fmul_rn(sig_c, x), dw));
            }
          }
        }
      } else {
        for (int i = threadIdx.x; i < TILE * D; i += blockDim.x) {
          const int b = i / D, d = i - b * D;
          const int m = row0 + b;
          const float dw = m < M ? __ldg(dWs + ((size_t)m * N + n) * D + d) : 0.f;
          const float x = X[b * ldx + d];
          X[b * ldx + d] = __fadd_rn(__fadd_rn(x, __fmul_rn(drift, x)),
                                     __fmul_rn(__fmul_rn(sig_c, x), dw));
        }
      }
    }
    __syncthreads();
  }
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
  int ld = 0;
  for (int k = 1; k < L; ++k) ld = ld > dnnpde_round4(w.width[k]) ? ld : dnnpde_round4(w.width[k]);
  const int ldx = dnnpde_round4(w.width[0] - 1);
  const size_t smem = sizeof(float) * (size_t)kTile * (2 * (size_t)ldx + 2 * (size_t)ld);
  if (smem > DNNPDE_MAX_SMEM) return cudaErrorInvalidValue;
  const uint32_t k0 = static_cast<uint32_t>(seed), k1 = static_cast<uint32_t>(seed >> 32);
  const dim3 grid((M + kTile - 1) / kTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_seed) {
    err = cudaFuncSetAttribute(rollout_kernel<kTile, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    rollout_kernel<kTile, true><<<grid, DNNPDE_THREADS, smem, s>>>(
        x0, nullptr, Y, w, M, N, dt, drift, sig_c, sqrt_dt, k0, k1, ld);
  } else {
    err = cudaFuncSetAttribute(rollout_kernel<kTile, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    rollout_kernel<kTile, false><<<grid, DNNPDE_THREADS, smem, s>>>(
        x0, dWs, Y, w, M, N, dt, drift, sig_c, sqrt_dt, k0, k1, ld);
  }
  return cudaGetLastError();
}
