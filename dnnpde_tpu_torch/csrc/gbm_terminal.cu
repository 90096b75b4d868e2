// K4: terminal values S_T (M, D) of geometric Brownian motion, the path engine
// of the Monte-Carlo basket pricer, in one launch.
//
// Replaces dnnpde_tpu/ops/path_kernel.py::pallas_gbm_terminal (kernel body
// _gbm_terminal_kernel). For paths m < M and assets i < D:
//   z_sum[m, :] = sum_{n=0}^{N-1} z_n[m, :]                 (in step order)
//   zc[m, i]    = sum_{j<=i} z_sum[m, j] * L[i, j]          (or z_sum without L)
//   S_T[m, i]   = S0[i] * exp(a[i] + b[i] * zc[m, i])
// with a = N * (r - sigma^2 / 2) * dt and b = sigma * sqrt(dt) computed by the
// wrapper. GBM's log-dynamics are linear in the normals, so the Cholesky factor
// is applied once to the sum, as the TPU kernel does.
//
// Random numbers: Philox4x32-10 (common.cuh) keyed by seed, counter
// (pair p, step n, asset group g, j). Paths 2p and 2p+1 form pair p; asset
// group g holds assets 4g..4g+3. The call with j = 0 gives the four first
// uniforms, j = 1 the four second ones, each from the top 24 bits,
// (bits >> 8) * 2^-24, floored at 1e-12. Two-branch Box-Muller turns the
// uniform pair of asset 4g+k into r*cos(2 pi u2) for path 2p and r*sin for path
// 2p+1, with r = sqrt(-2 log u1). The stream does not depend on the block shape;
// ops/path_kernel.py::gbm_terminal_reference reproduces it value by value.
// The arithmetic uses the accurate logf, sqrtf, sincosf and expf and explicit
// _rn products and sums, so nvcc contracts nothing into an FMA the plain
// version does not have.
//
// Bound on an H100 SXM at M = 131072, N = 50, D = 100: per normal one half
// log, one half sqrt and one sin or cos (2 SFU-class operations) plus one exp
// per output, 1.3e9 operations; Philox's 32-bit multiplies are 40 per call and
// one call per 4 normals of a pair of paths, 6.6e9 multiplies at 64 per clock
// per SM; the correlation is 2*M*D*D flops at the f32 CUDA-core rate; the bytes
// are only S_T (52 MB). So it is bound by operations: the integer multiplies
// first, then the transcendentals. chip_smoke.py computes the terms from the
// card's clock.
//
// Design of this first version: a block owns a tile of path pairs; in phase 1
// each thread walks (pair, asset group) items and keeps the eight z-sums of
// its item in registers across the N steps, so nothing but S_T touches device
// memory; the sums go to shared memory; in phase 2 the threads walk
// (path, asset) in row-major order, apply L (transposed in shared memory when
// it fits, so neighbouring assets read neighbouring words) and write S_T
// coalesced. What bounds it in practice is the instruction issue of the
// accurate transcendentals (a few dozen instructions each) beside Philox.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPairs = 32;  // path pairs per block at most: 64 paths

// u in [1e-12, 1) from the top 24 bits, as the TPU kernel draws it.
__device__ __forceinline__ float uniform24(uint32_t bits) {
  return fmaxf(static_cast<float>(bits >> 8) * 5.9604644775390625e-08f, 1e-12f);
}

__global__ void __launch_bounds__(kThreads)
gbm_terminal_kernel(const float* __restrict__ S0, const float* __restrict__ a,
                    const float* __restrict__ b, const float* __restrict__ L,
                    float* __restrict__ out, int M, int D, int N, int pairs_per_block,
                    int l_in_smem, uint32_t key0, uint32_t key1) {
  extern __shared__ __align__(16) float smem[];
  float* zs = smem;                                // (2 * pairs_per_block, D) z-sums
  float* LT = zs + 2 * pairs_per_block * D;        // (D, D) L transposed, if it fits
  const int G = (D + 3) >> 2;
  const int pair0 = blockIdx.x * pairs_per_block;
  const int pairs = min(pairs_per_block, M / 2 - pair0);

  if (L != nullptr && l_in_smem) {
    for (int k = threadIdx.x; k < D * D; k += blockDim.x) {
      const int i = k / D, j = k - i * D;
      LT[j * D + i] = __ldg(L + k);
    }
  }

  for (int item = threadIdx.x; item < pairs * G; item += blockDim.x) {
    const int pl = item / G, g = item - pl * G;
    const uint32_t p = static_cast<uint32_t>(pair0 + pl);
    float z0[4] = {0.f, 0.f, 0.f, 0.f}, z1[4] = {0.f, 0.f, 0.f, 0.f};
    for (int n = 0; n < N; ++n) {
      const uint4 w1 = philox4x32_10(make_uint4(p, n, g, 0u), key0, key1);
      const uint4 w2 = philox4x32_10(make_uint4(p, n, g, 1u), key0, key1);
      const uint32_t u1[4] = {w1.x, w1.y, w1.z, w1.w};
      const uint32_t u2[4] = {w2.x, w2.y, w2.z, w2.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float r = sqrtf(__fmul_rn(-2.0f, logf(uniform24(u1[k]))));
        float s, c;
        sincosf(__fmul_rn(6.2831855f, uniform24(u2[k])), &s, &c);
        z0[k] = __fadd_rn(z0[k], __fmul_rn(r, c));
        z1[k] = __fadd_rn(z1[k], __fmul_rn(r, s));
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int d = 4 * g + k;
      if (d < D) {
        zs[(2 * pl) * D + d] = z0[k];
        zs[(2 * pl + 1) * D + d] = z1[k];
      }
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < 2 * pairs * D; e += blockDim.x) {
    const int row = e / D, i = e - row * D;
    const float* z = zs + row * D;
    float zc;
    if (L == nullptr) {
      zc = z[i];
    } else if (l_in_smem) {
      zc = 0.f;
      for (int j = 0; j <= i; ++j) zc = __fadd_rn(zc, __fmul_rn(z[j], LT[j * D + i]));
    } else {
      zc = 0.f;
      const float* Li = L + (size_t)i * D;
      for (int j = 0; j <= i; ++j) zc = __fadd_rn(zc, __fmul_rn(z[j], __ldg(Li + j)));
    }
    const float x = __fadd_rn(__ldg(a + i), __fmul_rn(__ldg(b + i), zc));
    out[(size_t)(2 * pair0 + row) * D + i] = __fmul_rn(__ldg(S0 + i), expf(x));
  }
}

}  // namespace

// Launches K4 on `stream`. S0, a, b (D,), L (D, D) lower-triangular row-major
// or null, out (M, D): f32, contiguous, on the current device; M even.
// Returns cudaGetLastError() after the launch.
extern "C" int gbm_terminal(const float* S0, const float* a, const float* b, const float* L,
                            float* out, int M, int D, int N, unsigned long long seed,
                            void* stream) {
  if (M <= 0 || M % 2 != 0 || D <= 0 || N < 1) return cudaErrorInvalidValue;
  int pairs = kMaxPairs;
  while (pairs > 1 && sizeof(float) * 2 * (size_t)pairs * D > DNNPDE_MAX_SMEM) pairs >>= 1;
  const size_t z_bytes = sizeof(float) * 2 * (size_t)pairs * D;
  if (z_bytes > DNNPDE_MAX_SMEM) return cudaErrorInvalidValue;
  const size_t l_bytes = sizeof(float) * (size_t)D * D;
  const int l_in_smem = L != nullptr && z_bytes + l_bytes <= DNNPDE_MAX_SMEM;
  const size_t smem = z_bytes + (l_in_smem ? l_bytes : 0);
  cudaError_t err = cudaFuncSetAttribute(gbm_terminal_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_pairs = M / 2;
  const dim3 grid((n_pairs + pairs - 1) / pairs);
  const uint32_t k0 = static_cast<uint32_t>(seed), k1 = static_cast<uint32_t>(seed >> 32);
  gbm_terminal_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      S0, a, b, L, out, M, D, N, pairs, l_in_smem, k0, k1);
  return cudaGetLastError();
}
