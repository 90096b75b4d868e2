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
// Random numbers: Philox4x32-10 keyed by seed, counter (pair p, step n, asset
// group g, j). Paths 2p and 2p+1 form pair p; asset group g holds assets
// 4g..4g+3. The call with j = 0 gives the four first uniforms, j = 1 the four
// second ones, each from the top 24 bits, u = (bits >> 8) * 2^-24, the first
// floored at 1e-12. Two-branch Box-Muller turns the uniform pair of asset
// 4g+k into r*cos(2 pi u2) for path 2p and r*sin for path 2p+1, with
// r = sqrt(-2 log u1). The stream does not depend on the block shape;
// ops/path_kernel.py::gbm_terminal_reference computes the same function from
// the same stream with accurate libm, and each value here is within 1e-5 of
// its value there (the transcendentals below are the SFU's approximations).
//
// Bound on an H100 SXM at M = 131072, N = 50, D = 100: 6.6e8 normals, each
// needing half a log, half a sqrt and a sin or cos (2 SFU operations, 0.32 ms
// at 16 a clock per SM), and Philox's 32 x 32 -> 64-bit products: 34 per
// (pair, step, group) here (below), 0.33 ms at 64 32-bit multiplies a clock
// per SM. The correlation is M*D*D f32 flops (0.02 ms); the bytes are S_T only
// (52 MB, 0.016 ms, the bound at N = 1). So at N = 50 it is bound by
// operations, and the instruction issue (4 warp instructions a clock per SM)
// sits just above both terms: the design spends as few instructions per
// normal as it can (scripts/k4_anatomy.py counts them in the SASS).
//
// Design:
// - Philox. Round 0's two products depend only on (p, g), so they are taken
//   once per item, outside the step loop. The calls j = 0 and 1 differ only in
//   bit 0 of the third counter word, so they share round 1's first product and
//   round 2's second: 34 products per (item, step), not 40, each one
//   IMAD.WIDE. The round keys depend on the seed only; they arrive
//   precomputed as a kernel parameter and each three-way XOR takes its key
//   from a uniform register (one LOP3 per word).
// - Uniforms without a conversion instruction: for s = bits >> 8 < 2^24,
//   the float with bits 0x3F000000 | (s & 0x7FFFFF) is 1/2 + low * 2^-24
//   exactly; u is that minus 0 or 1/2, and 2 pi (u - 1/2) one FMA of it
//   with 2 pi and -pi or -2 pi, all exact but the FMA's one rounding.
//   tests/test_torch_path_kernel.py checks both for all 2^24 values.
// - Transcendentals on the SFU, with no denormal fix-ups (ftz; the arguments
//   are normal): r^2 = -2 ln2 * lg2.approx(u1), and near u1 = 1, where
//   lg2.approx's absolute error (2^-22) would dominate a small r, 2w + w^2
//   with w = 1 - u1 (exact), whose first neglected term is (2/3) w^3
//   <= 4e-5 * 2w at u1 > 0.99; r = sqrt.approx; sin and cos of
//   2 pi (u2 - 1/2), which lies in [-pi, pi) where the SFU's sine is within
//   2^-21.4, and cos(2 pi u2) = -cos(2 pi (u2 - 1/2)), sin likewise; exp by
//   ex2.approx. Nothing reaches a range reduction or a local-memory slow path.
//   Each normal is within ~2e-6 of its accurate value, each S_T within ~1e-6
//   of the plain version's over a 50-step sum.
// - Two (pair, group) items per thread, interleaved in one step loop, so one
//   item's Philox integer work and the other's float work issue side by side;
//   the sums are FMAs.
// - Uncorrelated: no shared memory, 57 registers (64 allocated), 32 warps per
//   SM; each thread writes its items' S_T as 16-byte stores, neighbouring
//   lanes on neighbouring groups of one row.
// - Correlated: a block of 320 threads owns 64 path pairs; at D = 100 its
//   1600 items are 5 per thread, with no tail round. The z-sums go to shared
//   memory transposed (asset-major, 51 KB at D = 100), three blocks per SM
//   (L^T beside them, 40 KB more, would leave two). Each thread then computes
//   a 4-path x 4-asset micro-tile of zc with 16 FMAs per 16-byte z load and
//   four warp-uniform L loads from L1, over j <= i only, and writes its S_T.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;      // uncorrelated kernel
constexpr int kItems = 2;          // (pair, group) items per thread, interleaved
constexpr int kCorrThreads = 320;  // correlated kernel: 10 warps
constexpr int kMaxPairs = 64;      // path pairs per correlated block at most
constexpr int kCorrBlocks = 3;     // correlated blocks per SM
// shared memory a correlated block may take so that kCorrBlocks fit on an SM
// (228 KB, less 1 KB the runtime reserves per block)
constexpr size_t kCorrSmem = 75 * 1024;

struct PhiloxKeys {
  uint32_t k0[10], k1[10];  // round i's keys: k0 + i * kPhiloxW0, k1 + i * kPhiloxW1
};

// Counter (p, n, g, j) after round 0, without n and j: round 0 maps it to
// (x ^ n, y, z ^ j, w).
struct Round0 {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ Round0 philox_round0(uint32_t p, uint32_t g, const PhiloxKeys& K) {
  Round0 r;
  philox_mulhilo(kPhiloxM1, g, r.x, r.y);
  philox_mulhilo(kPhiloxM0, p, r.z, r.w);
  r.x ^= K.k0[0];
  r.z ^= K.k1[0];
  return r;
}

// philox4x32_10((p, n, g, 0)) and ((p, n, g, 1)) from their common round 0.
__device__ __forceinline__ void philox_pair(const Round0& r, uint32_t n, const PhiloxKeys& K,
                                            uint4& a, uint4& b) {
  // round 1: the first product (of x) is common to both calls
  uint32_t hx, lx, ha, la, hb, lb;
  philox_mulhilo(kPhiloxM0, r.x ^ n, hx, lx);
  philox_mulhilo(kPhiloxM1, r.z, ha, la);
  philox_mulhilo(kPhiloxM1, r.z ^ 1u, hb, lb);
  a = make_uint4(ha ^ r.y ^ K.k0[1], la, hx ^ r.w ^ K.k1[1], lx);
  b = make_uint4(hb ^ r.y ^ K.k0[1], lb, a.z, lx);
  // round 2: the second product (of the common third word) is common
  uint32_t hz, lz, h0a, l0a, h0b, l0b;
  philox_mulhilo(kPhiloxM1, a.z, hz, lz);
  philox_mulhilo(kPhiloxM0, a.x, h0a, l0a);
  philox_mulhilo(kPhiloxM0, b.x, h0b, l0b);
  a = make_uint4(hz ^ a.y ^ K.k0[2], lz, h0a ^ a.w ^ K.k1[2], l0a);
  b = make_uint4(hz ^ b.y ^ K.k0[2], lz, h0b ^ b.w ^ K.k1[2], l0b);
#pragma unroll
  for (int i = 3; i < 10; ++i) {
    a = philox_round(a, K.k0[i], K.k1[i]);
    b = philox_round(b, K.k0[i], K.k1[i]);
  }
}

// (a & b) | c and (~a & b) | c as one LOP3 each (nvcc splits a two-constant
// expression into two)
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t andnot_or(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xAE;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// For s = bits >> 8 < 2^24 and u = s * 2^-24, the float with bits
// 0x3F000000 | (s & 0x7FFFFF) is 1/2 + low * 2^-24 (low: bits 8..30 of bits),
// which is u if bit 31 is set and u + 1/2 if not.

// u, floored at 1e-12, exactly: that float minus 0 or 1/2.
__device__ __forceinline__ float uniform24(uint32_t bits) {
  const float x = __uint_as_float(and_or(bits >> 8, 0x7FFFFFu, 0x3F000000u));
  const uint32_t sign = static_cast<uint32_t>(static_cast<int32_t>(bits) >> 31);
  return fmaxf(x - __uint_as_float(~sign & 0x3F000000u), 1e-12f);
}

// 2 pi (u - 1/2) = fl(2pi * (u - 1/2)) in [-pi, pi), by one FMA of that float
// with 2 pi and -2 pi h (h = 1/2 or 1): -pi's bits, with the exponent's lowest
// bit set when bit 31 is clear (-2 pi).
__device__ __forceinline__ float angle24(uint32_t bits) {
  const uint32_t s = bits >> 8;
  const float x = __uint_as_float(and_or(s, 0x7FFFFFu, 0x3F000000u));
  const float c = __uint_as_float(andnot_or(s, 0x800000u, 0xC0490FDBu));
  return fmaf(x, 6.2831855f, c);
}

// The SFU's log2 and square root, without the denormal handling of the
// non-ftz forms (their arguments here are normal numbers).
__device__ __forceinline__ float lg2_approx(float x) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// Adds the Box-Muller pair of the uniforms in bits1 (u1) and bits2 (u2):
// r cos(2 pi u2) = -r cos(2 pi (u2 - 1/2)) to z0, r sin(2 pi u2) to z1.
__device__ __forceinline__ void box_muller_add(uint32_t bits1, uint32_t bits2, float& z0,
                                               float& z1) {
  const float u1 = uniform24(bits1);
  float r2 = lg2_approx(u1) * -1.3862943611198906f;  // -2 ln u1
  if (u1 > 0.99f) {
    const float w = 1.0f - u1;  // exact
    r2 = fmaf(w, w, w + w);
  }
  const float r = sqrt_approx(r2);
  float s, c;
  __sincosf(angle24(bits2), &s, &c);
  z0 = fmaf(-r, c, z0);
  z1 = fmaf(-r, s, z1);
}

// The z-sums over N steps of K (pair, group) items, interleaved.
template <int K>
__device__ __forceinline__ void normal_sums(const uint32_t (&p)[K], const uint32_t (&g)[K], int N,
                                            const PhiloxKeys& keys, float (&z0)[K][4],
                                            float (&z1)[K][4]) {
  Round0 r0[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    r0[q] = philox_round0(p[q], g[q], keys);
#pragma unroll
    for (int k = 0; k < 4; ++k) z0[q][k] = z1[q][k] = 0.f;
  }
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      uint4 w1, w2;
      philox_pair(r0[q], static_cast<uint32_t>(n), keys, w1, w2);
      box_muller_add(w1.x, w2.x, z0[q][0], z1[q][0]);
      box_muller_add(w1.y, w2.y, z0[q][1], z1[q][1]);
      box_muller_add(w1.z, w2.z, z0[q][2], z1[q][2]);
      box_muller_add(w1.w, w2.w, z0[q][3], z1[q][3]);
    }
  }
}

__device__ __forceinline__ float terminal(const float* __restrict__ S0, const float* __restrict__ a,
                                          const float* __restrict__ b, int i, float zc) {
  return __ldg(S0 + i) * __expf(fmaf(__ldg(b + i), zc, __ldg(a + i)));
}

// Writes S_T of assets 4g..4g+3 (those below D) of row `row`.
__device__ __forceinline__ void store_group(float* __restrict__ out, const float* __restrict__ S0,
                                            const float* __restrict__ a,
                                            const float* __restrict__ b, size_t row, int g, int D,
                                            const float (&z)[4]) {
  const int d0 = 4 * g;
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = d0 + k < D ? terminal(S0, a, b, d0 + k, z[k]) : 0.f;
  float* dst = out + row * D + d0;
  if ((D & 3) == 0) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (d0 + k < D) dst[k] = v[k];
  }
}

// Uncorrelated: item = pair * G + g; a block covers kThreads * kItems items,
// thread t the items base + t and base + t + kThreads.
__global__ void __launch_bounds__(kThreads)
gbm_terminal_kernel(const float* __restrict__ S0, const float* __restrict__ a,
                    const float* __restrict__ b, float* __restrict__ out, int D, int N,
                    int n_items, const PhiloxKeys keys) {
  const int G = (D + 3) >> 2;
  const int base = blockIdx.x * (kThreads * kItems) + threadIdx.x;
  uint32_t p[kItems], g[kItems];
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int item = min(base + q * kThreads, n_items - 1);
    p[q] = static_cast<uint32_t>(item / G);
    g[q] = static_cast<uint32_t>(item - static_cast<int>(p[q]) * G);
  }
  float z0[kItems][4], z1[kItems][4];
  normal_sums<kItems>(p, g, N, keys, z0, z1);
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    if (base + q * kThreads >= n_items) break;
    store_group(out, S0, a, b, 2 * (size_t)p[q], g[q], D, z0[q]);
    store_group(out, S0, a, b, 2 * (size_t)p[q] + 1, g[q], D, z1[q]);
  }
}

// Phase 1 of the correlated kernel for K items: sums into the asset-major
// z-tile zT (D rows of `paths` floats).
template <int K>
__device__ __forceinline__ void corr_items(const int (&item)[K], int pairs_per_block, int pairs,
                                           int pair0, int D, int N, const PhiloxKeys& keys,
                                           float* zT, int paths) {
  uint32_t p[K], g[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int pl = item[q] % pairs_per_block;
    p[q] = static_cast<uint32_t>(pair0 + min(pl, pairs - 1));
    g[q] = static_cast<uint32_t>(item[q] / pairs_per_block);
  }
  float z0[K][4], z1[K][4];
  normal_sums<K>(p, g, N, keys, z0, z1);
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int pl = item[q] % pairs_per_block;
    if (pl >= pairs) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int d = 4 * static_cast<int>(g[q]) + k;
      if (d < D)
        *reinterpret_cast<float2*>(zT + (size_t)d * paths + 2 * pl) = make_float2(z0[q][k], z1[q][k]);
    }
  }
}

// Correlated: a block owns pairs_per_block path pairs (2 * pairs_per_block
// paths). Shared memory holds the z-tile, asset-major (D x paths); L is read
// through the L1 cache, where its 40 KB (D = 100) stay.
__global__ void __launch_bounds__(kCorrThreads, kCorrBlocks)
gbm_terminal_corr_kernel(const float* __restrict__ S0, const float* __restrict__ a,
                         const float* __restrict__ b, const float* __restrict__ L,
                         float* __restrict__ out, int M, int D, int N, int pairs_per_block,
                         const PhiloxKeys keys) {
  extern __shared__ __align__(16) float smem[];
  const int G = (D + 3) >> 2;
  const int paths = 2 * pairs_per_block;
  float* zT = smem;
  const int pair0 = blockIdx.x * pairs_per_block;
  const int pairs = min(pairs_per_block, M / 2 - pair0);
  const int tid = threadIdx.x;

  // phase 1: items (pl, g), pl fastest, kItems at a time
  const int n_items = pairs_per_block * G;
  int it = tid;
  for (; it + kCorrThreads < n_items; it += kItems * kCorrThreads) {
    const int items[kItems] = {it, it + kCorrThreads};
    corr_items<kItems>(items, pairs_per_block, pairs, pair0, D, N, keys, zT, paths);
  }
  if (it < n_items) {
    const int items[1] = {it};
    corr_items<1>(items, pairs_per_block, pairs, pair0, D, N, keys, zT, paths);
  }
  __syncthreads();

  // phase 2: zc and S_T in 4-path x 4-asset micro-tiles, path groups fastest
  // (a warp shares its assets, so its loop bounds and its L loads are
  // uniform); each lane writes 16 bytes of each of its 4 rows, and a row's
  // neighbouring 16 bytes come from the warp of the next asset group
  const int path_groups = paths >> 2;
  const int n_tiles = path_groups * G;
  const size_t row0 = 2 * (size_t)pair0;
  for (int tile = tid; tile < n_tiles; tile += kCorrThreads) {
    const int pg = tile % path_groups, i0 = 4 * (tile / path_groups);
    if (4 * pg >= 2 * pairs) continue;
    float acc[4][4] = {};
    const int j_end = min(i0 + 4, D);
    for (int j = 0; j < j_end; ++j) {
      const float4 zv = *reinterpret_cast<const float4*>(zT + (size_t)j * paths + 4 * pg);
      float ll[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) ll[ii] = i0 + ii < D ? __ldg(L + (size_t)(i0 + ii) * D + j) : 0.f;
      const float zz[4] = {zv.x, zv.y, zv.z, zv.w};
#pragma unroll
      for (int pp = 0; pp < 4; ++pp)
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) acc[pp][ii] = fmaf(zz[pp], ll[ii], acc[pp][ii]);
    }
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
      const int row = 4 * pg + pp;
      if (row < 2 * pairs) store_group(out, S0, a, b, row0 + row, i0 >> 2, D, acc[pp]);
    }
  }
}

PhiloxKeys round_keys(unsigned long long seed) {
  PhiloxKeys k;
  uint32_t k0 = static_cast<uint32_t>(seed), k1 = static_cast<uint32_t>(seed >> 32);
  for (int i = 0; i < 10; ++i) {
    k.k0[i] = k0;
    k.k1[i] = k1;
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return k;
}

}  // namespace

// Launches K4 on `stream`. S0, a, b (D,), L (D, D) lower-triangular row-major
// or null, out (M, D): f32, contiguous, on the current device; M even.
// Returns cudaGetLastError() after the launch.
extern "C" int gbm_terminal(const float* S0, const float* a, const float* b, const float* L,
                            float* out, int M, int D, int N, unsigned long long seed,
                            void* stream) {
  if (M <= 0 || M % 2 != 0 || D <= 0 || N < 1) return cudaErrorInvalidValue;
  const PhiloxKeys keys = round_keys(seed);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = (D + 3) / 4, n_pairs = M / 2;
  if (L == nullptr) {
    const long long n_items = (long long)n_pairs * G;
    if (n_items > 0x7FFFFFFFll - kThreads * kItems) return cudaErrorInvalidValue;
    const dim3 grid((unsigned)((n_items + kThreads * kItems - 1) / (kThreads * kItems)));
    gbm_terminal_kernel<<<grid, kThreads, 0, s>>>(S0, a, b, out, D, N, (int)n_items, keys);
    return cudaGetLastError();
  }
  // the z-tile within kCorrSmem, 2 pairs at least
  int pairs = kMaxPairs;
  while (pairs > 2 && sizeof(float) * (size_t)D * 2 * pairs > kCorrSmem) pairs >>= 1;
  const size_t smem = sizeof(float) * (size_t)D * 2 * pairs;
  if (smem > DNNPDE_MAX_SMEM) return cudaErrorInvalidValue;
  const dim3 grid((n_pairs + pairs - 1) / pairs);
  cudaError_t err = cudaFuncSetAttribute(gbm_terminal_corr_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  gbm_terminal_corr_kernel<<<grid, kCorrThreads, smem, s>>>(S0, a, b, L, out, M, D, N, pairs, keys);
  return cudaGetLastError();
}
