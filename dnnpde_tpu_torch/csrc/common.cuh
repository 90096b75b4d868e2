// Shared pieces of the Hopper kernels: the MLP weight table passed by value,
// bf16 operand rounding, the tensor-core layer (K1, K2's row chain, K3) and
// Philox4x32-10.
//
// Every dot product rounds both operands to bf16 with round-to-nearest-even
// and accumulates in f32. A bf16 x bf16 product is exact in f32, so a kernel
// and its plain PyTorch version differ only in the order of summation.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define DNNPDE_MAX_LAYERS 8
#define DNNPDE_THREADS 256
#define DNNPDE_MAX_SMEM (227 * 1024)

// Dense layer k maps width[k] -> width[k+1]; W[k] is (width[k], width[k+1])
// row-major (the JAX (in, out) layout), b[k] is (width[k+1],).
struct MlpWeights {
  const float* W[DNNPDE_MAX_LAYERS];
  const float* b[DNNPDE_MAX_LAYERS];
  int width[DNNPDE_MAX_LAYERS + 1];
  int L;
};

__host__ __device__ inline int dnnpde_round4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int dnnpde_round16(int n) { return (n + 15) & ~15; }

// Fills the weight table from the host arrays handed over by ctypes.
static inline cudaError_t dnnpde_fill_weights(MlpWeights* w, const void* const* Ws,
                                              const void* const* bs, const int* widths,
                                              int L) {
  if (L < 2 || L > DNNPDE_MAX_LAYERS) return cudaErrorInvalidValue;
  w->L = L;
  for (int k = 0; k < L; ++k) {
    w->W[k] = static_cast<const float*>(Ws[k]);
    w->b[k] = static_cast<const float*>(bs[k]);
  }
  for (int k = 0; k <= L; ++k) {
    if (widths[k] <= 0) return cudaErrorInvalidValue;
    w->width[k] = widths[k];
  }
  return w->width[L] == 1 ? cudaSuccess : cudaErrorInvalidValue;
}

extern "C" const char* dnnpde_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---- Tensor-core tiles (K1, K2's row chain, K3) ----------------------------
//
// tc_layer computes, for a block's tile of rows,
//   post(row, col, sum_k A[row, k] * bf16(Wop[k, col]))
// on mma.sync.m16n8k16 (bf16 operands, f32 accumulation). A is the tile's
// activations, bf16 in shared memory; Wop is a weight matrix W (K x n,
// row-major) in the forward direction, or its transpose in the Z-sweep (W is
// then n x K). Both directions stage the same thing: a rectangle of W in its
// own layout, rounded to bf16. The forward reads the staged rectangle (k
// rows, n columns) with ldmatrix.trans, the sweep (n rows, k columns) with
// plain ldmatrix, so one staging routine serves both.
//
// Staging: W stays f32 in device memory and is read in chunks of kTcKc rows of
// k, 16-byte coalesced loads into registers, rounded with __float2bfloat16_rn
// into one of two shared-memory buffers; the next chunk's loads are in flight
// while the current one is multiplied. A bf16 copy of the weights made by the
// entry point would halve the bytes read from L2, but it needs a scratch buffer
// from the wrapper and a second launch, which changes the C entry points and
// costs a few microseconds on every call; the f32 chunks are L2-resident and
// their loads overlap the MMAs instead.
//
// Epilogue: each warp parks one 16 x 16 accumulator block at a time in a
// per-warp f32 scratch (which reuses the staging buffers) and calls post
// from a rolled loop, one column per lane. post carries the sine; inlined
// into a fully unrolled register epilogue, the accurate sinf's code (fast
// and slow path, for each of the 64-128 accumulators a thread holds) would
// not fit the instruction cache.
//
// Ragged widths: A's columns K..round16(K) must hold finite values (a zero
// weight times a finite value adds an exact zero); the staged rectangle is
// zero outside W, so the padded k rows and n columns add exact zeros. post is
// called for every column below round16(n), and the caller decides what to
// do with col >= n.
//
// Warp layout: WM x WN warps of a kTcThreads block; each warp owns MW 16-row
// m-tiles and NP column pairs (16 columns each, pairs wn, wn + WN, ...), so
// a pass covers NW = WN * NP * 16 columns; wider layers take several passes.
using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 512;  // 16 warps: enough to hide the latency of the scalar work
constexpr int kTcKc = 32;        // k rows of weights per staged chunk

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 out. The tensor core
// sums the 16 exact products into a zero accumulator and the result is added
// to c with an IEEE round-to-nearest add. Letting the tensor core add into c
// itself truncates instead of rounding, which biases the running sum by a few
// f32 ulps over a 256-term dot; near a bf16 tie of the next layer's operand
// that drift flips the rounding, and in a network whose output cancels (the
// basket's u is ~1/200 of sum |W_L|) the flips became visible against the
// plain version's f32 GEMM. Rounded adds keep the sums as close to it as
// sequential f32 FMAs.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  float d0, d1, d2, d3;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d0), "=f"(d1), "=f"(d2), "=f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
  c[0] = __fadd_rn(c[0], d0);
  c[1] = __fadd_rn(c[1], d1);
  c[2] = __fadd_rn(c[2], d2);
  c[3] = __fadd_rn(c[3], d3);
}

// One staged rectangle of RC x CC weights: loaded into registers as f32 by
// the block, stored to shared memory as bf16 with row stride kLd (CC + 8:
// rows 16 bytes apart modulo 128, so ldmatrix's eight row reads hit eight
// bank groups).
template <int RC, int CC>
struct WChunk {
  static_assert(CC % 4 == 0 && (RC * CC) % (4 * kTcThreads) == 0, "chunk shape");
  static constexpr int kItems = RC * CC / 4 / kTcThreads;
  static constexpr int kLd = CC + 8;
  static constexpr int kElems = RC * kLd;
  float4 v[kItems];

  // W[r0 + r, c0 + c] for the rectangle, zero outside the nr x nc matrix;
  // vec: W is 16-byte aligned and ldw % 4 == 0 (c0 is a multiple of 4)
  __device__ __forceinline__ void load(const float* __restrict__ W, int ldw, int nr, int nc,
                                       int r0, int c0, bool vec) {
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int i = threadIdx.x + it * kTcThreads;
      const int r = r0 + i / (CC / 4), c = c0 + (i % (CC / 4)) * 4;
      const float* src = W + (size_t)r * ldw + c;
      if (r < nr && vec && c + 4 <= nc) {
        v[it] = __ldg(reinterpret_cast<const float4*>(src));
      } else {
        const bool row = r < nr;
        v[it].x = row && c < nc ? __ldg(src) : 0.f;
        v[it].y = row && c + 1 < nc ? __ldg(src + 1) : 0.f;
        v[it].z = row && c + 2 < nc ? __ldg(src + 2) : 0.f;
        v[it].w = row && c + 3 < nc ? __ldg(src + 3) : 0.f;
      }
    }
  }

  __device__ __forceinline__ void store(bf16* dst) const {
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int i = threadIdx.x + it * kTcThreads;
      const int r = i / (CC / 4), c = (i % (CC / 4)) * 4;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[it].x, v[it].y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[it].z, v[it].w);
      uint2 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&lo);
      packed.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(dst + r * kLd + c) = packed;
    }
  }
};

// bf16 elements of tc_layer's two staging buffers for pass width NW
template <int NW, bool SWEEP>
struct TcStage {
  static constexpr int kRows = SWEEP ? NW : kTcKc, kCols = SWEEP ? kTcKc : NW;
  static constexpr int kElems = 2 * kRows * (kCols + 8);
};

// See the note above. A: bf16, row stride lda (a multiple of 8), at least
// WM*MW*16 rows and round16(K) columns. W: f32, row stride ldw; K x n when
// !SWEEP, n x K when SWEEP. stage: TcStage<NW, SWEEP>::kElems bf16, also
// the epilogue's scratch. Every thread of the block must call it. It ends
// with __syncthreads(), after which post's writes are visible to the block;
// post may write any shared memory but A and stage.
template <int MW, int NP, int WM, int WN, bool SWEEP, typename Post>
__device__ __forceinline__ void tc_layer(const bf16* A, int lda, int K,
                                         const float* __restrict__ W, int ldw, int n,
                                         bf16* stage, Post post) {
  static_assert(WM * WN * 32 == kTcThreads, "one warp per (wm, wn)");
  static_assert(kTcKc % 16 == 0, "k chunks are whole mma steps");
  constexpr int NW = WN * NP * 16;
  using Stage = TcStage<NW, SWEEP>;
  using Chunk = WChunk<Stage::kRows, Stage::kCols>;
  static_assert(kTcThreads * 32 <= Stage::kElems * 2,
                "the epilogue scratch fits the staging buffers");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_base = (warp % WM) * MW * 16;
  const int wn = warp / WM;
  const int kpad = (K + 15) & ~15;
  const int nchunks = (kpad + kTcKc - 1) / kTcKc;
  const bool vec = (ldw & 3) == 0 && (reinterpret_cast<uintptr_t>(W) & 15) == 0;
  const int nr = SWEEP ? n : K, nc = SWEEP ? K : n;
  // this lane's ldmatrix row address within a 16x16 A tile and a 16-column B pair
  const bf16* a_lane = A + (row_base + (lane & 15)) * lda + (lane >> 4) * 8;
  const int b_lane = SWEEP ? ((lane & 7) + ((lane >> 4) << 3)) * Chunk::kLd + ((lane >> 3) & 1) * 8
                           : (lane & 15) * Chunk::kLd + (lane >> 4) * 8;
  float* scratch = reinterpret_cast<float*>(stage) + warp * 256;
  for (int n0 = 0; n0 < n; n0 += NW) {
    const int npairs = (min(n - n0, NW) + 15) >> 4;
    Chunk ch;
    auto fetch = [&](int c) {
      if (SWEEP) ch.load(W, ldw, nr, nc, n0, c * kTcKc, vec);
      else ch.load(W, ldw, nr, nc, c * kTcKc, n0, vec);
    };
    float acc[MW][NP][2][4];
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int j = 0; j < NP; ++j)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][t][e] = 0.f;
    auto multiply = [&](int c) {
      const bf16* Bs = stage + (c & 1) * Chunk::kElems;
      const int ksteps = min(kTcKc, kpad - c * kTcKc) >> 4;
#pragma unroll
      for (int ks = 0; ks < kTcKc / 16; ++ks) {
        if (ks < ksteps) {
          const int k0 = c * kTcKc + ks * 16;
          uint32_t a[MW][4];
#pragma unroll
          for (int mi = 0; mi < MW; ++mi) ldsm_x4(a[mi], a_lane + mi * 16 * lda + k0);
#pragma unroll
          for (int j = 0; j < NP; ++j) {
            const int p = wn + j * WN;
            if (p < npairs) {
              uint32_t b[4];
              if (SWEEP) ldsm_x4(b, Bs + b_lane + p * 16 * Chunk::kLd + ks * 16);
              else ldsm_x4_trans(b, Bs + b_lane + ks * 16 * Chunk::kLd + p * 16);
#pragma unroll
              for (int mi = 0; mi < MW; ++mi) {
                mma_bf16_16816(acc[mi][j][0], a[mi], b[0], b[1]);
                mma_bf16_16816(acc[mi][j][1], a[mi], b[2], b[3]);
              }
            }
          }
        }
      }
    };
    // chunk c lives in buffer c & 1
    fetch(0);
    ch.store(stage);
    __syncthreads();
    for (int c = 0; c < nchunks; ++c) {
      if (c + 1 < nchunks) fetch(c + 1);  // in flight during this chunk's MMAs
      multiply(c);
      if (c + 1 < nchunks) ch.store(stage + ((c + 1) & 1) * Chunk::kElems);
      __syncthreads();
    }
    // epilogue; accumulator layout of m16n8: (row g, cols 2q, 2q+1), (row g + 8, same)
    const int g = lane >> 2, q2 = (lane & 3) * 2;
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const int p = wn + j * WN;
        if (p < npairs) {
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            *reinterpret_cast<float2*>(scratch + g * 16 + t * 8 + q2) =
                make_float2(acc[mi][j][t][0], acc[mi][j][t][1]);
            *reinterpret_cast<float2*>(scratch + (g + 8) * 16 + t * 8 + q2) =
                make_float2(acc[mi][j][t][2], acc[mi][j][t][3]);
          }
          __syncwarp();
          // one column per lane, so what post reads per column is loop-invariant
          const int rb = row_base + mi * 16, col = n0 + p * 16 + (lane & 15);
#pragma unroll 1
          for (int r = lane >> 4; r < 16; r += 2) post(rb + r, col, scratch[r * 16 + (lane & 15)]);
          __syncwarp();
        }
      }
    __syncthreads();
  }
}

// The layer of a 16-row tile, K1's forward and sweep: one m-tile, 16 warps
// across the columns, one column pair each, 256 columns a pass. K2 recomputes
// K1's p_k and r_k with this same routine, so its backward differentiates
// the forward whose u and Z the loss used, bit for bit, and runs its own
// row dots on it.
constexpr int kRow16Cols = 16 * 16;
constexpr int kRow16StageElems = TcStage<kRow16Cols, false>::kElems > TcStage<kRow16Cols, true>::kElems
                                     ? TcStage<kRow16Cols, false>::kElems
                                     : TcStage<kRow16Cols, true>::kElems;

template <bool SWEEP, typename Post>
__device__ __forceinline__ void row16_layer(const bf16* A, int lda, int K, const float* W, int ldw,
                                            int n, bf16* stage, Post post) {
  tc_layer<1, 1, 1, 16, SWEEP>(A, lda, K, W, ldw, n, stage, post);
}

// u[b] = sum_i A[b*lda + i] * bf16(w[i]) for the tile's rows (A bf16), one
// warp per row.
template <int TILE, typename Store>
__device__ __forceinline__ void tile_head(const bf16* A, int lda, int H,
                                          const float* __restrict__ w, Store store) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int b = warp; b < TILE; b += blockDim.x >> 5) {
    float s = 0.f;
    for (int i = lane; i < H; i += 32)
      s = fmaf(__bfloat162float(A[b * lda + i]), bf16_round(__ldg(w + i)), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) store(b, s);
  }
}

// Philox4x32-10 (Salmon et al., SC'11): counter-based, so a value depends only
// on (counter, key) and not on which block or thread draws it.
constexpr uint32_t kPhiloxM0 = 0xD2511F53u, kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u, kPhiloxW1 = 0xBB67AE85u;  // key increments

// hi:lo = m * a in one IMAD.WIDE (nvcc splits __umulhi and * into two
// instructions for some of the products)
__device__ __forceinline__ void philox_mulhilo(uint32_t m, uint32_t a, uint32_t& hi,
                                               uint32_t& lo) {
  uint64_t p;
  asm("mul.wide.u32 %0, %1, %2;" : "=l"(p) : "r"(a), "r"(m));
  hi = static_cast<uint32_t>(p >> 32);
  lo = static_cast<uint32_t>(p);
}

// One round with the round's keys (k0, k1).
__device__ __forceinline__ uint4 philox_round(uint4 c, uint32_t k0, uint32_t k1) {
  uint32_t hi0, lo0, hi1, lo1;
  philox_mulhilo(kPhiloxM0, c.x, hi0, lo0);
  philox_mulhilo(kPhiloxM1, c.z, hi1, lo1);
  return make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    c = philox_round(c, k0, k1);
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return c;
}

// u in (0, 1) from the top 23 bits, as the TPU kernel draws it: u >= 2^-24
// keeps log(u) finite.
__device__ __forceinline__ float uniform23(uint32_t bits) {
  return (static_cast<float>(bits >> 9) + 0.5f) * 1.1920928955078125e-07f;
}

// Single-branch Box-Muller: r * cos(2 pi u2).
__device__ __forceinline__ float box_muller(uint32_t b1, uint32_t b2) {
  const float r = sqrtf(-2.0f * logf(uniform23(b1)));
  return r * cosf(6.2831855f * uniform23(b2));
}
