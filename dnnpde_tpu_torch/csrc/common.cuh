// Shared pieces of the Hopper kernels: the MLP weight table passed by value,
// bf16 operand rounding, the batch-tile dot product and Philox4x32-10.
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

// For every output column o < n_out and every tile row b < TILE:
//   epi(b, o, sum_k A[b*lda + k] * bf16(W[k*sk + o*so]))
// A lives in shared memory, is already rounded to bf16, has lda % 4 == 0 and a
// 16-byte aligned base. One thread owns one output column at a time and keeps
// the TILE sums in registers, so each weight read from L2 feeds TILE FMAs and
// each A read is a broadcast.
template <int TILE, typename Epilogue>
__device__ __forceinline__ void tile_dot(const float* A, int lda, int K,
                                         const float* __restrict__ W, int sk, int so,
                                         int n_out, Epilogue epi) {
  const int K4 = K & ~3;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
    const float* wcol = W + (size_t)o * so;
    float acc[TILE];
#pragma unroll
    for (int b = 0; b < TILE; ++b) acc[b] = 0.f;
    for (int k = 0; k < K4; k += 4) {
      const float w0 = bf16_round(__ldg(wcol + (size_t)(k + 0) * sk));
      const float w1 = bf16_round(__ldg(wcol + (size_t)(k + 1) * sk));
      const float w2 = bf16_round(__ldg(wcol + (size_t)(k + 2) * sk));
      const float w3 = bf16_round(__ldg(wcol + (size_t)(k + 3) * sk));
#pragma unroll
      for (int b = 0; b < TILE; ++b) {
        const float4 a = *reinterpret_cast<const float4*>(A + b * lda + k);
        acc[b] = fmaf(a.x, w0, acc[b]);
        acc[b] = fmaf(a.y, w1, acc[b]);
        acc[b] = fmaf(a.z, w2, acc[b]);
        acc[b] = fmaf(a.w, w3, acc[b]);
      }
    }
    for (int k = K4; k < K; ++k) {
      const float w0 = bf16_round(__ldg(wcol + (size_t)k * sk));
#pragma unroll
      for (int b = 0; b < TILE; ++b) acc[b] = fmaf(A[b * lda + k], w0, acc[b]);
    }
#pragma unroll
    for (int b = 0; b < TILE; ++b) epi(b, o, acc[b]);
  }
}

// u[b] = sum_i A[b*lda + i] * bf16(w[i]) for the tile's rows, one warp per row.
template <int TILE, typename Store>
__device__ __forceinline__ void tile_head(const float* A, int lda, int H,
                                          const float* __restrict__ w, Store store) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int b = warp; b < TILE; b += blockDim.x >> 5) {
    float s = 0.f;
    for (int i = lane; i < H; i += 32) s = fmaf(A[b * lda + i], bf16_round(__ldg(w + i)), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) store(b, s);
  }
}

// Philox4x32-10 (Salmon et al., SC'11): counter-based, so a value depends only
// on (counter, key) and not on which block or thread draws it.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
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
