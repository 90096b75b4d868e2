// K2: hand-derived first-order backward of the fused sine-MLP (u, Z_full).
//
// Replaces dnnpde_tpu/ops/mlp_kernel.py::mlp_u_z_bwd_pallas (kernel body
// _bwd_kernel). For cotangents (u_bar, z_bar) of K1's outputs at x it returns
// (W_bars, b_bars, x_bar). Math (dnnpde_tpu/ops/fused_net_u.py:14-23), with
// bf() the bf16 rounding of a dot operand and f32 accumulation:
//   recompute  p_k = bf(a_k) bf(W_k) + b_k, a_{k+1} = sin p_k          k < L-1
//              r_{L-1} = W_{L-1}[:, 0];  r_k = bf(r_{k+1} cos p_k) bf(W_k)^T
//   Z-path     c = z_bar;  for k = 0 .. L-2 (ascending):
//                q = r_{k+1} cos p_k;      W_bar_k += bf(c)^T bf(q)
//                qb = bf(c) bf(W_k);       pz_k = -qb r_{k+1} sin p_k
//                c = qb cos p_k
//              W_bar_{L-1}[:, 0] += sum_rows c
//   u-path     a_bar = bf(u_bar) bf(W_{L-1})^T;  W_bar_{L-1} += bf(a_{L-1})^T bf(u_bar)
//              b_bar_{L-1} = sum_rows u_bar;  for k = L-2 .. 0 (descending):
//                p_bar = a_bar cos p_k + pz_k; W_bar_k += bf(a_k)^T bf(p_bar)
//                b_bar_k = sum_rows p_bar;     a_bar = bf(p_bar) bf(W_k)^T
//              x_bar = a_bar
//
// Bound on an H100 SXM: per row the backward does 5 * 222,464 + 196,608 + 512
// ~ 1.31 M multiply-adds at [101, 256 x 4, 1] (forward, sweep, Z-path dot and
// outer product, u-path outer product and dot). At B = 100 that is 0.26
// GFLOP against ~1.9 MB (weights read, gradients written, x, u_bar, z_bar,
// x_bar): bound by bytes, 0.57 us. At B = 2048 it is 5.4 GFLOP: bound by
// operations, 5.4 us at the bf16 tensor-core peak.
//
// Design: two launches, every dot on tensor cores (mma.sync bf16 through
// common.cuh, each 16-product partial added with __fadd_rn), no float
// atomics, so two launches agree bit for bit.
//
// 1. The row chain, mlp_u_z_bwd_rows: one block of 16 warps per 16-row tile,
//    a chain of 15 dependent layer passes at full depth, each K1's own
//    row16_layer. The recompute is K1's forward and sweep, so p_k and r_k are
//    K1's bit for bit and the backward differentiates the forward whose u
//    and Z the loss used. The Z-path's qb = bf(c) bf(W_k) runs in the forward
//    direction, the u-path's a_bar = bf(p_bar) bf(W_k)^T and x_bar in the
//    sweep direction; the pointwise parts (pz_k, c, p_bar) are their
//    epilogues. The tile keeps p_k, r_{k+1} (then pz_k) and one f32 working
//    row block in shared memory (144 KB at full width) beside K1's bf16
//    staging and activations (57 KB). What a weight gradient needs leaves
//    the block: each layer's bf16 operands go to a scratch buffer in device
//    memory, bf(a_k) and bf(c_k) (the A side) and bf(q_k) and bf(p_bar_k) (the B
//    side; the q_k are the sweep's own A operands), 7.6 KB a row at full
//    width; and the tile's column sums in f32 of what is summed unrounded:
//    p_bar_k (b_bar_k), c of the top layer with bf(a_{L-1}) bf(u_bar)
//    (W_bar_{L-1}) and u_bar (b_bar_{L-1}).
// 2. The weight gradients, mlp_u_z_bwd_wgrad: W_bar_k = A_k^T B_k, one product
//    over the 2 x 16 x tiles scratch rows (the Z-path's rows, then the
//    u-path's). One block of 4 warps per 32 x 64 tile of one W_bar_k, so the
//    weight-shaped work spreads over 112 blocks at full width whatever B is
//    (the old design did it on ceil(B/16) SMs: 7 at B = 100). Each block
//    walks the rows in order in chunks of 64, brought into shared memory by
//    cp.async three stages deep, and reads them with ldmatrix.trans. The
//    last blocks of the launch sum the column sums over the tiles in tile
//    order.
//
// Ragged shapes: the tile's missing rows load zero x, u_bar and z_bar, so
// their c, p_bar and pz are exact zeros and they add exact zeros to every
// gradient; their x_bar is not stored. Every operand row in the scratch is
// written (16 x round16(width) bf16, zero beyond the width); the weight
// gradient's chunks beyond the last row or the padded width are zero-filled
// by cp.async.
#include "common.cuh"

namespace {

constexpr int kTile = 16;

// Shapes and offsets shared by the two launches.
struct BwdLayout {
  // Row chain's shared memory, in floats: P and R slot k (k < L-1) has width
  // round4(n_{k+1}) and starts at kTile * slot[k].
  int slot[DNNPDE_MAX_LAYERS];
  int hidden;  // sum of the slot widths
  int ldm;     // widest slot: row stride of the f32 working rows
  int lda;     // row stride of the bf16 operands, as K1's
  // The flat gradient: every W_k (row-major, JAX layout), then every b_k.
  int woff[DNNPDE_MAX_LAYERS];
  int boff[DNNPDE_MAX_LAYERS];
  int ntail;  // values from woff[L-1] on: W_bar_{L-1}, then every b_bar
  // Scratch, in bf16 elements: layer k's A operand at aop[k] (rows x
  // round16(n_k)) and B operand at bop[k] (rows x round16(n_{k+1})); rows
  // [0, half) are the Z-path's, [half, 2 half) the u-path's. Then, at byte
  // offset part, the tiles' column sums: tiles x ntail f32.
  long long aop[DNNPDE_MAX_LAYERS];
  long long bop[DNNPDE_MAX_LAYERS];
  int tiles;
  int half;
  long long part;
  long long bytes;
};

BwdLayout make_layout(const int* width, int L, int B) {
  BwdLayout lay;
  lay.tiles = (B + kTile - 1) / kTile;
  lay.half = kTile * lay.tiles;
  int off = 0, widest = 0;
  for (int k = 0; k < L; ++k) {
    lay.woff[k] = off;
    off += width[k] * width[k + 1];
    widest = widest > width[k] ? widest : width[k];
  }
  for (int k = 0; k < L; ++k) {
    lay.boff[k] = off;
    off += width[k + 1];
  }
  lay.ntail = off - lay.woff[L - 1];
  lay.hidden = 0;
  lay.ldm = 0;
  long long ops = 0;
  for (int k = 0; k < L - 1; ++k) {
    const int n4 = dnnpde_round4(width[k + 1]);
    lay.slot[k] = lay.hidden;
    lay.hidden += n4;
    lay.ldm = lay.ldm > n4 ? lay.ldm : n4;
    lay.aop[k] = ops;
    ops += 2LL * lay.half * dnnpde_round16(width[k]);
    lay.bop[k] = ops;
    ops += 2LL * lay.half * dnnpde_round16(width[k + 1]);
  }
  lay.lda = dnnpde_round16(widest) + 8;
  lay.part = (ops * (long long)sizeof(bf16) + 15) & ~15LL;
  lay.bytes = lay.part + (long long)sizeof(float) * lay.tiles * lay.ntail;
  return lay;
}

// The tile's 16 bf16 rows, round16(n) wide (row stride lda in shared memory),
// to 16 consecutive rows of a scratch operand of row stride round16(n).
__device__ __forceinline__ void store_rows(const bf16* src, int lda, int n, bf16* dst) {
  const int n8 = dnnpde_round16(n) / 8;
  for (int i = threadIdx.x; i < kTile * n8; i += blockDim.x) {
    const int b = i / n8, c = (i - b * n8) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)b * n8 * 8 + c) =
        *reinterpret_cast<const uint4*>(src + b * lda + c);
  }
}

__global__ void __launch_bounds__(kTcThreads)
mlp_u_z_bwd_rows(const float* __restrict__ x, const float* __restrict__ ubar,
                 const float* __restrict__ zbar, float* __restrict__ xbar,
                 bf16* __restrict__ ops, float* __restrict__ partials, const MlpWeights w,
                 const BwdLayout lay, int B) {
  extern __shared__ __align__(16) float smem[];
  const int L = w.L;
  const int n0 = w.width[0];
  const int H = w.width[L - 1], ldh = dnnpde_round4(H);
  float* P = smem;                        // p_k
  float* R = P + kTile * lay.hidden;      // r_{k+1}, then pz_k
  float* F = R + kTile * lay.hidden;      // f32 rows: the top layer's c, then p_bar
  float* ub = F + kTile * lay.ldm;        // u_bar of the tile's rows
  bf16* stage = reinterpret_cast<bf16*>(ub + kTile);  // row16_layer's weight staging
  bf16* act0 = stage + kRow16StageElems;  // bf16 A operands and outputs, row stride lda
  bf16* act1 = act0 + kTile * lay.lda;
  const int row0 = blockIdx.x * kTile;
  float* part = partials + (size_t)blockIdx.x * lay.ntail;  // this tile's column sums
  const float* wtop = w.W[L - 1];         // W_{L-1}[:, 0] = r_{L-1}
  // this tile's first row of a scratch operand, in the Z-path's or the u-path's half
  auto zrows = [&](long long off, int n) { return ops + off + (size_t)row0 * dnnpde_round16(n); };
  auto urows = [&](long long off, int n) {
    return ops + off + (size_t)(lay.half + row0) * dnnpde_round16(n);
  };

  const int n0p = dnnpde_round16(n0);
  for (int i = threadIdx.x; i < kTile * n0p; i += blockDim.x) {
    const int b = i / n0p, c = i - b * n0p, r = row0 + b;
    act0[b * lay.lda + c] = __float2bfloat16_rn(r < B && c < n0 ? x[(size_t)r * n0 + c] : 0.f);
  }
  for (int b = threadIdx.x; b < kTile; b += blockDim.x) ub[b] = row0 + b < B ? ubar[row0 + b] : 0.f;
  __syncthreads();

  // ---- recompute the forward pass as K1 runs it: p_k into slot k; bf(a_k)
  // is the u-path's A operand of W_bar_k
  bf16* a = act0;
  bf16* nxt = act1;
  for (int k = 0; k < L - 1; ++k) {
    const int K = w.width[k], n = w.width[k + 1], ldn = dnnpde_round4(n);
    store_rows(a, lay.lda, K, urows(lay.aop[k], K));
    float* Pk = P + kTile * lay.slot[k];
    const float* bias = w.b[k];
    row16_layer<false>(a, lay.lda, K, w.W[k], n, n, stage, [&](int b, int o, float acc) {
      float s = 0.f;
      if (o < n) {
        const float p = acc + __ldg(bias + o);
        Pk[b * ldn + o] = p;
        s = sinf(p);
      }
      nxt[b * lay.lda + o] = __float2bfloat16_rn(s);
    });
    bf16* t = a; a = nxt; nxt = t;
  }

  // ---- Z-sweep as K1 runs it: r_k for k = L-2 .. 1 into slot k-1. Its A
  // operands q_k = bf(r_{k+1} cos p_k), k = L-2 .. 0, are the Z-path's B
  // operands of W_bar_k.
  bf16* q = act0;
  bf16* qn = act1;
  {
    const float* Pt = P + kTile * lay.slot[L - 2];
    const int hp = dnnpde_round16(H);
    for (int i = threadIdx.x; i < kTile * hp; i += blockDim.x) {
      const int b = i / hp, j = i - b * hp;
      q[b * lay.lda + j] = __float2bfloat16_rn(j < H ? __ldg(wtop + j) * cosf(Pt[b * ldh + j]) : 0.f);
    }
  }
  __syncthreads();
  for (int k = L - 2; k >= 1; --k) {
    const int K = w.width[k + 1], n = w.width[k], ldn = dnnpde_round4(n);
    store_rows(q, lay.lda, K, zrows(lay.bop[k], K));
    float* Rk = R + kTile * lay.slot[k - 1];
    const float* Pp = P + kTile * lay.slot[k - 1];
    row16_layer<true>(q, lay.lda, K, w.W[k], K, n, stage, [&](int b, int o, float acc) {
      float v = 0.f;
      if (o < n) {
        Rk[b * ldn + o] = acc;
        v = acc * cosf(Pp[b * ldn + o]);
      }
      qn[b * lay.lda + o] = __float2bfloat16_rn(v);
    });
    bf16* t = q; q = qn; qn = t;
  }
  store_rows(q, lay.lda, w.width[1], zrows(lay.bop[0], w.width[1]));  // q_0

  // ---- Z-path adjoint, ascending; c starts as bf(z_bar) and is the A
  // operand of both qb = bf(c) bf(W_k) and W_bar_k
  bf16* c = qn;
  bf16* cn = q;
  for (int i = threadIdx.x; i < kTile * n0p; i += blockDim.x) {
    const int b = i / n0p, j = i - b * n0p, r = row0 + b;
    c[b * lay.lda + j] = __float2bfloat16_rn(r < B && j < n0 ? zbar[(size_t)r * n0 + j] : 0.f);
  }
  __syncthreads();
  for (int k = 0; k < L - 1; ++k) {
    const int K = w.width[k], n = w.width[k + 1], ldn = dnnpde_round4(n);
    const bool top = k == L - 2;
    store_rows(c, lay.lda, K, zrows(lay.aop[k], K));
    const float* Pk = P + kTile * lay.slot[k];
    float* Rk = R + kTile * lay.slot[k];
    row16_layer<false>(c, lay.lda, K, w.W[k], n, n, stage, [&](int b, int o, float qbar) {
      float v = 0.f;
      if (o < n) {
        const float p = Pk[b * ldn + o];
        const float r = top ? __ldg(wtop + o) : Rk[b * ldn + o];
        Rk[b * ldn + o] = -qbar * r * sinf(p);  // pz_k replaces r_{k+1}
        v = qbar * cosf(p);
        if (top) F[b * lay.ldm + o] = v;  // summed unrounded into W_bar_{L-1}
      }
      if (!top) cn[b * lay.lda + o] = __float2bfloat16_rn(v);
    });
    bf16* t = c; c = cn; cn = t;
  }

  // ---- u-path, descending. The head, one thread a column: p_bar_{L-2} =
  // (bf(u_bar) bf(W_{L-1}[j])) cos p + pz, and the tile's column sums for
  // W_bar_{L-1} (the top c, then bf(a_{L-1}) bf(u_bar)), b_bar_{L-2} and
  // b_bar_{L-1}
  bf16* pb = act0;
  bf16* ab = act1;
  {
    const float* Pt = P + kTile * lay.slot[L - 2];
    const float* Zt = R + kTile * lay.slot[L - 2];
    const int hp = dnnpde_round16(H);
    for (int j = threadIdx.x; j < hp; j += blockDim.x) {
      if (j >= H) {
        for (int b = 0; b < kTile; ++b) pb[b * lay.lda + j] = __float2bfloat16_rn(0.f);
        continue;
      }
      const float wj = bf16_round(__ldg(wtop + j));
      float zc = 0.f, sw = 0.f, sb = 0.f;
      for (int b = 0; b < kTile; ++b) {
        const float p = Pt[b * ldh + j], u = bf16_round(ub[b]);
        const float pbar = (u * wj) * cosf(p) + Zt[b * ldh + j];
        zc += F[b * lay.ldm + j];
        sw = fmaf(bf16_round(sinf(p)), u, sw);
        sb += pbar;
        F[b * lay.ldm + j] = pbar;
        pb[b * lay.lda + j] = __float2bfloat16_rn(pbar);
      }
      part[j] = zc + sw;
      part[lay.boff[L - 2] - lay.woff[L - 1] + j] = sb;
    }
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int b = 0; b < kTile; ++b) s += ub[b];
      part[lay.ntail - 1] = s;
    }
  }
  __syncthreads();
  for (int k = L - 2; k >= 0; --k) {
    const int K = w.width[k], n = w.width[k + 1], ldk = dnnpde_round4(K);
    if (k < L - 2) {  // b_bar_k: the tile's column sums of the unrounded p_bar_k
      for (int j = threadIdx.x; j < n; j += blockDim.x) {
        float s = 0.f;
        for (int b = 0; b < kTile; ++b) s += F[b * lay.ldm + j];
        part[lay.boff[k] - lay.woff[L - 1] + j] = s;
      }
    }
    store_rows(pb, lay.lda, n, urows(lay.bop[k], n));  // bf(p_bar_k), B of W_bar_k
    if (k > 0) {
      const float* Pp = P + kTile * lay.slot[k - 1];
      const float* Zp = R + kTile * lay.slot[k - 1];
      row16_layer<true>(pb, lay.lda, n, w.W[k], n, K, stage, [&](int b, int o, float abar) {
        float v = 0.f;
        if (o < K) {
          v = abar * cosf(Pp[b * ldk + o]) + Zp[b * ldk + o];
          F[b * lay.ldm + o] = v;
        }
        ab[b * lay.lda + o] = __float2bfloat16_rn(v);
      });
      bf16* t = pb; pb = ab; ab = t;
    } else {
      row16_layer<true>(pb, lay.lda, n, w.W[0], n, n0, stage, [&](int b, int o, float abar) {
        if (o < n0 && row0 + b < B) xbar[(size_t)(row0 + b) * n0 + o] = abar;
      });
    }
  }
}

// ---- the weight gradients -------------------------------------------------

constexpr int kGradM = 32;         // rows of a W_bar tile (the layer's inputs)
constexpr int kGradN = 64;         // its columns (the layer's outputs)
constexpr int kGradK = 64;         // scratch rows per staged chunk
constexpr int kGradStages = 3;
constexpr int kGradThreads = 128;  // warp w owns the tile's columns 16w .. 16w + 15
constexpr int kGradLdA = kGradM + 8, kGradLdB = kGradN + 8;  // rows 16 bytes apart modulo 128

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  // src-size 0 reads nothing and fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ inline int grad_tiles(int K, int n) {
  return ((K + kGradM - 1) / kGradM) * ((n + kGradN - 1) / kGradN);
}

// Blocks [0, sum_k grad_tiles) each own one tile of one W_bar_k (k < L-1);
// the rest sum the row chain's column sums over the tiles, one value a thread.
__global__ void __launch_bounds__(kGradThreads)
mlp_u_z_bwd_wgrad(const bf16* __restrict__ ops, const float* __restrict__ partials,
                  float* __restrict__ grads, const MlpWeights w, const BwdLayout lay) {
  __shared__ __align__(16) bf16 sA[kGradStages][kGradK * kGradLdA];
  __shared__ __align__(16) bf16 sB[kGradStages][kGradK * kGradLdB];
  const int L = w.L;
  int blk = blockIdx.x, k = 0;
  for (; k < L - 1; ++k) {
    const int t = grad_tiles(w.width[k], w.width[k + 1]);
    if (blk < t) break;
    blk -= t;
  }
  if (k == L - 1) {
    const int i = blk * kGradThreads + threadIdx.x;
    if (i < lay.ntail) {
      float s = 0.f;
      for (int t = 0; t < lay.tiles; ++t) s += partials[(size_t)t * lay.ntail + i];
      grads[lay.woff[L - 1] + i] = s;
    }
    return;
  }

  const int K = w.width[k], N = w.width[k + 1];
  const int lda = dnnpde_round16(K), ldb = dnnpde_round16(N);
  const int ntn = (N + kGradN - 1) / kGradN;
  const int m0 = (blk / ntn) * kGradM, n0 = (blk % ntn) * kGradN;
  const bf16* A = ops + lay.aop[k];
  const bf16* Bm = ops + lay.bop[k];
  const int rows = 2 * lay.half;
  const int nch = (rows + kGradK - 1) / kGradK;

  static_assert((kGradK * kGradM / 8) % kGradThreads == 0 &&
                (kGradK * kGradN / 8) % kGradThreads == 0, "whole 16-byte copies a thread");
  auto load = [&](int ch, int s) {
    const int r0 = ch * kGradK;
#pragma unroll
    for (int it = 0; it < kGradK * kGradM / 8 / kGradThreads; ++it) {
      const int i = threadIdx.x + it * kGradThreads;
      const int r = i / (kGradM / 8), col = (i % (kGradM / 8)) * 8;
      const bool ok = r0 + r < rows && m0 + col < lda;
      cp_async16(&sA[s][r * kGradLdA + col], ok ? A + (size_t)(r0 + r) * lda + m0 + col : A, ok);
    }
#pragma unroll
    for (int it = 0; it < kGradK * kGradN / 8 / kGradThreads; ++it) {
      const int i = threadIdx.x + it * kGradThreads;
      const int r = i / (kGradN / 8), col = (i % (kGradN / 8)) * 8;
      const bool ok = r0 + r < rows && n0 + col < ldb;
      cp_async16(&sB[s][r * kGradLdB + col], ok ? Bm + (size_t)(r0 + r) * ldb + n0 + col : Bm, ok);
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // ldmatrix.trans row addresses: the staged A is (rows, W_bar rows), the
  // transpose of the mma's A; the staged B is (rows, W_bar columns), read as
  // tc_layer's forward reads its weights
  const int a_lane = ((lane & 7) + ((lane >> 4) << 3)) * kGradLdA + ((lane >> 3) & 1) * 8;
  const int b_lane = (lane & 15) * kGradLdB + (lane >> 4) * 8 + warp * 16;
  float acc[2][2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][t][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kGradStages - 1; ++s) {
    if (s < nch) load(s, s);
    cp_async_commit();
  }
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<kGradStages - 2>();
    __syncthreads();  // chunk ch has landed, and every warp is done with chunk ch - 1
    if (ch + kGradStages - 1 < nch) load(ch + kGradStages - 1, (ch + kGradStages - 1) % kGradStages);
    cp_async_commit();
    const bf16* As = sA[ch % kGradStages];
    const bf16* Bs = sB[ch % kGradStages];
#pragma unroll
    for (int ks = 0; ks < kGradK / 16; ++ks) {
      uint32_t a[2][4], b[4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) ldsm_x4_trans(a[mi], As + a_lane + ks * 16 * kGradLdA + mi * 16);
      ldsm_x4_trans(b, Bs + b_lane + ks * 16 * kGradLdB);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_bf16_16816(acc[mi][0], a[mi], b[0], b[1]);
        mma_bf16_16816(acc[mi][1], a[mi], b[2], b[3]);
      }
    }
  }

  // accumulator layout of m16n8: (row g, cols 2q, 2q+1), (row g + 8, same)
  float* out = grads + lay.woff[k];
  const int g = lane >> 2, q2 = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + mi * 16 + g + 8 * h, n = n0 + warp * 16 + t * 8 + q2;
        if (m < K) {
          if (n < N) out[(size_t)m * N + n] = acc[mi][t][2 * h];
          if (n + 1 < N) out[(size_t)m * N + n + 1] = acc[mi][t][2 * h + 1];
        }
      }
}

}  // namespace

// Bytes of scratch mlp_u_z_bwd needs for B rows (widths [n0, ..., 1], L
// layers), or -1 for shapes it does not take.
extern "C" long long mlp_u_z_bwd_scratch_bytes(const int* widths, int L, int B) {
  if (L < 2 || L > DNNPDE_MAX_LAYERS || B <= 0) return -1;
  return make_layout(widths, L, B).bytes;
}

// Launches K2 on `stream`. x, z_bar, x_bar (B, n0); u_bar (B, 1); grads: the
// flat gradient buffer (every W_k row-major, then every b_k); scratch:
// mlp_u_z_bwd_scratch_bytes(widths, L, B) bytes, 16-byte aligned. All f32,
// contiguous, on the current device. Returns cudaGetLastError() after the
// two launches.
extern "C" int mlp_u_z_bwd(const float* x, const float* u_bar, const float* z_bar,
                           float* x_bar, float* grads, void* scratch, const void* const* Ws,
                           const void* const* bs, const int* widths, int L, int B,
                           void* stream) {
  MlpWeights w;
  cudaError_t err = dnnpde_fill_weights(&w, Ws, bs, widths, L);
  if (err != cudaSuccess) return err;
  if (B <= 0 || (reinterpret_cast<uintptr_t>(scratch) & 15) != 0) return cudaErrorInvalidValue;
  const BwdLayout lay = make_layout(w.width, L, B);
  const size_t smem = sizeof(float) * ((size_t)kTile * (2 * (size_t)lay.hidden + lay.ldm) + kTile) +
                      sizeof(bf16) * ((size_t)kRow16StageElems + 2 * (size_t)kTile * lay.lda);
  if (smem > DNNPDE_MAX_SMEM) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(mlp_u_z_bwd_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* ops = static_cast<bf16*>(scratch);
  float* partials = reinterpret_cast<float*>(static_cast<char*>(scratch) + lay.part);
  mlp_u_z_bwd_rows<<<lay.tiles, kTcThreads, smem, s>>>(x, u_bar, z_bar, x_bar, ops, partials, w,
                                                       lay, B);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int blocks = (lay.ntail + kGradThreads - 1) / kGradThreads;
  for (int k = 0; k < L - 1; ++k) blocks += grad_tiles(w.width[k], w.width[k + 1]);
  mlp_u_z_bwd_wgrad<<<blocks, kGradThreads, 0, s>>>(ops, partials, grads, w, lay);
  return cudaGetLastError();
}
