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
//    That design leaves most of the card idle at small B (7 blocks on 132
//    SMs at B = 100) and has every block stream every layer's f32 weights
//    from L2 in 32-row chunks, one chunk in flight: ~110 serial round trips
//    a launch, ~113 us on an H100 against a bound of 0.57 us.
// 1'. The row chain on a thread-block cluster, cluster::mlp_u_z_bwd_rows: one
//    cluster of 8 CTAs of 16 warps per 16-row tile, each CTA owning an eighth
//    of every layer's output columns. In its prologue a CTA copies its
//    column slice of each W_k from L2 (cp.async, f32, through two staging
//    buffers in the space the operands and state take afterwards) and keeps
//    it in shared memory rounded to bf16, as ldmatrix reads it; its row
//    slice of each W_k, which the sweep direction's passes read (sweep,
//    u-path, x_bar), lies in its peers' column slices and comes from them by
//    bulk copies of the Tensor Memory Accelerator, so a cluster reads the
//    weights from L2 once: 222 KB of f32 a tile at full width. A pass then
//    touches no weight in L2: the CTA's tensor-core warps multiply the whole
//    16-row A operand by its slice (k-steps ascending, each partial added
//    with __fadd_rn, as tc_layer does, so every output is design 1's bit for
//    bit), all 16 warps run the epilogue on its own columns, one element a
//    thread, and write its bf16 block of the next A operand; one bulk copy a
//    peer sends the block to the peers, counted on their mbarriers, for
//    which each CTA waits before the next pass. The f32 state (p_k, r_{k+1},
//    then pz_k, the working rows) is split by columns the same way, so every
//    epilogue reads only its own CTA's state. The scratch operands and
//    column sums are design 1's, byte for byte. On an H100 the launch takes
//    ~40 us at B = 1 to 100 and ~81 us at B = 256 to 448 (two waves of
//    clusters), against ~116 us for design 1; the wrapper takes it where its
//    shared memory fits and B <= 448 (ops/mlp_kernel.py::bwd_takes_cluster),
//    and design 1 elsewhere. The NAIS-Net's form is below.
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
//
// The NAIS-Net (K1's note, csrc/mlp_u_z_fwd.cu): each block k of 1 .. L-2
// is a layer on [x, a_k] with weight W_k = [U_k; 0; -A_k] and a residual,
// so its adjoints gain identity paths and x columns:
//   recompute  a_{k+1} = sin p_k + a_k;  r_k = r_{k+1} + bf(q_k) bf(-A_k)^T
//   Z-path     the block's A operand is [bf(z_bar), bf(c_k)] (Z's x part is
//              a sum over the blocks); c_{k+1} = c_k + qb cos p_k
//   u-path     W_bar_k += bf([x, a_k])^T bf(p_bar_k);  a_bar_k = a_bar_{k+1}
//              + bf(p_bar_k) bf(-A_k)^T;  x_bar sums bf(p_bar_k) bf(U_k)^T
//              over the blocks, then adds layer 0's product
// with every stream (a_k, r_k, c_k, a_bar_k and the two x sums) in f32.
// Design 1 runs it (mlp_u_z_bwd_rows_nais, the same body instantiated for
// the block kind): the forward's a_k in the working rows, r_k and then
// a_bar_k in the R slots that design 1 frees as it goes, the c stream in
// the working rows. The weight-gradient kernel takes the blocks' (round16(n0)
// + H)-row operands as it takes any width.
// Design 1' runs it too (cluster::mlp_u_z_bwd_rows_nais, the clustered body
// instantiated for the block kind), on clusters of 16 CTAs, a non-portable
// size: with 8, a CTA's slices of the blocks' [U_k; 0; -A_k] (368 rows at
// full width) and its staging take 314 KB, beyond 227 KB; with 16 its
// column slice of a block is its 16 columns of all 368 rows (U_k's padded
// to 128), its row slices -A_k's 16 rows of its a columns and U_k's 8 rows
// of its x columns, 122,880 bytes of slices in all, and the CTA 195,488
// bytes. bf(x) and bf(z_bar) stay whole in every CTA: a block's forward
// and Z-path passes read their first round16(n0) columns of A from them and
// the rest from the exchanged blocks, k-steps ascending as design 1 has
// them, so each output is design 1's bit for bit. The NAIS streams split by
// columns as p_k and r_k do: the forward's a_k and then the head's bf(a_{L-1})
// in the working rows, r_k then pz_k then a_bar_k in the R slots, the c
// stream in the working rows; the u-path's U_k rows (the block's share of
// x_bar, summed over the blocks per column in f32) run beside its -A_k rows
// on warps those leave idle, in the same pass. An H100 holds 7 such
// clusters at once (one CTA an SM), so B <= 112 runs in one wave: on an
// H100 the launch with the weight gradient takes ~47 us at B = 1 to 112,
// ~88 us at B = 113 to 224 and ~131 us at B = 225 to 336, against ~156-161
// us for design 1; the wrapper takes it where its shared memory fits and B
// <= 336 (ops/mlp_kernel.py::bwd_takes_cluster), and design 1 elsewhere.
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
  int kin[DNNPDE_MAX_LAYERS];  // rows of W_k: width[k], or round16(n0) + width[k] for a
                               // NAIS-Net block ([x, a_k] in)
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

BwdLayout make_layout(const int* width, int L, int B, bool nais) {
  BwdLayout lay;
  lay.tiles = (B + kTile - 1) / kTile;
  lay.half = kTile * lay.tiles;
  int off = 0, widest = 0;
  for (int k = 0; k < L; ++k) {
    lay.kin[k] = nais && k > 0 && k < L - 1 ? dnnpde_round16(width[0]) + width[k] : width[k];
    lay.woff[k] = off;
    off += lay.kin[k] * width[k + 1];
    widest = widest > lay.kin[k] ? widest : lay.kin[k];
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
    ops += 2LL * lay.half * dnnpde_round16(lay.kin[k]);
    lay.bop[k] = ops;
    ops += 2LL * lay.half * dnnpde_round16(width[k + 1]);
  }
  if (nais) widest = dnnpde_round16(width[0]) + dnnpde_round16(width[1]);
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

// One 16-row tile of design 1 for either net (NAIS = false: the sine MLP;
// NAIS = true: the NAIS-Net, see the note above); shared memory as launch()
// sizes it.
template <bool NAIS>
__device__ __forceinline__ void bwd_rows_tile(const float* __restrict__ x,
                                              const float* __restrict__ ubar,
                                              const float* __restrict__ zbar,
                                              float* __restrict__ xbar, bf16* __restrict__ ops,
                                              float* __restrict__ partials, const MlpWeights& w,
                                              const BwdLayout& lay, int B) {
  extern __shared__ __align__(16) float smem[];
  const int L = w.L;
  const int n0 = w.width[0];
  const int H = w.width[L - 1], ldh = dnnpde_round4(H);
  const int n0p = dnnpde_round16(n0);
  const int xo = NAIS ? n0p : 0;          // NAIS: a layer's A operand is [x or z_bar, then this]
  float* P = smem;                        // p_k
  float* R = P + kTile * lay.hidden;      // r_{k+1}, then pz_k; NAIS: then a_bar_{k+1}
  float* F = R + kTile * lay.hidden;      // f32 rows: the top layer's c, then p_bar; NAIS: a_k
                                          // in the forward pass, the c stream in the Z-path
  float* ub = F + kTile * lay.ldm;        // u_bar of the tile's rows
  float* sws = ub + kTile;                // NAIS: the head's column sums of bf(a_{L-1}) bf(u_bar)
  const int ld0 = dnnpde_round4(n0);
  float* xacc = sws + (NAIS ? ldh : 0);   // NAIS: the blocks' x_bar products, summed
  bf16* stage = reinterpret_cast<bf16*>(xacc + (NAIS ? kTile * ld0 : 0));  // row16_layer's staging
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

  for (int i = threadIdx.x; i < kTile * n0p; i += blockDim.x) {
    const int b = i / n0p, c = i - b * n0p, r = row0 + b;
    const bf16 v = __float2bfloat16_rn(r < B && c < n0 ? x[(size_t)r * n0 + c] : 0.f);
    act0[b * lay.lda + c] = v;
    if (NAIS) act1[b * lay.lda + c] = v;
  }
  for (int b = threadIdx.x; b < kTile; b += blockDim.x) ub[b] = row0 + b < B ? ubar[row0 + b] : 0.f;
  __syncthreads();

  // ---- recompute the forward pass as K1 runs it: p_k into slot k; bf(a_k)
  // is the u-path's A operand of W_bar_k
  bf16* a = act0;
  bf16* nxt = act1;
  for (int k = 0; k < L - 1; ++k) {
    const int K = lay.kin[k], n = w.width[k + 1], ldn = dnnpde_round4(n);
    store_rows(a, lay.lda, K, urows(lay.aop[k], K));
    float* Pk = P + kTile * lay.slot[k];
    const float* bias = w.b[k];
    row16_layer<false>(a, lay.lda, K, w.W[k], n, n, stage, [&](int b, int o, float acc) {
      float s = 0.f;
      if (o < n) {
        const float p = acc + __ldg(bias + o);
        Pk[b * ldn + o] = p;
        s = sinf(p);
        if (NAIS) {
          if (k > 0) s += F[b * lay.ldm + o];
          F[b * lay.ldm + o] = s;
        }
      }
      nxt[b * lay.lda + xo + o] = __float2bfloat16_rn(s);
    });
    bf16* t = a; a = nxt; nxt = t;
  }
  if (NAIS) {  // W_bar_{L-1}'s share of the u-path, from the f32 a_{L-1}
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float sw = 0.f;
      for (int b = 0; b < kTile; ++b)
        sw = fmaf(bf16_round(F[b * lay.ldm + j]), bf16_round(ub[b]), sw);
      sws[j] = sw;
    }
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
    if (NAIS) {  // the a rows of W_k only: r_k = r_{k+1} + q (-A_k)^T; Z's x part is not needed
      const float* Rn = R + kTile * lay.slot[k];  // r_{k+1}
      row16_layer<true>(q, lay.lda, K, w.W[k] + (size_t)n0p * K, K, n, stage,
                        [&](int b, int o, float acc) {
        float v = 0.f;
        if (o < n) {
          const float r = (k == L - 2 ? __ldg(wtop + o) : Rn[b * ldn + o]) + acc;
          Rk[b * ldn + o] = r;
          v = r * cosf(Pp[b * ldn + o]);
        }
        qn[b * lay.lda + o] = __float2bfloat16_rn(v);
      });
    } else {
      row16_layer<true>(q, lay.lda, K, w.W[k], K, n, stage, [&](int b, int o, float acc) {
        float v = 0.f;
        if (o < n) {
          Rk[b * ldn + o] = acc;
          v = acc * cosf(Pp[b * ldn + o]);
        }
        qn[b * lay.lda + o] = __float2bfloat16_rn(v);
      });
    }
    bf16* t = q; q = qn; qn = t;
  }
  store_rows(q, lay.lda, w.width[1], zrows(lay.bop[0], w.width[1]));  // q_0

  // ---- Z-path adjoint, ascending; c starts as bf(z_bar) and is the A
  // operand of both qb = bf(c) bf(W_k) and W_bar_k (NAIS: [bf(z_bar),
  // bf(c_k)] for a block, with c_{k+1} = c_k + qb cos p_k in f32)
  bf16* c = qn;
  bf16* cn = q;
  if (NAIS) __syncthreads();  // cn is q: q_0's store above reads it
  for (int i = threadIdx.x; i < kTile * n0p; i += blockDim.x) {
    const int b = i / n0p, j = i - b * n0p, r = row0 + b;
    const bf16 v = __float2bfloat16_rn(r < B && j < n0 ? zbar[(size_t)r * n0 + j] : 0.f);
    c[b * lay.lda + j] = v;
    if (NAIS) cn[b * lay.lda + j] = v;
  }
  __syncthreads();
  for (int k = 0; k < L - 1; ++k) {
    const int K = lay.kin[k], n = w.width[k + 1], ldn = dnnpde_round4(n);
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
        if (NAIS) {
          if (k > 0) v += F[b * lay.ldm + o];
          F[b * lay.ldm + o] = v;
        } else if (top) {
          F[b * lay.ldm + o] = v;  // summed unrounded into W_bar_{L-1}
        }
      }
      if (!top) cn[b * lay.lda + xo + o] = __float2bfloat16_rn(v);
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
        if (!NAIS) sw = fmaf(bf16_round(sinf(p)), u, sw);
        sb += pbar;
        F[b * lay.ldm + j] = pbar;
        pb[b * lay.lda + j] = __float2bfloat16_rn(pbar);
      }
      part[j] = zc + (NAIS ? sws[j] : sw);
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
      if (NAIS) {
        // the x rows: this block's share of x_bar
        row16_layer<true>(pb, lay.lda, n, w.W[k], n, n0, stage, [&](int b, int o, float xb) {
          if (o < n0) xacc[b * ld0 + o] = k == L - 2 ? xb : xacc[b * ld0 + o] + xb;
        });
        // the a rows: a_bar_k = a_bar_{k+1} + p_bar_k (-A_k)^T in f32, into
        // slot k (whose pz_k p_bar_k has taken up); p_bar_{k-1} from it
        float* Ak = R + kTile * lay.slot[k];
        const float* An = R + kTile * lay.slot[k + 1 < L - 1 ? k + 1 : k];  // a_bar_{k+1}
        row16_layer<true>(pb, lay.lda, n, w.W[k] + (size_t)n0p * n, n, K, stage,
                          [&](int b, int o, float abar) {
          float v = 0.f;
          if (o < K) {
            const float an = (k == L - 2 ? bf16_round(ub[b]) * bf16_round(__ldg(wtop + o))
                                         : An[b * ldk + o]) + abar;
            Ak[b * ldk + o] = an;
            v = an * cosf(Pp[b * ldk + o]) + Zp[b * ldk + o];
            F[b * lay.ldm + o] = v;
          }
          ab[b * lay.lda + o] = __float2bfloat16_rn(v);
        });
      } else {
        row16_layer<true>(pb, lay.lda, n, w.W[k], n, K, stage, [&](int b, int o, float abar) {
          float v = 0.f;
          if (o < K) {
            v = abar * cosf(Pp[b * ldk + o]) + Zp[b * ldk + o];
            F[b * lay.ldm + o] = v;
          }
          ab[b * lay.lda + o] = __float2bfloat16_rn(v);
        });
      }
      bf16* t = pb; pb = ab; ab = t;
    } else {
      row16_layer<true>(pb, lay.lda, n, w.W[0], n, n0, stage, [&](int b, int o, float abar) {
        if (o < n0 && row0 + b < B)
          xbar[(size_t)(row0 + b) * n0 + o] = NAIS ? abar + xacc[b * ld0 + o] : abar;
      });
    }
  }
}

__global__ void __launch_bounds__(kTcThreads)
mlp_u_z_bwd_rows(const float* __restrict__ x, const float* __restrict__ ubar,
                 const float* __restrict__ zbar, float* __restrict__ xbar,
                 bf16* __restrict__ ops, float* __restrict__ partials, const MlpWeights w,
                 const BwdLayout lay, int B) {
  bwd_rows_tile<false>(x, ubar, zbar, xbar, ops, partials, w, lay, B);
}

__global__ void __launch_bounds__(kTcThreads)
mlp_u_z_bwd_rows_nais(const float* __restrict__ x, const float* __restrict__ ubar,
                      const float* __restrict__ zbar, float* __restrict__ xbar,
                      bf16* __restrict__ ops, float* __restrict__ partials, const MlpWeights w,
                      const BwdLayout lay, int B) {
  bwd_rows_tile<true>(x, ubar, zbar, xbar, ops, partials, w, lay, B);
}

// ---- cp.async, for the clustered row chain and the weight gradients ---------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  // src-size 0 reads nothing and fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// 4 bytes, for rows that are not 16-byte aligned; src-size 0 writes a zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// ---- mbarriers, on which the Tensor Memory Accelerator's bulk copies complete

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

// the one arrival of the barrier's phase, which completes once `bytes` more
// have landed
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- the row chain on a thread-block cluster (design 1') -------------------

namespace cluster {

constexpr int kCtas = 8;  // CTAs of the MLP's cluster, the portable maximum
// CTAs of the NAIS-Net's: a non-portable size, so that a CTA's slices of the
// blocks' (round16(n0) + H)-row weights fit its shared memory; an H100 holds
// 7 such clusters at once (one CTA an SM), 7 tiles: B <= 112 in one wave
constexpr int kNaisCtas = 16;
// 16 warps: warp w runs the CTA's n8 tiles w, w + kWarps, ... on the tensor
// cores; all of them run the epilogues, one element a thread, and the
// prologue, whose scalar work 4 warps (one a scheduler) could not hide
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// A column space of width n is cut into round16(n) / 8 tiles of 8 columns;
// CTA r of ctas owns tiles [r tpc, (r + 1) tpc), of which those below
// round16(n) exist, with tpc = ceil(tiles / ctas) rounded up to a power of
// two, so that a column's CTA and its place in that CTA's slice are shifts.
// Both passes that meet in a column space (the forward layer k - 1 and the
// sweep or u-path layer k) cut it alike, so each epilogue finds the state it
// reads in its own CTA.
__host__ __device__ inline int tiles_per_cta(int n, int ctas) {
  const int t = (dnnpde_round16(n) / 8 + ctas - 1) / ctas;
  int p = 1;
  while (p < t) p *= 2;
  return p;
}

__host__ __device__ inline int log2_pow2(int v) {
  int s = 0;
  while ((1 << s) < v) ++s;
  return s;
}

// Shared memory of a CTA, host-computed. In order: the weight slices in
// bf16 as ldmatrix reads them, rows padded by 8 (16 bytes, so its eight row
// reads hit eight bank groups): W_k's column slice row-major, its row slice
// in ctas blocks, block p the columns that CTA p's column slice holds;
// three mbarriers (the exchange's two, the prologue's) and the inputs in
// f32 (the tile's x and z_bar, u_bar, the CTA's columns of each hidden bias
// and of W_{L-1}); then one region used twice, by the prologue's two f32
// staging buffers of column slices and after it by three bf16 operand
// buffers and the f32 state (P, R, two working row blocks, the head's
// bf(sin p), a pass's accumulators). An operand buffer holds ctas blocks,
// block r the 16 rows of CTA r's columns, row stride lwmax + 8.
//
// The NAIS-Net (16 CTAs): a block's column slice holds U_k's rows, padded to
// xrows = ctas 8 tpc[0], before -A_k's; its row slice is -A_k's, and U_k's
// rows of the CTA's x columns (a block of 8 tpc[0] rows from each peer) lie
// in a third slice. bf(x) and bf(z_bar) join the inputs, whole (16 rows of
// round16(n0) + 8): a block's A operand is [bf(x) or bf(z_bar), then the
// a-part in blocks]. The state adds the x rows' accumulators and x_bar's sum
// over the blocks, 16 x 8 tpc[0] f32 each.
struct Layout {
  int tpc[DNNPDE_MAX_LAYERS + 1];  // tiles a CTA owns of width[k]
  int fwd[DNNPDE_MAX_LAYERS];      // bf16 offset of W_k's column slice: ctas 8 tpc[k] rows (a
                                   // NAIS block: xrows more first)
  int swp[DNNPDE_MAX_LAYERS];      // bf16 offset of W_k's row slice: ctas blocks of 8 tpc[k] rows
  int swx[DNNPDE_MAX_LAYERS];      // NAIS: bf16 offset of U_k's rows: ctas blocks of 8 tpc[0] rows
  int slot[DNNPDE_MAX_LAYERS];     // float offset of P and R slot k: 16 x 8 tpc[k + 1]
  int bias[DNNPDE_MAX_LAYERS];     // float offset of b_k's columns in the inputs
  int wtop;                        // float offset of W_{L-1}'s columns in the inputs
  int xop;                         // NAIS: float offset of bf(x), then bf(z_bar), in the inputs
  int xrows;                       // NAIS: U_k's rows in a block's column slice
  int inputs;                      // floats of the mbarriers and inputs
  int stage;                       // floats of one staging buffer
  int hidden;                      // floats of all P slots
  int lwmax;                       // widest slice of a column space, in columns
  int blk;                         // bf16 of a block of an operand: 16 rows of lwmax + 8
  int frag;                        // bf16 of all the slices
  long long smem;
};

Layout make(const int* width, int L, bool nais) {
  Layout c;
  const int ctas = nais ? kNaisCtas : kCtas, n0p = dnnpde_round16(width[0]);
  for (int k = 0; k <= L; ++k) c.tpc[k] = tiles_per_cta(width[k], ctas);
  c.xrows = ctas * 8 * c.tpc[0];
  int frag = 0, inputs = 8 + 2 * kTile * n0p + kTile, stage = 0;
  c.hidden = 0;
  c.lwmax = 0;
  for (int k = 0; k < L - 1; ++k) {
    const int lwo = 8 * c.tpc[k + 1], lwi = 8 * c.tpc[k];
    const bool block = nais && k > 0;
    // both ctas lwi rows of lwo + 8 (ctas lwi >= round16(width[k])); a
    // block's column slice and U_k's rows xrows more each
    c.fwd[k] = frag;
    frag += ((block ? c.xrows : 0) + ctas * lwi) * (lwo + 8);
    c.swp[k] = frag;
    frag += ctas * lwi * (lwo + 8);
    c.swx[k] = frag;
    if (block) frag += c.xrows * (lwo + 8);
    c.slot[k] = c.hidden;
    c.hidden += kTile * lwo;
    c.bias[k] = inputs;
    inputs += lwo;
    // staged in f32: the column slice as W_k's rows of lwo
    const int rows = block ? n0p + width[k] : width[k];
    stage = stage > rows * lwo ? stage : rows * lwo;
  }
  c.wtop = inputs;
  inputs += 8 * c.tpc[L - 1];
  c.xop = inputs;
  if (nais) inputs += kTile * (n0p + 8);  // 2 x 16 rows of n0p + 8 bf16
  for (int k = 0; k < L; ++k) c.lwmax = c.lwmax > 8 * c.tpc[k] ? c.lwmax : 8 * c.tpc[k];
  c.blk = kTile * (c.lwmax + 8);
  c.frag = frag;
  c.inputs = inputs;
  c.stage = stage;
  const long long steady =
      2LL * 3 * ctas * c.blk +
      4LL * (2LL * c.hidden + 4LL * kTile * c.lwmax + (nais ? 2LL * kTile * 8 * c.tpc[0] : 0));
  const long long staging = 4LL * 2 * stage;
  c.smem = 2LL * frag + 4LL * inputs + (steady > staging ? steady : staging);
  return c;
}

__device__ __forceinline__ uint32_t cta_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_index() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster: what each wrote before is
// visible to all after, in shared memory (its own and its peers') as well.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t peer_addr(uint32_t local, uint32_t rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(addr) : "r"(local), "r"(rank));
  return addr;
}

// bytes (a multiple of 16) of our shared memory at src to CTA `rank`'s at
// the offset of dst (of src by default) in ours, counted there on the
// mbarrier at bar's offset
__device__ __forceinline__ void send(const void* src, uint32_t bytes, uint32_t rank, uint64_t* bar,
                                     const void* dst = nullptr) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(peer_addr(smem_u32(dst != nullptr ? dst : src), rank)),
      "r"(smem_u32(src)), "r"(bytes), "r"(peer_addr(smem_u32(bar), rank))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Starts copying rows [0, nrow) x columns [0, ncol) of src (row stride
// ldw; ncol a multiple of 4) to dst (row stride ncol, 16-byte aligned);
// columns at or beyond cvalid are filled with zeros. VEC: src's rows are
// 16-byte aligned and cvalid is a multiple of 4. base: any valid address.
template <bool VEC>
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int ldw, int nrow,
                                          int ncol, int cvalid, const float* base) {
  const int per = ncol / 4, dr = kThreads / per, dc = kThreads % per;
  for (int r = threadIdx.x / per, q = threadIdx.x % per; r < nrow;) {
    const int c = 4 * q;
    const float* s = src + (size_t)r * ldw + c;
    float* d = dst + r * ncol + c;
    if (VEC) {
      cp_async16(d, c < cvalid ? s : base, c < cvalid);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) cp_async4(d + e, c + e < cvalid ? s + e : base, c + e < cvalid);
    }
    r += dr;
    q += dc;
    if (q >= per) {
      q -= per;
      ++r;
    }
  }
}

// A staged slice (rows of ncol f32) into its bf16 rows (stride ncol + 8);
// rows at or beyond vrows are zero.
__device__ __forceinline__ void convert(bf16* dst, const float* stg, int rows, int vrows, int ncol) {
  const int per = ncol / 4, dr = kThreads / per, dc = kThreads % per;
  for (int r = threadIdx.x / per, q = threadIdx.x % per; r < rows;) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < vrows) v = *reinterpret_cast<const float4*>(stg + r * ncol + 4 * q);
    *reinterpret_cast<uint2*>(dst + r * (ncol + 8) + 4 * q) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    r += dr;
    q += dc;
    if (q >= per) {
      q -= per;
      ++r;
    }
  }
}

// One layer pass: the CTA's tiles of A times its slice W, k-steps ascending,
// each 16-product partial added with __fadd_rn, the operands' bf16 values
// at tc_layer's places in the mma fragments: every output is tc_layer's bit
// for bit. A: 16 x round16(K) bf16 in blocks (see Layout), 2^lsh columns a
// block. W: the forward direction's column slice (B[k][j] at W[k ldw + j],
// read with ldmatrix.trans) or the sweep direction's row slice (B[k][j] at
// W[(k >> lsh) 8 tpc ldw + j ldw + k % 2^lsh]: its blocks cut K as A's do). The tiles' accumulators wait in accs (16 x 8 tpc f32); then
// post(b, o, lc, acc) runs for every column o of the CTA below round16(n)
// (lc: o's column in the CTA's slice), one a thread, and returns the value
// whose bf16 goes to row b, column o of `out` (the CTA's block) and of 16
// rows of a scratch operand (row stride ldd), where given.
// XPART (a NAIS-Net layer in the forward direction): A's first xk columns
// are X's (16 rows of stride xk + 8), the rest A's blocks from column 0;
// W's rows for A's blocks start wsh rows further down.
// The accumulators of the CTA's tile lt of a pass (see pass), parked in
// accs (16 rows, stride ld).
template <bool SWEEP, bool XPART = false>
__device__ __forceinline__ void mma_tile(const bf16* A, int lsh, int S, const bf16* W, int ldw,
                                         int wblk, int lt, int blk, int lda, float* accs, int ld,
                                         const bf16* X = nullptr, int xk = 0, int wsh = 0) {
  const int lane = threadIdx.x & 31;
  const int arow = lane & 15, acol = (lane >> 4) * 8, amask = (1 << lsh) - 1;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  // lanes 8m .. 8m + 7 address matrix m: k-step s (m = 0, 1), then s + 1;
  // the row slice's column kc lies in its block kc >> lsh
  const bf16* wl = SWEEP ? W + (8 * lt + (lane & 7)) * ldw
                         : W + ((lane & 7) + 8 * (lane >> 3)) * ldw + 8 * lt;
  auto ldb = [&](uint32_t(&b)[4], int s, bool two) {  // B of k-steps s (and s + 1)
    const int kc = 16 * s + 8 * (lane >> 3);
    const bf16* wp = SWEEP ? wl + (kc >> lsh) * wblk + (kc & amask)
                           : wl + (16 * s + (XPART && kc >= xk ? wsh : 0)) * ldw;
    if (SWEEP) {
      if (two) ldsm_x4(b, wp);
      else ldsm_x2(b, wp);
    } else {
      if (two) ldsm_x4_trans(b, wp);
      else ldsm_x2_trans(b, wp);
    }
  };
  auto lda_ = [&](uint32_t(&a)[4], int s) {  // A of k-step s: this lane's 8 columns
    const int c = 16 * s + acol, ca = XPART ? c - xk : c;
    ldsm_x4(a, XPART && c < xk ? X + arow * (xk + 8) + c
                               : A + (ca >> lsh) * blk + arow * lda + (ca & amask));
  };
  // four k-steps at a time, their loads ahead of their products, which add
  // into acc in k order
  int s = 0;
  for (; s + 4 <= S; s += 4) {
    uint32_t a[4][4], b[2][4];
    ldb(b[0], s, true);
    ldb(b[1], s + 2, true);
#pragma unroll
    for (int h = 0; h < 4; ++h) lda_(a[h], s + h);
#pragma unroll
    for (int h = 0; h < 4; ++h) mma_bf16_16816(acc, a[h], b[h >> 1][2 * (h & 1)], b[h >> 1][2 * (h & 1) + 1]);
  }
  for (; s < S; ++s) {
    uint32_t a[4], b[4];
    ldb(b, s, false);
    lda_(a, s);
    mma_bf16_16816(acc, a, b[0], b[1]);
  }
  // accumulator layout of m16n8: (row g, cols 2q, 2q+1), (row g + 8, same)
  const int g = lane >> 2, q2 = (lane & 3) * 2;
  *reinterpret_cast<float2*>(accs + g * ld + lt * 8 + q2) = make_float2(acc[0], acc[1]);
  *reinterpret_cast<float2*>(accs + (g + 8) * ld + lt * 8 + q2) = make_float2(acc[2], acc[3]);
}

// The CTA's tiles of a width-n column space cut tpc tiles a CTA.
__device__ __forceinline__ int cta_tiles(int n, int tpc, int rank) {
  return max(0, min(tpc, (dnnpde_round16(n) >> 3) - rank * tpc));
}

// A pass's epilogue (see mma_tile), once its tiles' accumulators are in accs.
template <typename Post>
__device__ __forceinline__ void epilogue(int n, int tpc, int rank, int lda, const float* accs,
                                         bf16* out, bf16* dst, int ldd, Post post) {
  const int lane = threadIdx.x & 31, t0 = rank * tpc, ld = 8 * tpc;
  // 16 x 8 nt elements, a multiple of 128: a warp is wholly in or out, and
  // lane pairs hold column pairs
  const int w8 = 8 * cta_tiles(n, tpc, rank);
  for (int i = threadIdx.x; i < kTile * w8; i += kThreads) {
    const int b = i / w8, lc = i - b * w8, o = t0 * 8 + lc;
    const float v = post(b, o, lc, accs[b * ld + lc]);
    const float v1 = __shfl_down_sync(0xffffffffu, v, 1);
    if ((lane & 1) == 0) {
      const uint32_t pair = pack_bf16(v, v1);
      if (out != nullptr) *reinterpret_cast<uint32_t*>(out + b * lda + lc) = pair;
      if (dst != nullptr) *reinterpret_cast<uint32_t*>(dst + (size_t)b * ldd + o) = pair;
    }
  }
}

// dst's row stride ldd: round16(n) unless given; X, xk, wsh: see mma_tile.
template <bool SWEEP, bool XPART = false, typename Post>
__device__ __forceinline__ void pass(const bf16* A, int lsh, int K, const bf16* W, int n, int tpc,
                                     int rank, const Layout& cl, float* accs, bf16* out, bf16* dst,
                                     Post post, int ldd = 0, const bf16* X = nullptr, int xk = 0,
                                     int wsh = 0) {
  const int warp = threadIdx.x >> 5;
  const int S = dnnpde_round16(K) >> 4, ld = 8 * tpc, lda = cl.lwmax + 8;
  const int nt = cta_tiles(n, tpc, rank);
  // W's rows: the column slice's of 8 tpc columns, the row slice's blocks' of 2^lsh
  const int ldw = (SWEEP ? 1 << lsh : ld) + 8;
  for (int lt = warp; lt < nt; lt += kWarps)
    mma_tile<SWEEP, XPART>(A, lsh, S, W, ldw, ld * ldw, lt, cl.blk, lda, accs, ld, X, xk, wsh);
  __syncthreads();
  epilogue(n, tpc, rank, lda, accs, out, dst, ldd ? ldd : dnnpde_round16(n), post);
}

// The row chain of design 1', in the order and with the epilogues of
// ::mlp_u_z_bwd_rows (NAIS: ::mlp_u_z_bwd_rows_nais); grid: tiles x ctas
// CTAs in clusters of ctas (kCtas, NAIS kNaisCtas).
//
// The exchange: after a pass has written the CTA's block of the next
// operand, one bulk copy a peer sends the block to the same place in the
// peer's buffer, counted on the peer's mbarrier (exchange e uses mbarrier
// e % 2, armed for ctas - 1 blocks); before the next pass a CTA waits on its
// own. No barrier is needed besides: a peer sends exchange e + 1 into the
// buffer of exchange e - 1 only after it had all of exchange e, so after
// every CTA had finished reading that buffer; and the mbarriers alternate,
// so a copy for e + 1 cannot complete the phase of e. Operands that no pass
// reads (bf(a_{L-1}), q_0) are not exchanged, nor, in the NAIS-Net, bf(x)
// and bf(z_bar), which every CTA holds whole.
template <bool NAIS>
__device__ __forceinline__ void chain(const float* __restrict__ x, const float* __restrict__ ubar,
                                      const float* __restrict__ zbar, float* __restrict__ xbar,
                                      bf16* __restrict__ ops, float* __restrict__ partials,
                                      const MlpWeights& w, const BwdLayout& lay, const Layout& cl,
                                      int B) {
  constexpr int kC = NAIS ? kNaisCtas : kCtas;
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = w.L;
  const int n0 = w.width[0], n0p = dnnpde_round16(n0);
  const int H = w.width[L - 1];
  const int rank = cta_rank(), tile = cluster_index();
  bf16* frag = reinterpret_cast<bf16*>(smem);
  float* inp = reinterpret_cast<float*>(frag + cl.frag);
  uint64_t* xbars = reinterpret_cast<uint64_t*>(inp);  // the exchange's two mbarriers
  float* xin = inp + 8;                      // the tile's x, then z_bar, in f32
  float* zin = xin + kTile * n0p;
  float* ub = zin + kTile * n0p;
  const float* wsm = inp + cl.wtop;          // the CTA's columns of W_{L-1}
  const int ldx = n0p + 8;
  bf16* xop = reinterpret_cast<bf16*>(inp + cl.xop);  // NAIS: bf(x), whole
  bf16* zop = xop + kTile * ldx;                      // NAIS: bf(z_bar), whole
  float* region = inp + cl.inputs;
  float* stg[2] = {region, region + cl.stage};
  bf16* act0 = reinterpret_cast<bf16*>(region);  // the operands, in blocks
  bf16* act1 = act0 + kC * cl.blk;
  bf16* act2 = act1 + kC * cl.blk;
  float* P = reinterpret_cast<float*>(act2 + kC * cl.blk);  // the CTA's columns of p_k
  float* R = P + cl.hidden;                  // r_{k+1}, then pz_k; NAIS: then a_bar_{k+1}
  float* fa = R + cl.hidden;                 // working rows: the top layer's c, then p_bar;
                                             // NAIS: the c stream, then p_bar
  float* fb = fa + kTile * cl.lwmax;         // NAIS: the forward's a stream first
  float* sinp = fb + kTile * cl.lwmax;       // the head's bf(sin p); NAIS: bf(a_{L-1})
  float* accs = sinp + kTile * cl.lwmax;     // a pass's accumulators
  const int lwx = 8 * cl.tpc[0];             // the CTA's x columns
  float* accx = accs + kTile * cl.lwmax;     // NAIS: the accumulators of the x rows' tiles
  float* xacc = accx + kTile * lwx;          // NAIS: x_bar's sum over the blocks
  const int lda = cl.lwmax + 8;
  const int row0 = tile * kTile;
  float* part = partials + (size_t)tile * lay.ntail;
  const float* wtop = w.W[L - 1];
  auto zrows = [&](long long off, int n) { return ops + off + (size_t)row0 * dnnpde_round16(n); };
  auto urows = [&](long long off, int n) {
    return ops + off + (size_t)(lay.half + row0) * dnnpde_round16(n);
  };
  auto lsh = [&](int k) { return log2_pow2(8 * cl.tpc[k]); };  // of width[k]'s blocks
  const uint32_t xbytes = 2u * cl.blk;
  const int exchanges = 4 * L - 7;
  const int xsh = cl.xrows - n0p;  // NAIS: -A_k's rows in a block's column slice, less n0p

  // ---- prologue: the inputs, and every column slice through two staging
  // buffers, each slice's copy in flight while the one before is converted;
  // then each row slice from the peers' column slices, which hold its rows
  // (already in bf16): the weights are read from L2 once a cluster
  uint64_t* tbar = xbars + 2;  // the row slices' blocks
  if (threadIdx.x == 0) {
    mbar_init(xbars);
    mbar_init(xbars + 1);
    mbar_init(tbar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(xbars, (kC - 1) * xbytes);  // exchanges 0 and 1
    mbar_expect(xbars + 1, (kC - 1) * xbytes);
    uint32_t rows = 0;
    for (int k = 0; k < L - 1; ++k) {
      rows += 2u * kC * 8 * cl.tpc[k] * (8 * cl.tpc[k + 1] + 8);
      if (NAIS && k > 0) rows += 2u * cl.xrows * (8 * cl.tpc[k + 1] + 8);  // U_k's
    }
    mbar_expect(tbar, rows);
  }
  __syncthreads();
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");  // waited on below
  for (int i = threadIdx.x; i < kTile * n0p; i += kThreads) {
    const int b = i / n0p, c = i - b * n0p, r = row0 + b;
    const bool ok = r < B && c < n0;
    cp_async4(xin + i, ok ? x + (size_t)r * n0 + c : x, ok);
    cp_async4(zin + i, ok ? zbar + (size_t)r * n0 + c : zbar, ok);
  }
  for (int b = threadIdx.x; b < kTile; b += kThreads)
    cp_async4(ub + b, row0 + b < B ? ubar + row0 + b : ubar, row0 + b < B);
  for (int k = 0; k < L; ++k) {  // k = L - 1: W_{L-1}'s column 0
    const int lw = 8 * cl.tpc[k + (k < L - 1)], c0 = rank * lw, n = k < L - 1 ? w.width[k + 1] : H;
    const float* src = k < L - 1 ? w.b[k] : wtop;
    float* d = inp + (k < L - 1 ? cl.bias[k] : cl.wtop);
    for (int j = threadIdx.x; j < lw; j += kThreads)
      cp_async4(d + j, c0 + j < n ? src + c0 + j : src, c0 + j < n);
  }
  const int slices = L - 1;
  // W_k's column slice: its rows of this CTA's lw columns, c0 on
  auto stage = [&](int k, float* buf) {
    const int n = w.width[k + 1], lw = 8 * cl.tpc[k + 1], c0 = rank * lw;
    const int rows = NAIS && k > 0 ? n0p + w.width[k] : w.width[k];
    const float* W = w.W[k];
    if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(W) & 15) == 0)
      copy_rows<true>(buf, W + c0, n, rows, lw, n - c0, W);
    else
      copy_rows<false>(buf, W + c0, n, rows, lw, n - c0, W);
    cp_async_commit();
  };
  stage(0, stg[0]);  // the inputs' copies join this group
  if (slices > 1) stage(1, stg[1]);
  else cp_async_commit();
  for (int k = 0; k < slices; ++k) {
    const int lwo = 8 * cl.tpc[k + 1];
    cp_async_wait<1>();
    __syncthreads();
    if (NAIS && k > 0) {  // U_k's rows (and the zero rows after them), then -A_k's
      convert(frag + cl.fwd[k], stg[k & 1], cl.xrows, n0p, lwo);
      convert(frag + cl.fwd[k] + cl.xrows * (lwo + 8), stg[k & 1] + n0p * lwo,
              kC * 8 * cl.tpc[k], w.width[k], lwo);
    } else {
      convert(frag + cl.fwd[k], stg[k & 1], kC * 8 * cl.tpc[k], w.width[k], lwo);
    }
    __syncthreads();
    if (k + 2 < slices) stage(k + 2, stg[k & 1]);
    else cp_async_commit();
  }
  if constexpr (NAIS) {
    // bf(x) and bf(z_bar), whole in every CTA; CTA k < L - 1 stores them as
    // the first n0p columns of layer k's scratch operands
    const bool mine = rank < L - 1;
    const int kk = mine ? rank : 0, K = lay.kin[kk], ldk = dnnpde_round16(K);
    bf16* xs = urows(lay.aop[kk], K);
    bf16* zs = zrows(lay.aop[kk], K);
    for (int i = threadIdx.x; i < kTile * n0p; i += kThreads) {
      const int b = i / n0p, c = i - b * n0p;
      const bf16 xv = __float2bfloat16_rn(xin[i]), zv = __float2bfloat16_rn(zin[i]);
      xop[b * ldx + c] = xv;
      zop[b * ldx + c] = zv;
      if (mine) {
        xs[(size_t)b * ldk + c] = xv;
        zs[(size_t)b * ldk + c] = zv;
      }
    }
  } else {
    // the region is the operands' now: bf(x) in act0 and bf(z_bar) in act2,
    // whole in every CTA; rank 0 stores them, the A operands of W_bar_0
    bf16* a0 = urows(lay.aop[0], n0);
    bf16* c0 = zrows(lay.aop[0], n0);
    const int lsh0 = lsh(0), mask0 = (1 << lsh0) - 1;
    for (int b = threadIdx.x / n0p, c = threadIdx.x % n0p, db = kThreads / n0p, dc = kThreads % n0p;
         b < kTile;) {
      const int i = b * n0p + c, at = (c >> lsh0) * cl.blk + b * lda + (c & mask0);
      const bf16 xv = __float2bfloat16_rn(xin[i]), zv = __float2bfloat16_rn(zin[i]);
      act0[at] = xv;
      act2[at] = zv;
      if (rank == 0) {
        a0[i] = xv;
        c0[i] = zv;
      }
      b += db;
      c += dc;
      if (c >= n0p) {
        c -= n0p;
        ++b;
      }
    }
  }
  // the row slices: CTA r's row slice of W_k is rows [lwK r, lwK (r + 1))
  // of W_k (a NAIS block's: of -A_k), and the column slice of CTA p holds
  // them for its columns, in the same bf16 and layout: one bulk copy each to
  // block p of r's; a NAIS block's U_k rows of r's x columns likewise
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the slices, to the copies
  __syncthreads();
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");  // every peer runs
  if (threadIdx.x < kC * (L - 1)) {
    const int r = threadIdx.x % kC, k = threadIdx.x / kC;
    const int lwK = 8 * cl.tpc[k], ldw = 8 * cl.tpc[k + 1] + 8;
    const int from = (NAIS && k > 0 ? cl.xrows : 0) + r * lwK;
    send(frag + cl.fwd[k] + from * ldw, 2u * lwK * ldw, r, tbar,
         frag + cl.swp[k] + rank * lwK * ldw);
  } else if (NAIS && threadIdx.x < kC * (2 * L - 3)) {
    const int t = threadIdx.x - kC * (L - 1), r = t % kC, k = 1 + t / kC;
    const int ldw = 8 * cl.tpc[k + 1] + 8;
    send(frag + cl.fwd[k] + r * lwx * ldw, 2u * lwx * ldw, r, tbar,
         frag + cl.swx[k] + rank * lwx * ldw);
  }
  mbar_wait(tbar, 0);

  // ---- exchange e: our block of buf to every peer; then our own wait
  int e = 0;
  auto exchange = [&](bf16* buf) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the block, to the copies
    __syncthreads();
    if (threadIdx.x < kC && threadIdx.x != rank)
      send(buf + rank * cl.blk, xbytes, threadIdx.x, xbars + (e & 1));
    mbar_wait(xbars + (e & 1), (e >> 1) & 1);
    if (threadIdx.x == 0 && e + 2 < exchanges) mbar_expect(xbars + (e & 1), (kC - 1) * xbytes);
    ++e;
  };

  // ---- recompute the forward pass: p_k; bf(a_{k+1}) is the next A operand
  // (NAIS: a_{k+1} = sin p_k + a_k in f32 in fb, a block's A [bf(x), bf(a_k)])
  bf16* cur = act0;
  bf16* nxt = act1;
  auto flip = [&] {
    bf16* t = cur; cur = nxt; nxt = t;
  };
  for (int k = 0; k < L - 1; ++k) {  // bf(a_{L-1}) is no pass's operand
    const int K = w.width[k], n = w.width[k + 1], tpc = cl.tpc[k + 1], ld = 8 * tpc;
    const bool last = k == L - 2;
    float* Pk = P + cl.slot[k];
    const float* bias = inp + cl.bias[k];
    const int Kn = NAIS ? lay.kin[k + 1] : n;
    auto post = [&](int b, int o, int lc, float acc) {
      float s = 0.f;
      if (o < n) {
        const float p = acc + bias[lc];
        Pk[b * ld + lc] = p;
        s = sinf(p);
        if (NAIS) {
          if (k > 0) s += fb[b * ld + lc];
          fb[b * ld + lc] = s;
          if (last) sinp[b * ld + lc] = bf16_round(s);
        }
      }
      return s;
    };
    bf16* out = last ? nullptr : nxt + rank * cl.blk;
    bf16* dst = last ? nullptr : urows(lay.aop[k + 1], Kn) + (NAIS ? n0p : 0);
    pass<false, NAIS>(cur, lsh(k), NAIS ? n0p + (k > 0 ? K : 0) : K, frag + cl.fwd[k], n, tpc,
                      rank, cl, accs, out, dst, post, dnnpde_round16(Kn), xop, n0p, xsh);
    if (last) {
      __syncthreads();
    } else {
      exchange(nxt);
      flip();
    }
  }

  // ---- Z-sweep: q_{L-2} = bf(r_{L-1} cos p_{L-2}), then r_k and q_{k-1}
  // (NAIS: r_k = r_{k+1} + q_k (-A_k)^T on -A_k's row slice)
  {
    const int tpc = cl.tpc[L - 1], ld = 8 * tpc, sh = log2_pow2(ld), hp = dnnpde_round16(H);
    const float* Pt = P + cl.slot[L - 2];
    bf16* q = zrows(lay.bop[L - 2], H);
    for (int i = threadIdx.x; i < kTile * ld; i += kThreads) {
      const int b = i >> sh, lc = i & (ld - 1), j = rank * ld + lc;
      if (j < hp) {
        const bf16 v = __float2bfloat16_rn(j < H ? wsm[lc] * cosf(Pt[b * ld + lc]) : 0.f);
        if (L > 2) nxt[rank * cl.blk + b * lda + lc] = v;
        q[b * hp + j] = v;
      }
    }
    if (L > 2) {
      exchange(nxt);
      flip();
    }
  }
  for (int k = L - 2; k >= 1; --k) {  // q_0 is no pass's operand
    const int K = w.width[k + 1], n = w.width[k], tpc = cl.tpc[k], ld = 8 * tpc;
    float* Rk = R + cl.slot[k - 1];
    const float* Rn = R + cl.slot[k];  // NAIS: r_{k+1}
    const float* Pp = P + cl.slot[k - 1];
    pass<true>(cur, lsh(k + 1), K, frag + cl.swp[k], n, tpc, rank, cl, accs,
               k > 1 ? nxt + rank * cl.blk : nullptr, zrows(lay.bop[k - 1], n),
               [&](int b, int o, int lc, float acc) {
                 float v = 0.f;
                 if (o < n) {
                   float r = acc;
                   if (NAIS) r = (k == L - 2 ? wsm[lc] : Rn[b * ld + lc]) + acc;
                   Rk[b * ld + lc] = r;
                   v = r * cosf(Pp[b * ld + lc]);
                 }
                 return v;
               });
    if (k > 1) {
      exchange(nxt);
      flip();
    } else {
      __syncthreads();
    }
  }

  // ---- Z-path adjoint, ascending, from c_0 = bf(z_bar) in act2 (the operand
  // the sweep's last pass did not write, nor read: it joins the rotation);
  // NAIS: from zop, a block's A [bf(z_bar), bf(c_k)], c_{k+1} = c_k + qb cos p_k in fa
  if (!NAIS) cur = act2;
  for (int k = 0; k < L - 1; ++k) {
    const int K = w.width[k], n = w.width[k + 1], tpc = cl.tpc[k + 1], ld = 8 * tpc;
    const bool top = k == L - 2;
    const float* Pk = P + cl.slot[k];
    float* Rk = R + cl.slot[k];
    const int Kn = NAIS ? lay.kin[k + 1] : n;
    auto post = [&](int b, int o, int lc, float qbar) {
      float v = 0.f;
      if (o < n) {
        const float p = Pk[b * ld + lc];
        const float r = top ? wsm[lc] : Rk[b * ld + lc];
        Rk[b * ld + lc] = -qbar * r * sinf(p);  // pz_k replaces r_{k+1}
        v = qbar * cosf(p);
        if (NAIS) {
          if (k > 0) v += fa[b * ld + lc];
          fa[b * ld + lc] = v;
        } else if (top) {
          fa[b * ld + lc] = v;  // summed unrounded into W_bar_{L-1}
        }
      }
      return v;
    };
    bf16* out = top ? nullptr : nxt + rank * cl.blk;
    bf16* dst = top ? nullptr : zrows(lay.aop[k + 1], Kn) + (NAIS ? n0p : 0);
    pass<false, NAIS>(cur, lsh(k), NAIS ? n0p + (k > 0 ? K : 0) : K, frag + cl.fwd[k], n, tpc,
                      rank, cl, accs, out, dst, post, dnnpde_round16(Kn), zop, n0p, xsh);
    if (top) {
      __syncthreads();
    } else {
      exchange(nxt);
      flip();
    }
  }

  // ---- u-path head: p_bar_{L-2} and bf(sin p) of the CTA's columns, every
  // row at once; then the column sums, one thread a column in row order, as
  // the one-block design sums them
  {
    const int tpc = cl.tpc[L - 1], ld = 8 * tpc, sh = log2_pow2(ld), hp = dnnpde_round16(H);
    const float* Pt = P + cl.slot[L - 2];
    const float* Zt = R + cl.slot[L - 2];
    bf16* pb = urows(lay.bop[L - 2], H);
    for (int i = threadIdx.x; i < kTile * ld; i += kThreads) {
      const int b = i >> sh, lc = i & (ld - 1), j = rank * ld + lc;
      if (j >= hp) continue;
      float pbar = 0.f;
      if (j < H) {
        const float wj = bf16_round(wsm[lc]);
        const float p = Pt[b * ld + lc], u = bf16_round(ub[b]);
        pbar = (u * wj) * cosf(p) + Zt[b * ld + lc];
        fb[b * ld + lc] = pbar;
        if (!NAIS) sinp[b * ld + lc] = bf16_round(sinf(p));
      }
      const bf16 v = __float2bfloat16_rn(pbar);
      nxt[rank * cl.blk + b * lda + lc] = v;
      pb[b * hp + j] = v;
    }
    __syncthreads();
    for (int lc = threadIdx.x; lc < ld; lc += kThreads) {
      const int j = rank * ld + lc;
      if (j >= H) continue;
      float zc = 0.f, sw = 0.f, sb = 0.f;
      for (int b = 0; b < kTile; ++b) {
        zc += fa[b * ld + lc];
        sw = fmaf(sinp[b * ld + lc], bf16_round(ub[b]), sw);
        sb += fb[b * ld + lc];
      }
      part[j] = zc + sw;
      part[lay.boff[L - 2] - lay.woff[L - 1] + j] = sb;
    }
    if (rank == 0 && threadIdx.x == 0) {
      float s = 0.f;
      for (int b = 0; b < kTile; ++b) s += ub[b];
      part[lay.ntail - 1] = s;
    }
    exchange(nxt);
    flip();
  }

  // ---- u-path, descending: fb holds p_bar_k, the pass writes p_bar_{k-1} to fa
  for (int k = L - 2; k >= 0; --k) {
    const int K = w.width[k], n = w.width[k + 1];
    if (k < L - 2) {  // b_bar_k: the CTA's column sums of the unrounded p_bar_k
      const int ld = 8 * cl.tpc[k + 1];
      for (int lc = threadIdx.x; lc < ld; lc += kThreads) {
        const int j = rank * ld + lc;
        if (j >= n) continue;
        float s = 0.f;
        for (int b = 0; b < kTile; ++b) s += fb[b * ld + lc];
        part[lay.boff[k] - lay.woff[L - 1] + j] = s;
      }
    }
    if (k > 0) {
      const int tpc = cl.tpc[k], ld = 8 * tpc;
      const float* Pp = P + cl.slot[k - 1];
      const float* Zp = R + cl.slot[k - 1];
      if constexpr (NAIS) {
        // a block: its -A_k rows (a_bar_k = a_bar_{k+1} + p_bar_k (-A_k)^T
        // in f32, into slot k, whose pz_k p_bar_k has taken up; p_bar_{k-1}
        // from it) and, on warps those leave idle, its U_k rows of the same
        // operand: the block's share of x_bar, summed in xacc
        float* Ak = R + cl.slot[k];
        const float* An = R + cl.slot[k + 1 < L - 1 ? k + 1 : k];  // a_bar_{k+1}
        const int warp = threadIdx.x >> 5, lshn = lsh(k + 1), ldw = (1 << lshn) + 8;
        const int S = dnnpde_round16(n) >> 4;
        const int nta = cta_tiles(K, tpc, rank), ntx = cta_tiles(n0, cl.tpc[0], rank);
        for (int lt = warp; lt < nta + ntx; lt += kWarps) {
          if (lt < nta)
            mma_tile<true>(cur, lshn, S, frag + cl.swp[k], ldw, ld * ldw, lt, cl.blk, lda, accs, ld);
          else
            mma_tile<true>(cur, lshn, S, frag + cl.swx[k], ldw, lwx * ldw, lt - nta, cl.blk, lda,
                           accx, lwx);
        }
        __syncthreads();
        epilogue(K, tpc, rank, lda, accs, nxt + rank * cl.blk, urows(lay.bop[k - 1], K),
                 dnnpde_round16(K), [&](int b, int o, int lc, float abar) {
                   float v = 0.f;
                   if (o < K) {
                     const float an = (k == L - 2 ? bf16_round(ub[b]) * bf16_round(wsm[lc])
                                                  : An[b * ld + lc]) + abar;
                     Ak[b * ld + lc] = an;
                     v = an * cosf(Pp[b * ld + lc]) + Zp[b * ld + lc];
                     fa[b * ld + lc] = v;
                   }
                   return v;
                 });
        // the x rows' epilogue, on the threads from the last down
        for (int i = kThreads - 1 - threadIdx.x; i < kTile * 8 * ntx; i += kThreads) {
          const int b = i / (8 * ntx), lc = i - b * 8 * ntx;
          if (rank * lwx + lc < n0) {
            const float xb = accx[b * lwx + lc];
            xacc[b * lwx + lc] = k == L - 2 ? xb : xacc[b * lwx + lc] + xb;
          }
        }
      } else {
        pass<true>(cur, lsh(k + 1), n, frag + cl.swp[k], K, tpc, rank, cl, accs,
                   nxt + rank * cl.blk, urows(lay.bop[k - 1], K),
                   [&](int b, int o, int lc, float abar) {
                     float v = 0.f;
                     if (o < K) {
                       v = abar * cosf(Pp[b * ld + lc]) + Zp[b * ld + lc];
                       fa[b * ld + lc] = v;
                     }
                     return v;
                   });
      }
      exchange(nxt);
      flip();
      float* t = fa; fa = fb; fb = t;
    } else {
      pass<true>(cur, lsh(1), n, frag + cl.swp[0], n0, cl.tpc[0], rank, cl, accs, nullptr,
                 nullptr, [&](int b, int o, int lc, float abar) {
                   if (o < n0 && row0 + b < B)
                     xbar[(size_t)(row0 + b) * n0 + o] = NAIS ? abar + xacc[b * lwx + lc] : abar;
                   return 0.f;
                 });
    }
  }
  cluster_sync();  // no CTA leaves while a copy from its shared memory may be in flight
}

__global__ void __launch_bounds__(kThreads, 1)
mlp_u_z_bwd_rows(const float* __restrict__ x, const float* __restrict__ ubar,
                 const float* __restrict__ zbar, float* __restrict__ xbar,
                 bf16* __restrict__ ops, float* __restrict__ partials, const MlpWeights w,
                 const BwdLayout lay, const Layout cl, int B) {
  chain<false>(x, ubar, zbar, xbar, ops, partials, w, lay, cl, B);
}

__global__ void __launch_bounds__(kThreads, 1)
mlp_u_z_bwd_rows_nais(const float* __restrict__ x, const float* __restrict__ ubar,
                      const float* __restrict__ zbar, float* __restrict__ xbar,
                      bf16* __restrict__ ops, float* __restrict__ partials, const MlpWeights w,
                      const BwdLayout lay, const Layout cl, int B) {
  chain<true>(x, ubar, zbar, xbar, ops, partials, w, lay, cl, B);
}

}  // namespace cluster

// ---- the weight gradients -------------------------------------------------

constexpr int kGradM = 32;         // rows of a W_bar tile (the layer's inputs)
constexpr int kGradN = 64;         // its columns (the layer's outputs)
constexpr int kGradK = 64;         // scratch rows per staged chunk
constexpr int kGradStages = 3;
constexpr int kGradThreads = 128;  // warp w owns the tile's columns 16w .. 16w + 15
constexpr int kGradLdA = kGradM + 8, kGradLdB = kGradN + 8;  // rows 16 bytes apart modulo 128

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
    const int t = grad_tiles(lay.kin[k], w.width[k + 1]);
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

  const int K = lay.kin[k], N = w.width[k + 1];
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
// layers), or -1 for shapes it does not take. Both row-chain designs fill
// the same scratch.
extern "C" long long mlp_u_z_bwd_scratch_bytes(const int* widths, int L, int B) {
  if (L < 2 || L > DNNPDE_MAX_LAYERS || B <= 0) return -1;
  return make_layout(widths, L, B, false).bytes;
}

// The same for the NAIS-Net's K2 (mlp_u_z_bwd_nais): its blocks' operands
// are [x, a_k] and [z_bar, c_k].
extern "C" long long mlp_u_z_bwd_nais_scratch_bytes(const int* widths, int L, int B) {
  if (L < 3 || L > DNNPDE_MAX_LAYERS || B <= 0) return -1;
  return make_layout(widths, L, B, true).bytes;
}

// Bytes of shared memory a CTA of the clustered row chain needs (design 1'),
// or -1 for shapes it does not take; it runs where this is at most
// DNNPDE_MAX_SMEM (ops/mlp_kernel.py::bwd_cluster_smem_bytes computes the same).
extern "C" long long mlp_u_z_bwd_cluster_smem_bytes(const int* widths, int L) {
  if (L < 2 || L > DNNPDE_MAX_LAYERS) return -1;
  return cluster::make(widths, L, false).smem;
}

// The same for the NAIS-Net's clustered row chain (16 CTAs a cluster).
extern "C" long long mlp_u_z_bwd_nais_cluster_smem_bytes(const int* widths, int L) {
  if (L < 3 || L > DNNPDE_MAX_LAYERS) return -1;
  return cluster::make(widths, L, true).smem;
}

namespace {

// The row chain in either design, then the weight gradients.
int launch(const float* x, const float* u_bar, const float* z_bar, float* x_bar, float* grads,
           void* scratch, const void* const* Ws, const void* const* bs, const int* widths, int L,
           int B, void* stream, bool clustered, bool nais = false) {
  MlpWeights w;
  cudaError_t err = dnnpde_fill_weights(&w, Ws, bs, widths, L);
  if (err != cudaSuccess) return err;
  if (B <= 0 || (reinterpret_cast<uintptr_t>(scratch) & 15) != 0) return cudaErrorInvalidValue;
  if (nais && L < 3) return cudaErrorInvalidValue;
  const BwdLayout lay = make_layout(w.width, L, B, nais);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* ops = static_cast<bf16*>(scratch);
  float* partials = reinterpret_cast<float*>(static_cast<char*>(scratch) + lay.part);
  if (clustered) {
    const cluster::Layout cl = cluster::make(w.width, L, nais);
    if (cl.smem > DNNPDE_MAX_SMEM) return cudaErrorInvalidValue;
    const auto rows = nais ? cluster::mlp_u_z_bwd_rows_nais : cluster::mlp_u_z_bwd_rows;
    const int ctas = nais ? cluster::kNaisCtas : cluster::kCtas;
    err = cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cl.smem);
    if (err == cudaSuccess && nais)  // 16 CTAs: beyond the portable 8
      err = cudaFuncSetAttribute(rows, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(lay.tiles * ctas);
    cfg.blockDim = dim3(cluster::kThreads);
    cfg.dynamicSmemBytes = (size_t)cl.smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, rows, x, u_bar, z_bar, x_bar, ops, partials, w, lay, cl, B);
    if (err != cudaSuccess) return err;
  } else {
    size_t smem =
        sizeof(float) * ((size_t)kTile * (2 * (size_t)lay.hidden + lay.ldm) + kTile) +
        sizeof(bf16) * ((size_t)kRow16StageElems + 2 * (size_t)kTile * lay.lda);
    // NAIS: the head's column sums of bf(a_{L-1}) bf(u_bar) and x_bar's sum over the blocks
    if (nais)
      smem += sizeof(float) * ((size_t)dnnpde_round4(w.width[L - 1]) +
                               (size_t)kTile * dnnpde_round4(w.width[0]));
    if (smem > DNNPDE_MAX_SMEM) return cudaErrorInvalidValue;
    const auto rows = nais ? mlp_u_z_bwd_rows_nais : mlp_u_z_bwd_rows;
    err = cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    rows<<<lay.tiles, kTcThreads, smem, s>>>(x, u_bar, z_bar, x_bar, ops, partials, w, lay, B);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int blocks = (lay.ntail + kGradThreads - 1) / kGradThreads;
  for (int k = 0; k < L - 1; ++k) blocks += grad_tiles(lay.kin[k], w.width[k + 1]);
  mlp_u_z_bwd_wgrad<<<blocks, kGradThreads, 0, s>>>(ops, partials, grads, w, lay);
  return cudaGetLastError();
}

}  // namespace

// Launches K2 on `stream` with the one-block row chain (design 1). x, z_bar,
// x_bar (B, n0); u_bar (B, 1); grads: the flat gradient buffer (every W_k
// row-major, then every b_k); scratch: mlp_u_z_bwd_scratch_bytes(widths, L,
// B) bytes, 16-byte aligned. All f32, contiguous, on the current device.
// Returns cudaGetLastError() after the two launches.
extern "C" int mlp_u_z_bwd(const float* x, const float* u_bar, const float* z_bar,
                           float* x_bar, float* grads, void* scratch, const void* const* Ws,
                           const void* const* bs, const int* widths, int L, int B,
                           void* stream) {
  return launch(x, u_bar, z_bar, x_bar, grads, scratch, Ws, bs, widths, L, B, stream, false);
}

// The same with the row chain on thread-block clusters (design 1'), for
// shapes whose mlp_u_z_bwd_cluster_smem_bytes is at most DNNPDE_MAX_SMEM;
// the outputs are mlp_u_z_bwd's bit for bit.
extern "C" int mlp_u_z_bwd_cluster(const float* x, const float* u_bar, const float* z_bar,
                                   float* x_bar, float* grads, void* scratch,
                                   const void* const* Ws, const void* const* bs,
                                   const int* widths, int L, int B, void* stream) {
  return launch(x, u_bar, z_bar, x_bar, grads, scratch, Ws, bs, widths, L, B, stream, true);
}

// K2 for the NAIS-Net, on the one-block row chain (mlp_u_z_bwd_rows_nais):
// widths [n0, H, ..., H, 1] with at least one block, W_0 (n0 x H), each
// block's (round16(n0) + H) x H ([U_k; 0; -A_k]) and W_{L-1} (H x 1); the
// gradients in those shapes. scratch: mlp_u_z_bwd_nais_scratch_bytes bytes.
extern "C" int mlp_u_z_bwd_nais(const float* x, const float* u_bar, const float* z_bar,
                                float* x_bar, float* grads, void* scratch,
                                const void* const* Ws, const void* const* bs,
                                const int* widths, int L, int B, void* stream) {
  return launch(x, u_bar, z_bar, x_bar, grads, scratch, Ws, bs, widths, L, B, stream, false,
                true);
}

// The same with the row chain on clusters of 16 CTAs
// (cluster::mlp_u_z_bwd_rows_nais), for shapes whose
// mlp_u_z_bwd_nais_cluster_smem_bytes is at most DNNPDE_MAX_SMEM; the
// outputs are mlp_u_z_bwd_nais's bit for bit.
extern "C" int mlp_u_z_bwd_nais_cluster(const float* x, const float* u_bar, const float* z_bar,
                                        float* x_bar, float* grads, void* scratch,
                                        const void* const* Ws, const void* const* bs,
                                        const int* widths, int L, int B, void* stream) {
  return launch(x, u_bar, z_bar, x_bar, grads, scratch, Ws, bs, widths, L, B, stream, true, true);
}
