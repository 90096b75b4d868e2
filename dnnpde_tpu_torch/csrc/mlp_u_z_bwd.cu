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
// Bound on an H100 SXM: per row the kernel does 5 * 222,464 + 196,608 + 512
// ~ 1.31 M multiply-adds at [101, 256 x 4, 1] (forward, sweep, Z-path dot and
// outer product, u-path outer product and dot). At B = 100 that is 0.26
// GFLOP against ~1.9 MB (weights read, gradients written, x, u_bar, z_bar,
// x_bar): bound by bytes, 0.57 us. At B = 2048 it is 5.4 GFLOP: bound by
// operations, 5.4 us at the bf16 tensor-core peak.
//
// Design of this first version. The TPU kernel accumulates W_bar and b_bar by
// read-modify-write into one output block across the batch grid, which is
// race-free only because a TPU grid runs in order. Here blocks run
// concurrently, so each block owns a partial sum of all gradients in a
// scratch buffer (the wrapper allocates it) and a second kernel sums the
// partials in block order. There are no float atomics, so the result does not
// change from run to run. The grid is capped (the wrapper passes at most one
// block per SM) and each block walks several 16-row tiles, which bounds the
// scratch at grid x 0.9 MB. One block of 256 threads holds a tile's p_k, the
// sweep's r_k (overwritten by pz_k in the Z-path), bf(x) and two working
// buffers in dynamic shared memory: 16 x (104 + 2 x 1024 + 2 x 256) floats
// = 170 KB at full width. sin and cos are recomputed from p_k where needed.
// The ragged batch is masked by loading zero x, u_bar and z_bar rows, whose
// contributions to every gradient are exactly zero, and by not storing their
// x_bar. The dots run on the CUDA cores in f32 FMAs on bf16-rounded operands,
// as K1's do; tensor cores are what would close the gap to the bound.
#include "common.cuh"

namespace {

constexpr int kTile = 16;

// Offsets in floats. Shared-memory slot k (k < L-1) has width round4(n_{k+1})
// and starts at TILE * slot[k]; the gradients are laid out flat, every W_k
// (row-major, JAX layout) then every b_k.
struct BwdLayout {
  int slot[DNNPDE_MAX_LAYERS];
  int woff[DNNPDE_MAX_LAYERS];
  int boff[DNNPDE_MAX_LAYERS];
  int hidden;  // sum of the slot widths
  int ldm;     // widest round4(n_k)
  int total;   // number of gradient values
};

__device__ __forceinline__ void store_or_add(float* p, float v, bool first) {
  *p = first ? v : *p + v;
}

// out[i * n_j + j] (+)= sum_b A[b*lda + i] * Bm[b*ldb + j] for i < n_i,
// j < n_j: a weight-gradient update over the tile's rows, summed in row
// order. One thread owns a column j and keeps its TILE values of Bm in
// registers; the A reads are broadcasts.
template <int TILE>
__device__ __forceinline__ void tile_outer(const float* A, int lda, int n_i, const float* Bm,
                                           int ldb, int n_j, float* __restrict__ out,
                                           bool first) {
  for (int j = threadIdx.x; j < n_j; j += blockDim.x) {
    float bcol[TILE];
#pragma unroll
    for (int b = 0; b < TILE; ++b) bcol[b] = Bm[b * ldb + j];
    int i = 0;
    for (; i + 4 <= n_i; i += 4) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int b = 0; b < TILE; ++b) {
#pragma unroll
        for (int u = 0; u < 4; ++u) s[u] = fmaf(A[b * lda + i + u], bcol[b], s[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) store_or_add(out + (size_t)(i + u) * n_j + j, s[u], first);
    }
    for (; i < n_i; ++i) {
      float s = 0.f;
#pragma unroll
      for (int b = 0; b < TILE; ++b) s = fmaf(A[b * lda + i], bcol[b], s);
      store_or_add(out + (size_t)i * n_j + j, s, first);
    }
  }
}

template <int TILE>
__global__ void __launch_bounds__(DNNPDE_THREADS)
mlp_u_z_bwd_kernel(const float* __restrict__ x, const float* __restrict__ ubar,
                   const float* __restrict__ zbar, float* __restrict__ xbar,
                   float* __restrict__ partial, const MlpWeights w, const BwdLayout lay,
                   int B, int n_tiles) {
  extern __shared__ __align__(16) float smem[];
  const int L = w.L;
  const int n0 = w.width[0], ld0 = dnnpde_round4(n0);
  const int H = w.width[L - 1], ldh = dnnpde_round4(H);
  float* xa = smem;                       // bf(x), the A operand of layer 0
  float* P = xa + TILE * ld0;             // p_k
  float* R = P + TILE * lay.hidden;       // r_{k+1}, then pz_k
  float* buf0 = R + TILE * lay.hidden;
  float* buf1 = buf0 + TILE * lay.ldm;
  float* ub = buf1 + TILE * lay.ldm;      // u_bar of the tile's rows
  float* part = partial + (size_t)blockIdx.x * lay.total;
  const float* wtop = w.W[L - 1];         // W_{L-1}[:, 0] = r_{L-1}

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == blockIdx.x;
    const int row0 = tile * TILE;
    __syncthreads();  // the previous tile is done with shared memory
    for (int i = threadIdx.x; i < TILE * ld0; i += blockDim.x) {
      const int b = i / ld0, c = i - b * ld0, r = row0 + b;
      xa[i] = (r < B && c < n0) ? bf16_round(x[(size_t)r * n0 + c]) : 0.f;
    }
    for (int b = threadIdx.x; b < TILE; b += blockDim.x) ub[b] = row0 + b < B ? ubar[row0 + b] : 0.f;
    __syncthreads();

    // ---- recompute the forward pass: p_k into slot k
    const float* a = xa;
    float* nxt = buf0;
    for (int k = 0; k < L - 1; ++k) {
      const int K = w.width[k], n = w.width[k + 1], ldn = dnnpde_round4(n);
      float* Pk = P + TILE * lay.slot[k];
      const float* bias = w.b[k];
      tile_dot<TILE>(a, dnnpde_round4(K), K, w.W[k], n, 1, n, [&](int b, int o, float acc) {
        const float p = acc + __ldg(bias + o);
        Pk[b * ldn + o] = p;
        nxt[b * ldn + o] = bf16_round(sinf(p));
      });
      __syncthreads();
      a = nxt;
      nxt = nxt == buf0 ? buf1 : buf0;
    }

    // ---- Z-sweep: r_k for k = L-2 .. 1 into slot k-1
    float* q = buf0;
    float* qn = buf1;
    {
      const float* Pt = P + TILE * lay.slot[L - 2];
      for (int i = threadIdx.x; i < TILE * ldh; i += blockDim.x) {
        const int b = i / ldh, j = i - b * ldh;
        q[i] = j < H ? bf16_round(__ldg(wtop + j) * cosf(Pt[b * ldh + j])) : 0.f;
      }
    }
    __syncthreads();
    for (int k = L - 2; k >= 1; --k) {
      const int K = w.width[k + 1], n = w.width[k], ldn = dnnpde_round4(n);
      float* Rk = R + TILE * lay.slot[k - 1];
      const float* Pp = P + TILE * lay.slot[k - 1];
      tile_dot<TILE>(q, dnnpde_round4(K), K, w.W[k], 1, K, n, [&](int b, int o, float acc) {
        Rk[b * ldn + o] = acc;
        qn[b * ldn + o] = bf16_round(acc * cosf(Pp[b * ldn + o]));
      });
      __syncthreads();
      float* t = q; q = qn; qn = t;
    }

    // ---- Z-path adjoint, ascending; c starts as z_bar
    float* c = buf0;
    for (int i = threadIdx.x; i < TILE * ld0; i += blockDim.x) {
      const int b = i / ld0, j = i - b * ld0, r = row0 + b;
      c[i] = (r < B && j < n0) ? bf16_round(zbar[(size_t)r * n0 + j]) : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < L - 1; ++k) {
      const int K = w.width[k], n = w.width[k + 1], ldk = dnnpde_round4(K), ldn = dnnpde_round4(n);
      const bool top = k == L - 2;
      float* qb = c == buf0 ? buf1 : buf0;
      const float* Pk = P + TILE * lay.slot[k];
      float* Rk = R + TILE * lay.slot[k];
      for (int i = threadIdx.x; i < TILE * ldn; i += blockDim.x) {
        const int b = i / ldn, j = i - b * ldn;
        float v = 0.f;
        if (j < n) v = bf16_round((top ? __ldg(wtop + j) : Rk[i]) * cosf(Pk[i]));
        qb[i] = v;
      }
      __syncthreads();
      tile_outer<TILE>(c, ldk, K, qb, ldn, n, part + lay.woff[k], first);  // W_bar_k += c^T q
      __syncthreads();
      float colsum = 0.f;
      tile_dot<TILE>(c, ldk, K, w.W[k], n, 1, n, [&](int b, int o, float qbar) {
        const float p = Pk[b * ldn + o];
        const float r = top ? __ldg(wtop + o) : Rk[b * ldn + o];
        Rk[b * ldn + o] = -qbar * r * sinf(p);  // pz_k replaces r_{k+1}
        const float cn = qbar * cosf(p);
        if (!top) {
          qb[b * ldn + o] = bf16_round(cn);
        } else {  // W_bar_{L-1}[o, 0] += sum over rows of c
          colsum = b == 0 ? cn : colsum + cn;
          if (b == TILE - 1) store_or_add(part + lay.woff[L - 1] + o, colsum, first);
        }
      });
      __syncthreads();
      c = qb;
    }

    // ---- u-path, descending; the head in one pass over its columns
    float* pb = buf0;
    float* ab = buf1;
    {
      const float* Pt = P + TILE * lay.slot[L - 2];
      const float* Zt = R + TILE * lay.slot[L - 2];
      for (int j = threadIdx.x; j < H; j += blockDim.x) {
        const float wj = bf16_round(__ldg(wtop + j));
        float sw = 0.f, sb = 0.f;
        for (int b = 0; b < TILE; ++b) {
          const float p = Pt[b * ldh + j], u = bf16_round(ub[b]);
          const float pbar = (u * wj) * cosf(p) + Zt[b * ldh + j];
          pb[b * ldh + j] = bf16_round(pbar);
          sw = fmaf(bf16_round(sinf(p)), u, sw);
          sb += pbar;
        }
        store_or_add(part + lay.woff[L - 1] + j, sw, false);
        store_or_add(part + lay.boff[L - 2] + j, sb, first);
      }
      if (threadIdx.x == 0) {
        float s = 0.f;
        for (int b = 0; b < TILE; ++b) s += ub[b];
        store_or_add(part + lay.boff[L - 1], s, first);
      }
    }
    __syncthreads();
    for (int k = L - 2; k >= 0; --k) {
      const int K = w.width[k], n = w.width[k + 1], ldk = dnnpde_round4(K), ldn = dnnpde_round4(n);
      const float* ak = xa;
      if (k > 0) {
        const float* Pp = P + TILE * lay.slot[k - 1];
        for (int i = threadIdx.x; i < TILE * ldk; i += blockDim.x) {
          const int j = i % ldk;
          ab[i] = j < K ? bf16_round(sinf(Pp[i])) : 0.f;
        }
        __syncthreads();
        ak = ab;
      }
      tile_outer<TILE>(ak, ldk, K, pb, ldn, n, part + lay.woff[k], false);  // W_bar_k += a^T p_bar
      __syncthreads();
      if (k > 0) {
        const float* Pp = P + TILE * lay.slot[k - 1];
        const float* Zp = R + TILE * lay.slot[k - 1];
        float colsum = 0.f;
        tile_dot<TILE>(pb, ldn, n, w.W[k], 1, n, K, [&](int b, int o, float abar) {
          const float pbar = abar * cosf(Pp[b * ldk + o]) + Zp[b * ldk + o];
          ab[b * ldk + o] = bf16_round(pbar);
          colsum = b == 0 ? pbar : colsum + pbar;
          if (b == TILE - 1) store_or_add(part + lay.boff[k - 1] + o, colsum, first);
        });
        __syncthreads();
        float* t = pb; pb = ab; ab = t;
      } else {
        tile_dot<TILE>(pb, ldn, n, w.W[0], 1, n, n0, [&](int b, int o, float abar) {
          if (row0 + b < B) xbar[(size_t)(row0 + b) * n0 + o] = abar;
        });
      }
    }
  }
}

// out[i] = sum over g < G, in order, of partial[g * total + i].
__global__ void __launch_bounds__(DNNPDE_THREADS)
sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ out, int total, int G) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int g = 0; g < G; ++g) s += partial[(size_t)g * total + i];
    out[i] = s;
  }
}

}  // namespace

// Launches K2 on `stream`. x, z_bar, x_bar (B, n0); u_bar (B, 1); grads: the
// flat gradient buffer (every W_k row-major, then every b_k); partial: scratch
// of grid * (number of gradient values) floats. All f32, contiguous, on the
// current device; grid >= 1 blocks. Returns cudaGetLastError() after the two
// launches.
extern "C" int mlp_u_z_bwd(const float* x, const float* u_bar, const float* z_bar,
                           float* x_bar, float* grads, float* partial, const void* const* Ws,
                           const void* const* bs, const int* widths, int L, int B, int grid,
                           void* stream) {
  MlpWeights w;
  cudaError_t err = dnnpde_fill_weights(&w, Ws, bs, widths, L);
  if (err != cudaSuccess) return err;
  const int n_tiles = (B + kTile - 1) / kTile;
  if (B <= 0 || grid <= 0 || grid > n_tiles) return cudaErrorInvalidValue;
  BwdLayout lay;
  lay.hidden = 0;
  lay.ldm = 0;
  int off = 0;
  for (int k = 0; k < L; ++k) {
    lay.ldm = lay.ldm > dnnpde_round4(w.width[k]) ? lay.ldm : dnnpde_round4(w.width[k]);
    lay.woff[k] = off;
    off += w.width[k] * w.width[k + 1];
  }
  for (int k = 0; k < L; ++k) {
    lay.boff[k] = off;
    off += w.width[k + 1];
  }
  lay.total = off;
  for (int k = 0; k < L - 1; ++k) {
    lay.slot[k] = lay.hidden;
    lay.hidden += dnnpde_round4(w.width[k + 1]);
  }
  const size_t smem = sizeof(float) * ((size_t)kTile * (dnnpde_round4(w.width[0]) +
                                                       2 * (size_t)lay.hidden + 2 * lay.ldm) +
                                       kTile);
  if (smem > DNNPDE_MAX_SMEM) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(mlp_u_z_bwd_kernel<kTile>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mlp_u_z_bwd_kernel<kTile><<<grid, DNNPDE_THREADS, smem, s>>>(x, u_bar, z_bar, x_bar, partial,
                                                               w, lay, B, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rgrid = (lay.total + DNNPDE_THREADS - 1) / DNNPDE_THREADS;
  sum_partials_kernel<<<rgrid, DNNPDE_THREADS, 0, s>>>(partial, grads, lay.total, grid);
  return cudaGetLastError();
}
