// Kernel U: the lambdas of every query of a ranking dataset in one launch.
//
// It replaces no TPU kernel: the JAX package computes LambdaRank's
// gradients in XLA (`LambdaRank._grads_impl`,
// lightgbm_tpu/objectives.py:714-776) over queries padded to
// (num_queries, max_docs), an all-pairs (cq, mq, mq) tensor a chunk of
// queries, two argsorts and a scatter-add.  For each query and each
// document i it computes
//   g_i = sum_{j: l_i > l_j} lam(i, j) - sum_{j: l_j > l_i} lam(j, i)
//   h_i = sum_{j: l_i > l_j} eta(i, j) + sum_{j: l_j > l_i} eta(j, i)
// with, for a pair (hi, lo) of labels l_hi > l_lo,
//   ds = s_hi - s_lo, delta = (gain_hi - gain_lo) |disc_hi - disc_lo| inv_q
//   (divided by 0.01 + |ds| under lambdamart_norm when the query's scores
//   are not all equal), p = 2 / (1 + exp(clip(2 sigmoid ds, -60, 60))),
//   t = delta p, eta = 2 delta p (2 - p): hi adds -t, lo adds +t,
// where p is taken as 2 e_lo / (e_lo + e_hi), e = exp(2 sigmoid (s -
// centre)) once a document, when |2 sigmoid ds| < 60 and the query's
// scores span at most FACTOR_RANGE (ops/rank.py), so no exp runs a pair,
// disc = 1 / log2(2 + rank) from a table the wrapper gives (`disc_tab`),
// and rank the position in a stable descending order of the query's
// scores: rank_i = #{j: s_j > s_i} + #{j < i: s_j == s_i}.  Each row is
// then multiplied by its weight when the data has weights.
//
// What bounds it on an H100: operations.  Its bytes are a score, label,
// gain and the two outputs a row (~45 MB at the MS-LTR shape, 2.27M rows:
// 0.014 ms at 3.35 TB/s), while each unordered pair of documents with
// different labels takes a float64 exp and two float64 divisions (about
// 149M such pairs at that shape).
//
// The design (ops/rank.py's module docstring states the order, and
// `replay_sums` replays it):
// - Each unordered pair with different labels is evaluated once.  The
//   wrapper's static plan sorts each query's rows by label (`perm`) and
//   places them at the end of whole bands of 256 positions; a pair of
//   positions x > y then has l_x >= l_y, so the lower triangle of tile
//   pairs (32 x 32 documents) holds every pair once, hi in the row.  A
//   tile pair whose documents share one label is skipped; only tile pairs
//   that hold padding, equal labels or the diagonal mask lanes.
// - A block takes a band pair and lists its tile pairs that are not
//   skipped; warp w takes list entries w, w + 8, ... (balanced however the
//   labels fall).  In a tile pair lane r holds row r; in a step it meets
//   column (r + k) mod 32, and the column sums pass round the lanes by
//   shuffles.  A tile pair's row and column sums go into the warp's own
//   float64 sums a position in shared memory, which only lane p mod 32 of
//   that warp touches; the warps' sums are added in warp order at the end.
//   No float atomics: a repeat launch gives the same bits.
// - A query of at most 256 documents is one block (ranks counted in it).
//   A larger query is split: PREP blocks count a band's ranks, PAIR blocks
//   take its band pairs and write float64 partials to the scratch, FIN
//   blocks sum a band's partials in a fixed order and round once.  Blocks
//   take items by ticket in the plan's order (PREP, PAIR, whole queries,
//   FIN), so a PAIR block waits only on PREP blocks that have started,
//   and a FIN block on PAIR blocks: one launch, whatever the query sizes.
// - The build's -fmad=false keeps every product its own rounding, as in
//   PyTorch, so a pair's terms are the plain version's bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;                // documents a tile: a warp's lanes
constexpr int kTiles = 8;                // tiles a band: warps a block
constexpr int kBand = kTile * kTiles;    // ops/rank.py BAND_DOCS
constexpr int kThreads = kBand;
enum { kWhole = 0, kPrep = 1, kPair = 2, kFin = 3 };
// the launch's sync words: ticket, PREP done, PAIR done, blocks done
enum { kTicket = 0, kPrepDone = 1, kPairDone = 2, kBlocksDone = 3 };
// polls of a counter (about 200 ns each) before a waiting block traps
constexpr int64_t kSpinLimit = int64_t(1) << 27;

// one band's documents by position: score (as float, for ranks, and as
// double), gain, discount, label (-1: padding) and row (within the query)
struct Band {
  double s[kBand];
  double g[kBand];
  double d[kBand];
  double e[kBand];  // exp(coef (s - centre)) when the query is factored
  float sf[kBand];
  int l[kBand];
  int o[kBand];
};

struct Shared {
  Band rows, cols;
  int lo[2][kTiles], hi[2][kTiles];
  int tp[kTiles * kTiles];       // the band pair's tile pairs: a * 8 + b
  float red[2][kThreads / 32];
  int ticket;
  int scaled;
  int factored;
  int npairs;
  double p_hi, p_lo;             // p at x = 60 and x = -60
};

// ops/rank.py FACTOR_RANGE: the widest 2 sigmoid (max s - min s) whose
// per-document exponentials stay normal float64 numbers
constexpr double kFactorRange = 1200.0;

// the pair's terms, hi in the row, in ops/rank.py pair_terms's order: p
// factored from the documents' exponentials (er, ec) or direct
template <bool kFactored>
__device__ __forceinline__ void pair_term(double sr, double gr, double dr,
                                          double er, double sc, double gc,
                                          double dc, double ec, double inv,
                                          double coef, bool scaled,
                                          double p_hi, double p_lo,
                                          double& t, double& eta) {
  const double ds = sr - sc;
  const double dg = gr - gc;
  double delta = dg * fabs(dr - dc) * inv;
  if (scaled) delta = delta / (0.01 + fabs(ds));
  const double x = coef * ds;
  double p;
  if (kFactored)
    p = fabs(x) < 60.0 ? 2.0 * ec / (ec + er) : (x > 0.0 ? p_hi : p_lo);
  else
    p = 2.0 / (1.0 + exp(fmin(fmax(x, -60.0), 60.0)));
  t = delta * p;
  eta = 2.0 * delta * p * (2.0 - p);
}

// tile pair (the lane's row, column tile b of `cols`) for one warp: 32
// steps, lane `lane` meeting column (lane + k) mod 32; the row's sums and
// column `lane`'s, each from 0.0, come back in rg/rh and cg/ch
template <bool kMask, bool kFactored>
__device__ __forceinline__ void tile_pair(const Band& cols, int b, bool diag,
                                          double sr, double gr, double dr,
                                          double er, int lr, double inv,
                                          double coef, bool scaled,
                                          double p_hi, double p_lo,
                                          double& rg, double& rh,
                                          double& cg, double& ch) {
  const int lane = threadIdx.x & 31;
  const int base = b * kTile;
  rg = rh = cg = ch = 0.0;
  const int src = (lane + 1) & 31;
#pragma unroll 1
  for (int k = 0; k < kTile; ++k) {
    const int c = (lane + k) & 31;
    const int j = base + c;
    double t, eta;
    pair_term<kFactored>(sr, gr, dr, er, cols.s[j], cols.g[j], cols.d[j],
                         cols.e[j], inv, coef, scaled, p_hi, p_lo, t, eta);
    if (kMask) {
      const int lc = cols.l[j];
      const bool on = lr >= 0 && lc >= 0 && lr != lc && (!diag || lane > c);
      t = on ? t : 0.0;
      eta = on ? eta : 0.0;
    }
    rg = rg - t;
    rh = rh + eta;
    cg = cg + t;
    ch = ch + eta;
    cg = __shfl_sync(0xffffffffu, cg, src);
    ch = __shfl_sync(0xffffffffu, ch, src);
  }
}

// each tile's least and largest label over its documents (`side` 0: rows,
// 1: columns); an empty tile gets lo > hi
__device__ void tile_labels(const Band& band, Shared& sh, int side) {
  const int tid = threadIdx.x;
  const int l = band.l[tid];
  int lo = l >= 0 ? l : 0x7fffffff, hi = l;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if ((tid & 31) == 0) {
    sh.lo[side][tid >> 5] = lo;
    sh.hi[side][tid >> 5] = hi;
  }
}

// a band pair (ops/rank.py's docstring, step 4): its tile pairs not
// skipped, listed by thread 0 (a ascending, then b), then warp w's share
// of them into its sums acc_g/acc_h + w * accw (zero on entry): rows at
// position a * 32 + lane, columns at off + b * 32 + lane
__device__ void band_pair(Shared& sh, bool same, double inv, double coef,
                          double* acc_g, double* acc_h, int accw) {
  const int tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31;
  const int cs = same ? 0 : 1;
  if (tid == 0) {
    int n = 0;
    for (int a = 0; a < kTiles; ++a) {
      const int rlo = sh.lo[0][a], rhi = sh.hi[0][a];
      if (rlo > rhi) continue;
      for (int b = 0; b <= (same ? a : kTiles - 1); ++b) {
        const int clo = sh.lo[cs][b], chi = sh.hi[cs][b];
        // skipped: an empty tile, or one label over both tiles
        if (clo <= chi && clo != rhi) sh.tp[n++] = a * kTiles + b;
      }
    }
    sh.npairs = n;
  }
  __syncthreads();
  const Band& rows = sh.rows;
  const Band& cols = same ? sh.rows : sh.cols;
  const int off = same ? 0 : kBand;
  const bool scaled = sh.scaled != 0;
  double* ag = acc_g + w * accw;
  double* ah = acc_h + w * accw;
  for (int i = w; i < sh.npairs; i += kTiles) {
    const int a = sh.tp[i] / kTiles, b = sh.tp[i] % kTiles;
    const int ri = a * kTile + lane;
    const double sr = rows.s[ri], gr = rows.g[ri], dr = rows.d[ri];
    const double er = rows.e[ri];
    const int lr = rows.l[ri];
    const bool diag = same && a == b;
    // a tile is full when its first position holds a document
    const bool full = rows.l[a * kTile] >= 0 && cols.l[b * kTile] >= 0;
    const bool mask = diag || !full || sh.hi[cs][b] == sh.lo[0][a];
    double rg, rh, cg, ch;
#define LTT_TILE_PAIR(M, F)                                                \
  tile_pair<M, F>(cols, b, diag, sr, gr, dr, er, lr, inv, coef, scaled,    \
                  sh.p_hi, sh.p_lo, rg, rh, cg, ch)
    if (sh.factored) {
      if (mask) LTT_TILE_PAIR(true, true);
      else LTT_TILE_PAIR(false, true);
    } else {
      if (mask) LTT_TILE_PAIR(true, false);
      else LTT_TILE_PAIR(false, false);
    }
#undef LTT_TILE_PAIR
    // lane `lane` alone touches these positions of the warp's sums
    ag[ri] += rg;
    ah[ri] += rh;
    ag[off + b * kTile + lane] += cg;
    ah[off + b * kTile + lane] += ch;
  }
  __syncthreads();
}

// position p's sum over the warps' sums, in warp order, from 0.0
__device__ __forceinline__ double warp_total(const double* acc, int accw,
                                             int p) {
  double v = 0.0;
  for (int w = 0; w < kTiles; ++w) v = v + acc[w * accw + p];
  return v;
}

// stage positions [pos0, pos0 + 256) of a query whose sorted rows start at
// perm + start after `pad` positions of padding; discounts come later
__device__ void stage(Band& band, const float* score, const float* gain,
                      const int32_t* label, const int32_t* perm,
                      int64_t start, int64_t pos0, int64_t pad) {
  const int tid = threadIdx.x;
  const int64_t p = pos0 + tid;
  if (p >= pad) {
    const int32_t row = perm[start + p - pad];
    const float s = score[row];
    band.sf[tid] = s;
    band.s[tid] = (double)s;
    band.g[tid] = (double)gain[row];
    band.l[tid] = label[row];
    band.o[tid] = (int)(row - start);
  } else {
    band.sf[tid] = -INFINITY;
    band.e[tid] = 1.0;
    band.s[tid] = 0.0;
    band.g[tid] = 0.0;
    band.d[tid] = 0.0;
    band.l[tid] = -1;
    band.o[tid] = 0x7fffffff;
  }
}

// the block's least and largest score over its band's documents
__device__ void band_range(Shared& sh, const Band& band, float& lo,
                           float& hi) {
  const int tid = threadIdx.x;
  const bool on = band.l[tid] >= 0;
  lo = on ? band.sf[tid] : INFINITY;
  hi = on ? band.sf[tid] : -INFINITY;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if ((tid & 31) == 0) {
    sh.red[0][tid >> 5] = lo;
    sh.red[1][tid >> 5] = hi;
  }
  __syncthreads();
  lo = sh.red[0][0];
  hi = sh.red[1][0];
  for (int w = 1; w < kThreads / 32; ++w) {
    lo = fminf(lo, sh.red[0][w]);
    hi = fmaxf(hi, sh.red[1][w]);
  }
}

// the query's score range -> lambdamart_norm's test, whether p is factored,
// and the documents' exponentials about the range's centre (thread 0
// writes the flags; every thread its position of `band`, and of `other`)
__device__ void exponentials(Shared& sh, float lo, float hi, int norm,
                             double coef, Band& band, Band* other) {
  const int tid = threadIdx.x;
  const double dlo = (double)lo, dhi = (double)hi;
  const bool factored = coef * (dhi - dlo) <= kFactorRange;
  const double centre = (dhi + dlo) * 0.5;
  if (tid == 0) {
    sh.scaled = norm && hi != lo;
    sh.factored = factored;
    sh.p_hi = 2.0 / (1.0 + exp(60.0));
    sh.p_lo = 2.0 / (1.0 + exp(-60.0));
  }
  if (factored) {
    if (band.l[tid] >= 0) band.e[tid] = exp(coef * (band.s[tid] - centre));
    if (other != nullptr && other->l[tid] >= 0)
      other->e[tid] = exp(coef * (other->s[tid] - centre));
  }
}

__device__ void wait_for(const int32_t* word, int target) {
  if (threadIdx.x == 0) {
    const volatile int32_t* v = word;
    for (int64_t polls = 0; *v < target; ++polls) {
      if (polls == kSpinLimit) __trap();
      __nanosleep(200);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ void finish(float* grad, float* hess, const float* weight,
                       int32_t row, double g, double h) {
  float gf = (float)g, hf = (float)h;
  if (weight != nullptr) {
    const float w = weight[row];
    gf = gf * w;
    hf = hf * w;
  }
  grad[row] = gf;
  hess[row] = hf;
}

__global__ void __launch_bounds__(kThreads)
    lambda_kernel(const float* __restrict__ score,
                  const int32_t* __restrict__ label,
                  const float* __restrict__ gain,
                  const int32_t* __restrict__ perm,
                  const int64_t* __restrict__ qb,
                  const int32_t* __restrict__ items,
                  const int64_t* __restrict__ qtab,
                  const int64_t* __restrict__ soff,
                  const int32_t* __restrict__ band_item,
                  const float* __restrict__ inv_max,
                  const double* __restrict__ disc_tab,
                  const float* __restrict__ weight, double coef, int norm,
                  int n_prep, int n_pair, int accw, double* scratch,
                  int32_t* sync, float* __restrict__ grad,
                  float* __restrict__ hess) {
  __shared__ Shared sh;
  // the warps' float64 sums: g then h, kTiles x accw each
  extern __shared__ double acc[];
  double* acc_g = acc;
  double* acc_h = acc + kTiles * accw;
  const int tid = threadIdx.x;
  // with no split query no block waits: the block's index is its item
  const bool ordered = n_prep > 0;
  if (ordered) {
    if (tid == 0) sh.ticket = atomicAdd(sync + kTicket, 1);
    __syncthreads();
  }
  const int it = ordered ? sh.ticket : (int)blockIdx.x;
  const int kind = items[4 * it], q = items[4 * it + 1];
  const int R = items[4 * it + 2], C = items[4 * it + 3];
  const int64_t start = qb[q];
  const int64_t m = qb[q + 1] - start;
  const int64_t nb = kind == kWhole ? 1 : qtab[3 * q + 2];
  const int64_t pad = nb * kBand - m;
  const double inv = (double)inv_max[q];
  double* disc_s = kind == kWhole ? nullptr : scratch + qtab[3 * q];
  double* range_s = kind == kWhole ? nullptr : disc_s + nb * kBand;

  if (kind == kWhole || kind == kPair)
    for (int i = tid; i < 2 * kTiles * accw; i += kThreads) acc[i] = 0.0;
  if (kind == kWhole) {
    stage(sh.rows, score, gain, label, perm, start, 0, pad);
    __syncthreads();
    float lo, hi;
    band_range(sh, sh.rows, lo, hi);
    if (sh.rows.l[tid] >= 0) {
      const float si = sh.rows.sf[tid];
      const int oi = sh.rows.o[tid];
      int r = 0;
      for (int j = (int)pad; j < kBand; ++j) {
        const float sj = sh.rows.sf[j];
        r += (sj > si) | ((sj == si) & (sh.rows.o[j] < oi));
      }
      sh.rows.d[tid] = disc_tab[r];
    }
    tile_labels(sh.rows, sh, 0);
    exponentials(sh, lo, hi, norm, coef, sh.rows, nullptr);
    __syncthreads();
    band_pair(sh, true, inv, coef, acc_g, acc_h, accw);
    if (sh.rows.l[tid] >= 0)
      finish(grad, hess, weight, (int32_t)start + sh.rows.o[tid],
             warp_total(acc_g, accw, tid), warp_total(acc_h, accw, tid));
  } else if (kind == kPrep) {
    // band R's ranks, counted over the query in chunks of 256 scores
    stage(sh.rows, score, gain, label, perm, start, (int64_t)R * kBand,
          pad);
    const bool on = sh.rows.l[tid] >= 0;
    const float si = sh.rows.sf[tid];
    const int oi = sh.rows.o[tid];
    float* chunk = sh.cols.sf;
    int r = 0;
    for (int64_t c0 = 0; c0 < m; c0 += kBand) {
      __syncthreads();
      if (c0 + tid < m) chunk[tid] = score[start + c0 + tid];
      __syncthreads();
      const int n = (int)(m - c0 < kBand ? m - c0 : kBand);
      for (int j = 0; j < n; ++j) {
        const float sj = chunk[j];
        r += (sj > si) | ((sj == si) & (c0 + j < oi));
      }
    }
    if (on) disc_s[(int64_t)R * kBand + tid] = disc_tab[r];
    float lo, hi;
    band_range(sh, sh.rows, lo, hi);
    if (tid == 0) {
      range_s[2 * R] = (double)lo;
      range_s[2 * R + 1] = (double)hi;
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicAdd(sync + kPrepDone, 1);
  } else if (kind == kPair) {
    wait_for(sync + kPrepDone, n_prep);
    const bool same = R == C;
    stage(sh.rows, score, gain, label, perm, start, (int64_t)R * kBand, pad);
    if (sh.rows.l[tid] >= 0)
      sh.rows.d[tid] = __ldcg(disc_s + (int64_t)R * kBand + tid);
    if (!same) {
      stage(sh.cols, score, gain, label, perm, start, (int64_t)C * kBand,
            pad);
      if (sh.cols.l[tid] >= 0)
        sh.cols.d[tid] = __ldcg(disc_s + (int64_t)C * kBand + tid);
    }
    // the query's range over its bands' (every thread reads them)
    float lo = INFINITY, hi = -INFINITY;
    for (int64_t x = 0; x < nb; ++x) {
      lo = fminf(lo, (float)__ldcg(range_s + 2 * x));
      hi = fmaxf(hi, (float)__ldcg(range_s + 2 * x + 1));
    }
    __syncthreads();
    tile_labels(sh.rows, sh, 0);
    if (!same) tile_labels(sh.cols, sh, 1);
    exponentials(sh, lo, hi, norm, coef, sh.rows, same ? nullptr : &sh.cols);
    __syncthreads();
    band_pair(sh, same, inv, coef, acc_g, acc_h, accw);
    // band R's positions; band C's after them when the bands differ
    double* slot = scratch + soff[it];
    slot[tid] = warp_total(acc_g, accw, tid);
    slot[kBand + tid] = warp_total(acc_h, accw, tid);
    if (!same) {
      slot[2 * kBand + tid] = warp_total(acc_g, accw, kBand + tid);
      slot[3 * kBand + tid] = warp_total(acc_h, accw, kBand + tid);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicAdd(sync + kPairDone, 1);
  } else {
    // FIN: band R's sums over the band pairs (R, 0..R), (R+1.., R)
    wait_for(sync + kPairDone, n_pair);
    const int64_t p = (int64_t)R * kBand + tid;
    if (p >= pad) {
      const int32_t* tab = band_item + qtab[3 * q + 1];
      double g = 0.0, h = 0.0;
      for (int64_t c = 0; c <= R; ++c) {
        const int32_t j = tab[R * nb + c];
        if (j < 0) continue;
        const double* slot = scratch + soff[j];
        g = g + __ldcg(slot + tid);
        h = h + __ldcg(slot + kBand + tid);
      }
      for (int64_t r = R + 1; r < nb; ++r) {
        const int32_t j = tab[r * nb + R];
        if (j < 0) continue;
        const double* slot = scratch + soff[j];
        g = g + __ldcg(slot + 2 * kBand + tid);
        h = h + __ldcg(slot + 3 * kBand + tid);
      }
      finish(grad, hess, weight, perm[start + p - pad], g, h);
    }
  }
  if (ordered) {
    __syncthreads();
    if (tid == 0 && atomicAdd(sync + kBlocksDone, 1) == (int)gridDim.x - 1) {
      // every block has taken its ticket and passed its waits
      sync[kTicket] = 0;
      sync[kPrepDone] = 0;
      sync[kPairDone] = 0;
      sync[kBlocksDone] = 0;
    }
  }
}

}  // namespace

// score, gain, grad, hess, weight (or null): (n,) float32; label, perm:
// (n,) int32; qb (nq + 1,) int64; items (n_items, 4) int32; qtab (nq, 3)
// int64; soff (n_items,) int64; band_item int32; inv_max (nq,) float32;
// disc_tab (max docs,) float64; scratch float64 (null without a split
// query); sync: 4 int32 words, zero between launches (ops/rank.py's plan
// and sync_words).  `band` must be kBand, the plan's band; `accw` the
// positions of a warp's sums: kBand, or 2 kBand when a PAIR item takes two
// bands (its dynamic shared memory is 128 accw bytes).
extern "C" int ltt_lambdarank(const void* score, const void* label,
                              const void* gain, const void* perm,
                              const void* qb, const void* items, int n_items,
                              const void* qtab, const void* soff,
                              const void* band_item, const void* inv_max,
                              const void* disc_tab, const void* weight,
                              double coef, int norm, int n_prep, int n_pair,
                              int band, int accw, void* scratch, void* sync,
                              void* grad, void* hess, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n_items < 1 || band != kBand || n_prep < 0 || n_pair < 0 ||
      (accw != kBand && accw != 2 * kBand) ||
      (n_prep > 0 && (scratch == nullptr || sync == nullptr)))
    return (int)cudaErrorInvalidValue;
  // the opt-in above 48 KB of shared memory, raised once to what a launch
  // asks (a plain host attribute: no stream work, so a capture may see it)
  static int opted[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const int smem = 2 * kTiles * accw * (int)sizeof(double);
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem > opted[dev]) {
    e = cudaFuncSetAttribute(lambda_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    opted[dev] = smem;
  }
  lambda_kernel<<<n_items, kThreads, smem, stream>>>(
      (const float*)score, (const int32_t*)label, (const float*)gain,
      (const int32_t*)perm, (const int64_t*)qb, (const int32_t*)items,
      (const int64_t*)qtab, (const int64_t*)soff,
      (const int32_t*)band_item, (const float*)inv_max,
      (const double*)disc_tab, (const float*)weight, coef, norm, n_prep,
      n_pair, accw, (double*)scratch, (int32_t*)sync, (float*)grad,
      (float*)hess);
  return (int)cudaGetLastError();
}
