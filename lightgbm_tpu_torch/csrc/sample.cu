// Kernel B: the row-sampling step of bagging, GOSS and MVS.
//
// It replaces no TPU kernel: the JAX package draws its sampling masks in
// XLA, not in Pallas (`_draw_bag_mask_impl`,
// lightgbm_tpu/models/gbdt.py:1110; `GOSS._goss_mask_impl` and
// `MVS._mvs_mask_impl`, lightgbm_tpu/models/boosting.py:78, :162).  Each
// draw is `jax.random.uniform(key, (N,))`, a 20-round Threefry-2x32 a row,
// and GOSS and MVS first compute a threshold over all rows: as PyTorch
// tensor ops (the plain versions in ops/sample.py) the draw is about 160
// int64 passes over the rows, GOSS's threshold a full sort for one order
// statistic and MVS's a sort and a 16-ary chunked scan of ~90 small
// launches.  Here the step is a few launches:
//
//   draw      `sample_kernel`: every mode's (N,) float32 weight a row
//   GOSS      `goss_select_kernel` x 3, then the draw
//   MVS       `mvs_scores_kernel`, PyTorch's sort, `scan_up_kernel`,
//             `scan_down_kernel`, then the draw (which computes mu)
//   K > 1     `class_sum_kernel` first: with K classes (a multiclass
//             objective) the JAX package's GOSS and MVS read
//             gh = sum_k |g[k] * h[k]| over the (K, N) gradients
//             (`jnp.sum(jnp.abs(grad * hess), axis=0)`, boosting.py:82,
//             :165).  GOSS's select and draw then read gh, written once;
//             for MVS the same launch writes the scores of gh instead,
//             in place of `mvs_scores_kernel`.  The sum is sequential in
//             k from class 0, the order of the JAX package's CPU reduce
//             over the leading axis, each |g * h| rounded before its add.
//
// The weights (0 = out of the sample):
//
//   bagging      w = u < frac                     (u of the tree's key)
//   stratified   w = u < (label > 0 ? pos : neg)
//   GOSS         w = 1 where gh > thr, or gh == thr and u_t < p_tie,
//                else amp where u < rest, else 0
//   MVS          p = min(s / max(mu, 1e-35), 1); w = u < p ? 1 / max(p,
//                1e-35) : 0
//
// u is `jax.random.uniform`'s float of row i: the bits o0 ^ o1 of
// threefry_2x32(key, (0, i)), then (bits >> 9) | 0x3F800000 as a float,
// minus 1.  Keys, thresholds and counts live in device memory, so a CUDA
// graph of a tree's head replays the whole step.  The build has no
// fast-math flag and -fmad=false: divisions and square roots are IEEE and
// no multiply-add is contracted, so every output is the plain version's
// bits.
//
// GOSS's threshold: the `top_k`-th largest |g * h| (NaN ranks below every
// number, as `-sort(-gh)` puts it last), the rows above it (`n_gt`) and at
// it (`n_tie`).  An exact radix select over the values' order-preserving
// 32-bit keys: three passes of 11, 11 and 10 bits, each a histogram of the
// digit among the rows whose higher digits are the ones chosen so far.
// The last block of a pass to finish (a completion counter, no grid-wide
// sync) picks the digit that holds the k-th row, and after the third pass
// writes thr, n_gt, n_tie and p_tie = clip((top_k - n_gt) / n_tie, 0, 1).
//
// MVS's threshold: over the scores sorted ascending (x below, the plain
// version's descending order reversed), the inclusive prefix sums P of x
// in the order of XLA's CPU cumsum: sequential within chunks of 16, the
// chunk totals summed the same way one level up until one chunk is left,
// and every chunk after the first offset by the prefix of the totals
// before it.  A value is inner_0 + (inner_1 + (inner_2 + ...)).  The
// up-sweep gives each block of 4096 values (256 chunks, 16 chunk totals, 1
// total: aligned with the hierarchy) its totals at levels 1-3, and its
// last block the levels above and their prefixes.  The down-sweep adds the
// prefixes back down in the same order and, for row i of the descending
// order (x's element n - 1 - i), evaluates est = i + P / max(s, 1e-35):
// the first i with est > target is an atomicMin of (i << 32 | P's bits).
// The draw's blocks then read mu = P / max(target - i, 1e-10), or the
// smallest score if no i passes, or NaN if a score is NaN.
//
// What bounds it on an H100.  The draw: its integer instructions, not its
// bytes.  The bagging draw's loop body is 78 SASS instructions a row, 50
// of them on the integer ALU (20 rounds of add, funnel-shift rotate and
// xor), which issues 64 lanes an SM a clock: 10.5M rows take 0.031 ms at
// 1980 MHz, where their 42 MB of weights take 0.013 ms at 3.35 TB/s.  A
// thread draws one row a step, GOSS four side by side (every row draws
// the rest's uniform; a row at the threshold draws the tie key's too, a
// divergent branch).  The thresholds: bytes.  The select reads the 42 MB
// of |g * h| three times at 10.5M rows, the scan reads the sorted scores
// twice.  The class sum: bytes, 2 K N float32 values read and N written
// (44 MB at K = 5, N = 1M: 0.013 ms at 3.35 TB/s); a thread a row, the
// K rows' loads of a class coalesced across the warp.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum Mode { kBag = 0, kStratified = 1, kGoss = 2, kMvs = 3, kMvsStep = 4 };

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// o0 ^ o1 of Threefry-2x32 (20 rounds) of the counters (0, x1)
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = k0;
  x1 += k1;
#define LTT_ROUND(r) \
  x0 += x1;          \
  x1 = rotl(x1, r) ^ x0;
  LTT_ROUND(13) LTT_ROUND(15) LTT_ROUND(26) LTT_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  LTT_ROUND(17) LTT_ROUND(29) LTT_ROUND(16) LTT_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  LTT_ROUND(13) LTT_ROUND(15) LTT_ROUND(26) LTT_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  LTT_ROUND(17) LTT_ROUND(29) LTT_ROUND(16) LTT_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  LTT_ROUND(13) LTT_ROUND(15) LTT_ROUND(26) LTT_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
#undef LTT_ROUND
  return x0 ^ x1;
}

__device__ __forceinline__ float uniform(uint32_t k0, uint32_t k1,
                                         uint32_t row) {
  return __uint_as_float((threefry_bits(k0, k1, row) >> 9) | 0x3F800000u) -
         1.0f;
}

// jnp.maximum / jnp.minimum against a constant: a NaN operand stays NaN
__device__ __forceinline__ float max_nan(float a, float c) {
  return (a != a || a > c) ? a : c;
}
__device__ __forceinline__ float min_nan(float a, float c) {
  return (a != a || a < c) ? a : c;
}

// MVS's mu from the scan's result (see the header): `packed` the first i
// with est > target and its suffix sum, ~0 if none; `x` the scores sorted
// ascending
__device__ __forceinline__ float mvs_mu(const unsigned long long* packed,
                                        const float* x, int64_t n,
                                        float target) {
  const float last = x[n - 1];
  if (last != last) return last;             // a NaN score: every sum is NaN
  const unsigned long long pk = *packed;
  if (pk == ~0ull) return x[0];              // no i passes: the smallest
  const uint32_t i = (uint32_t)(pk >> 32);
  return __uint_as_float((uint32_t)pk) / max_nan(target - (float)i, 1e-10f);
}

// one row's weight; `in_v` its label byte (stratified), gh (GOSS) or s
// (MVS); s0 / s1 the mode's device scalars (GOSS's thr and p_tie, MVS's
// max(mu, 1e-35)), c0 / c1 its constants, b0 / b1 GOSS's tie key
template <int M>
__device__ __forceinline__ float weight(uint32_t row, float in_v, uint32_t a0,
                                        uint32_t a1, uint32_t b0, uint32_t b1,
                                        float s0, float s1, float c0,
                                        float c1) {
  if (M == kBag) return uniform(a0, a1, row) < c0 ? 1.0f : 0.0f;
  if (M == kStratified)
    return uniform(a0, a1, row) < (in_v != 0.0f ? c0 : c1) ? 1.0f : 0.0f;
  if (M == kGoss) {
    bool top = in_v > s0;
    if (!top && in_v == s0) top = uniform(b0, b1, row) < s1;
    // the rest's draw for every row, so that a thread's rows draw side
    // by side (a warp draws for a row of its lanes unless all are top)
    const float u = uniform(a0, a1, row);
    return top ? 1.0f : (u < c0 ? c1 : 0.0f);
  }
  const float p = min_nan(in_v / s0, 1.0f);
  return uniform(a0, a1, row) < p ? 1.0f / max_nan(p, 1e-35f) : 0.0f;
}

// R rows a thread a step of the grid-stride loop, rows i, i + stride, ...:
// their loads issued together, then their draws side by side
template <int M, int R>
__global__ void __launch_bounds__(kThreads)
sample_kernel(const int64_t* __restrict__ words, const void* __restrict__ in,
              const void* __restrict__ sc0, const void* __restrict__ sc1,
              float c0, float c1, float* __restrict__ w, int64_t n,
              float* __restrict__ aux) {
  const uint32_t a0 = (uint32_t)words[0], a1 = (uint32_t)words[1];
  uint32_t b0 = 0, b1 = 0;
  float s0 = 0.0f, s1 = 0.0f;
  if (M == kGoss) {
    b0 = (uint32_t)words[2];
    b1 = (uint32_t)words[3];
    s0 = *static_cast<const float*>(sc0);    // thr
    s1 = *static_cast<const float*>(sc1);    // p_tie
  }
  if (M == kMvs) s0 = max_nan(*static_cast<const float*>(sc0), 1e-35f);
  if (M == kMvsStep) {
    // the scan's tail, in every block: mu, written once for the caller
    const float mu = mvs_mu(static_cast<const unsigned long long*>(sc0),
                            static_cast<const float*>(sc1), n, c0);
    if (blockIdx.x == 0 && threadIdx.x == 0) *aux = mu;
    s0 = max_nan(mu, 1e-35f);
  }
  constexpr int Mw = M == kMvsStep ? kMvs : M;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i0 = (int64_t)blockIdx.x * kThreads + threadIdx.x; i0 < n;
       i0 += R * stride) {
    float v[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int64_t i = i0 + u * stride;
      v[u] = 0.0f;
      if (i < n) {
        if (M == kStratified) v[u] = static_cast<const uint8_t*>(in)[i];
        else if (M != kBag) v[u] = static_cast<const float*>(in)[i];
      }
    }
    float out[R];
#pragma unroll
    for (int u = 0; u < R; ++u)
      out[u] = weight<Mw>((uint32_t)(i0 + u * stride), v[u], a0, a1, b0, b1,
                          s0, s1, c0, c1);
#pragma unroll
    for (int u = 0; u < R; ++u)
      if (i0 + u * stride < n) w[i0 + u * stride] = out[u];
  }
}

// ---- GOSS: the radix select -------------------------------------------

constexpr int kSelThreads = 512;
constexpr int kSelBins = 2048;
// state words after the three histograms (2048, 2048 and 1024 bins)
constexpr int kSelHist[3] = {0, 2048, 4096};
constexpr int kSelDone = 5120;   // 3 completion counters
constexpr int kSelPrefix = 5123, kSelLeft = 5124, kSelAbove = 5125;
constexpr int kSelNan = 5126;    // ~(the first NaN row), 0 if none
constexpr int kSelWords = 5128;

__host__ __device__ constexpr int sel_shift(int p) {
  return p == 0 ? 21 : (p == 1 ? 10 : 0);
}
__host__ __device__ constexpr int sel_bits(int p) { return p == 2 ? 10 : 11; }

// an order-preserving key: larger values have larger keys, -0 is +0's key,
// and NaN (any sign) is key 0, below every number
__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t b = __float_as_uint(x);
  if (x != x) return 0u;
  if (b == 0x80000000u) return 0x80000000u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float(k >= 0x80000000u ? (k & 0x7FFFFFFFu) : ~k);
}

// one select pass: the histogram of digit P among the rows whose higher
// digits are the prefix chosen so far; the last block to finish picks the
// digit that holds the k-th largest row and, after pass 2, writes the
// outputs
template <int P>
__global__ void __launch_bounds__(kSelThreads)
goss_select_kernel(const float* __restrict__ gh, int64_t n, int64_t top_k,
                   uint32_t* __restrict__ st, float* __restrict__ thr_out,
                   float* __restrict__ ptie_out,
                   int64_t* __restrict__ counts_out) {
  constexpr int kShift = sel_shift(P), kBits = sel_bits(P);
  constexpr int kBins = 1 << kBits;
  __shared__ uint32_t h[kSelBins];
  __shared__ uint32_t warp_sum[kSelThreads / 32];
  __shared__ int pick;
  __shared__ uint32_t pick_above;
  __shared__ bool last;
  // pass 0: ~(the block's first NaN row), 0 if it has none
  __shared__ uint32_t first_nan;
  const int tid = threadIdx.x;
  for (int d = tid; d < kBins; d += kSelThreads) h[d] = 0;
  if (tid == 0) first_nan = 0u;
  const uint32_t prefix = P == 0 ? 0u : st[kSelPrefix];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * kSelThreads;
  for (int64_t i0 = (int64_t)blockIdx.x * kSelThreads + tid; i0 < n;
       i0 += 4 * stride) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int64_t i = i0 + u * stride;
      v[u] = i < n ? gh[i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (i0 + u * stride >= n) break;
      const uint32_t k = order_key(v[u]);
      if (P == 0 && k == 0u)
        atomicMax(&first_nan, ~(uint32_t)(i0 + u * stride));
      if (P == 0 || (k >> (kShift + kBits)) == prefix)
        atomicAdd(&h[(k >> kShift) & (kBins - 1)], 1u);
    }
  }
  __syncthreads();
  if (P == 0 && tid == 0 && first_nan) atomicMax(&st[kSelNan], first_nan);
  uint32_t* g = st + kSelHist[P];
  for (int d = tid; d < kBins; d += kSelThreads)
    if (h[d]) atomicAdd(&g[d], h[d]);
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(&st[kSelDone + P], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: the whole histogram, each thread a run of bins
  constexpr int kPer = kBins / kSelThreads;
  uint32_t own = 0;
  for (int e = 0; e < kPer; ++e) {
    h[tid * kPer + e] = __ldcg(&g[tid * kPer + e]);
    own += h[tid * kPer + e];
  }
  // the rows in higher bins than this thread's: a suffix sum over threads
  const int lane = tid & 31, warp = tid >> 5;
  uint32_t incl = own;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += y;
  }
  if (lane == 0) warp_sum[warp] = incl;
  __syncthreads();
  for (int w2 = warp + 1; w2 < kSelThreads / 32; ++w2) incl += warp_sum[w2];
  const uint32_t left = P == 0 ? (uint32_t)top_k : st[kSelLeft];
  uint32_t above = incl - own;
  if (above < left && left <= incl) {
    for (int e = kPer - 1; e >= 0; --e) {
      const uint32_t c = h[tid * kPer + e];
      if (above + c >= left) {
        pick = tid * kPer + e;
        pick_above = above;
        break;
      }
      above += c;
    }
  }
  __syncthreads();
  if (tid != 0) return;
  const uint32_t ngt = (P == 0 ? 0u : st[kSelAbove]) + pick_above;
  const uint32_t key = (prefix << kBits) | (uint32_t)pick;
  if (P < 2) {
    st[kSelPrefix] = key;
    st[kSelLeft] = left - pick_above;
    st[kSelAbove] = ngt;
    return;
  }
  // the outputs: with the k-th row NaN, no row is above or at it, and
  // thr is the first NaN row's value (the same bits at every launch)
  const bool nan = key == 0u;
  const float thr = nan ? gh[~st[kSelNan]] : key_value(key);
  const int64_t n_gt = nan ? 0 : (int64_t)ngt;
  const int64_t n_tie = nan ? 1 : (int64_t)(h[pick] > 0 ? h[pick] : 1);
  const float p = (float)(top_k - n_gt) / (float)n_tie;
  *thr_out = thr;
  *ptie_out = fminf(fmaxf(p, 0.0f), 1.0f);
  counts_out[0] = n_gt;
  counts_out[1] = n_tie;
}

// ---- MVS: the scores and the scan -------------------------------------

// MVS's score of one row's gh
__device__ __forceinline__ float mvs_score(float gh, float var_weight) {
  const double g = (double)gh;
  // g * g exact in float64, one rounding of the sum there, one to float32
  // (the plain version's fma32); sqrtf is correctly rounded
  return sqrtf((float)(g * g + (double)var_weight));
}

__global__ void __launch_bounds__(kThreads)
mvs_scores_kernel(const float* __restrict__ gh, float var_weight,
                  float* __restrict__ s, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride)
    s[i] = mvs_score(gh[i], var_weight);
}

// ---- K > 1: the class sum ----------------------------------------------

// row i's gh = |g[0] h[0]| + |g[1] h[1]| + ... over the K class rows (g's
// `ldg` values apart, h's `ldh`): each product rounded, its absolute value
// added in class order (no multiply-add is contracted: the build has
// -fmad=false)
template <bool kScore>
__global__ void __launch_bounds__(kThreads)
class_sum_kernel(const float* __restrict__ g, int64_t ldg,
                 const float* __restrict__ h, int64_t ldh, int K,
                 float var_weight, float* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    float acc = fabsf(g[i] * h[i]);
    for (int k = 1; k < K; ++k)
      acc = acc + fabsf(g[k * ldg + i] * h[k * ldh + i]);
    out[i] = kScore ? mvs_score(acc, var_weight) : acc;
  }
}

constexpr int kScanThreads = 256;
constexpr int kChunk = 16;
constexpr int kTile = kScanThreads * kChunk;     // 4096 values a block
constexpr int kMaxLevels = 9;

// the hierarchy's levels: len[0] = n, len[k + 1] = ceil(len[k] / 16) until
// a level of at most 16 (the top, level `top`); the totals T_k (k >= 1)
// and the prefixes P_k (k >= 3) in the scratch, after 4 header words (the
// packed first i, the completion counter)
struct ScanLevels {
  int64_t len[kMaxLevels];
  int64_t t_off[kMaxLevels];
  int64_t p_off[kMaxLevels];
  int top;
};

__host__ __device__ inline int64_t scan_layout(int64_t n, ScanLevels* L) {
  int64_t words = 4;
  L->len[0] = n;
  int k = 0;
  while (L->len[k] > kChunk && k + 1 < kMaxLevels) {
    L->len[k + 1] = (L->len[k] + kChunk - 1) / kChunk;
    ++k;
  }
  L->top = k;
  for (int j = 1; j <= k; ++j) {
    L->t_off[j] = words;
    words += L->len[j];
  }
  for (int j = 3; j <= k; ++j) {
    L->p_off[j] = words;
    words += L->len[j];
  }
  return words;
}

__device__ __forceinline__ int pad(int p) { return p + (p >> 5); }

// the block's 4096 values, zero past n, and each thread's 16 running sums
__device__ __forceinline__ void load_tile(const float* __restrict__ x,
                                          int64_t n, int64_t base,
                                          float* xs) {
  for (int r = 0; r < kChunk; ++r) {
    const int p = threadIdx.x + kScanThreads * r;
    const int64_t j = base + p;
    xs[pad(p)] = j < n ? x[j] : 0.0f;
  }
}

// P_k(i) for k = 2 and 1: the sequential sum of T_k over i's chunk up to
// i, plus the prefix one level up at the chunk before (after the first
// chunk); level 3's prefixes are in the scratch
__device__ float prefix_2(const float* s, const ScanLevels& L, int64_t i) {
  const float* t = s + L.t_off[2];
  const int64_t c = i / kChunk;
  float acc = t[c * kChunk];
  for (int64_t j = c * kChunk + 1; j <= i; ++j) acc = acc + t[j];
  return c >= 1 ? acc + s[L.p_off[3] + c - 1] : acc;
}

__device__ float prefix_1(const float* s, const ScanLevels& L, int64_t i) {
  const float* t = s + L.t_off[1];
  const int64_t c = i / kChunk;
  float acc = t[c * kChunk];
  for (int64_t j = c * kChunk + 1; j <= i; ++j) acc = acc + t[j];
  return c >= 1 ? acc + prefix_2(s, L, c - 1) : acc;
}

__global__ void __launch_bounds__(kScanThreads)
scan_up_kernel(const float* __restrict__ x, int64_t n, float* scratch,
               ScanLevels L) {
  __shared__ float xs[kTile + kTile / 32];
  __shared__ float t1s[kScanThreads];
  __shared__ float t2s[kChunk];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  load_tile(x, n, b * kTile, xs);
  __syncthreads();
  float acc = xs[pad(kChunk * tid)];
  for (int m = 1; m < kChunk; ++m) acc = acc + xs[pad(kChunk * tid + m)];
  t1s[tid] = acc;
  if (L.top >= 1 && b * kScanThreads + tid < L.len[1])
    scratch[L.t_off[1] + b * kScanThreads + tid] = acc;
  __syncthreads();
  if (tid < kChunk) {
    float a2 = t1s[kChunk * tid];
    for (int m = 1; m < kChunk; ++m) a2 = a2 + t1s[kChunk * tid + m];
    t2s[tid] = a2;
    if (L.top >= 2 && b * kChunk + tid < L.len[2])
      scratch[L.t_off[2] + b * kChunk + tid] = a2;
  }
  __syncthreads();
  if (tid == 0 && L.top >= 3 && b < L.len[3]) {
    float a3 = t2s[0];
    for (int m = 1; m < kChunk; ++m) a3 = a3 + t2s[m];
    scratch[L.t_off[3] + b] = a3;
  }
  if (L.top < 3) return;   // one block: the down-sweep has every level
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    unsigned int* done = reinterpret_cast<unsigned int*>(scratch) + 2;
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: the totals above level 3, then the prefixes from the
  // top down to level 3 (one thread a chunk, sequential inside it)
  for (int k = 4; k <= L.top; ++k) {
    const float* lo = scratch + L.t_off[k - 1];
    for (int64_t c = tid; c < L.len[k]; c += kScanThreads) {
      float a = __ldcg(&lo[c * kChunk]);
      for (int64_t j = c * kChunk + 1;
           j < c * kChunk + kChunk && j < L.len[k - 1]; ++j)
        a = a + __ldcg(&lo[j]);
      scratch[L.t_off[k] + c] = a;
    }
    __threadfence();
    __syncthreads();
  }
  for (int k = L.top; k >= 3; --k) {
    const float* t = scratch + L.t_off[k];
    float* p = scratch + L.p_off[k];
    const int64_t chunks = (L.len[k] + kChunk - 1) / kChunk;
    for (int64_t c = tid; c < chunks; c += kScanThreads) {
      const bool off = c >= 1;
      const float up = off ? __ldcg(&scratch[L.p_off[k + 1] + c - 1]) : 0.0f;
      float a = 0.0f;
      for (int64_t j = c * kChunk; j < c * kChunk + kChunk && j < L.len[k];
           ++j) {
        const float v = __ldcg(&t[j]);
        a = j == c * kChunk ? v : a + v;
        p[j] = off ? a + up : a;
      }
    }
    __threadfence();
    __syncthreads();
  }
}

__device__ __forceinline__ unsigned long long umin64(unsigned long long a,
                                                     unsigned long long b) {
  return a < b ? a : b;
}

__global__ void __launch_bounds__(kScanThreads)
scan_down_kernel(const float* __restrict__ x, int64_t n, float target,
                 const float* __restrict__ scratch, ScanLevels L,
                 unsigned long long* __restrict__ packed) {
  __shared__ float xs[kTile + kTile / 32];
  __shared__ float t1s[kScanThreads], in1s[kScanThreads], p1s[kScanThreads];
  __shared__ float t2s[kChunk], p2s[kChunk];
  __shared__ float edge[2];     // P_2(16b - 1), P_1(256b - 1)
  __shared__ unsigned long long warp_min[kScanThreads / 32];
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  load_tile(x, n, b * kTile, xs);
  __syncthreads();
  float in0[kChunk];
  in0[0] = xs[pad(kChunk * tid)];
  for (int m = 1; m < kChunk; ++m)
    in0[m] = in0[m - 1] + xs[pad(kChunk * tid + m)];
  t1s[tid] = in0[kChunk - 1];
  if (tid == 32 && b >= 1) {
    // the previous block's last prefixes at levels 2 and 1 (b >= 1 means
    // n > 4096, so levels 1-3 exist)
    edge[0] = prefix_2(scratch, L, kChunk * b - 1);
    edge[1] = prefix_1(scratch, L, kScanThreads * b - 1);
  }
  __syncthreads();
  if (tid < kChunk) {
    float a = t1s[kChunk * tid];
    in1s[kChunk * tid] = a;
    for (int m = 1; m < kChunk; ++m) {
      a = a + t1s[kChunk * tid + m];
      in1s[kChunk * tid + m] = a;
    }
    t2s[tid] = a;
  }
  __syncthreads();
  if (tid == 0) {
    // level 2 of this block: its one chunk, offset by P_3(b - 1)
    float a = t2s[0];
    for (int m = 0; m < kChunk; ++m) {
      if (m) a = a + t2s[m];
      p2s[m] = b >= 1 ? a + scratch[L.p_off[3] + b - 1] : a;
    }
  }
  __syncthreads();
  {
    // level 1: entry 256b + tid is in level-2 chunk 16b + tid / 16
    const int q = tid / kChunk;
    const bool off = b * kChunk + q >= 1;
    const float up = q >= 1 ? p2s[q - 1] : edge[0];
    p1s[tid] = off ? in1s[tid] + up : in1s[tid];
  }
  __syncthreads();
  // level 0, the estimate, and the first i (last j) that passes
  const bool off = b * kScanThreads + tid >= 1;
  const float up = tid >= 1 ? p1s[tid - 1] : edge[1];
  unsigned long long best = ~0ull;
  for (int m = 0; m < kChunk; ++m) {
    const int64_t j = b * kTile + kChunk * tid + m;
    if (j >= n) break;
    const float pre = off ? in0[m] + up : in0[m];
    const int64_t i = n - 1 - j;
    const float est = (float)i + pre / max_nan(xs[pad(kChunk * tid + m)],
                                               1e-35f);
    if (est > target)
      best = ((unsigned long long)i << 32) | __float_as_uint(pre);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    best = umin64(best, __shfl_down_sync(0xffffffffu, best, o));
  if ((tid & 31) == 0) warp_min[tid >> 5] = best;
  __syncthreads();
  if (tid == 0) {
    for (int w2 = 1; w2 < kScanThreads / 32; ++w2)
      best = umin64(best, warp_min[w2]);
    if (best != ~0ull) atomicMin(packed, best);
  }
}

}  // namespace

// ---- the C entry points -------------------------------------------------

// mode 0 bagging (c0 = fraction), 1 stratified bagging (`in` uint8 label
// signs, c0 / c1 = positive / negative fraction), 2 GOSS (`in` gh, sc0 /
// sc1 = device thr / p_tie, c0 = the rest's rate, c1 = its weight; words
// 2-3 the tie key), 3 MVS (`in` s, sc0 = device mu), 4 MVS's step (`in`
// s, sc0 = the scan's scratch, whose first word is the packed first i,
// sc1 = the scores sorted ascending, c0 = target, `aux` = mu's output).
// `words`: (4,) int64 on the device, 0-1 the draw's key.  `blocks` from
// the wrapper (`sample_plan` in ops/sample.py).  GOSS draws 4 rows a
// thread a step, the other modes 1.
extern "C" int ltt_sample(int mode, const void* words, const void* in,
                          const void* sc0, const void* sc1, float c0,
                          float c1, void* w, int64_t n, int blocks,
                          void* aux, void* stream_ptr) {
  if (n < 1 || n > 0xFFFFFFFFll || blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int64_t* kw = (const int64_t*)words;
  float* out = (float*)w;
  float* ax = (float*)aux;
#define LTT_LAUNCH(M)                                                   \
  sample_kernel<M, M == kGoss ? 4 : 1><<<blocks, kThreads, 0, stream>>>( \
      kw, in, sc0, sc1, c0, c1, out, n, ax)
  switch (mode) {
    case kBag: LTT_LAUNCH(kBag); break;
    case kStratified: LTT_LAUNCH(kStratified); break;
    case kGoss: LTT_LAUNCH(kGoss); break;
    case kMvs: LTT_LAUNCH(kMvs); break;
    case kMvsStep:
      if (aux == nullptr) return (int)cudaErrorInvalidValue;
      LTT_LAUNCH(kMvsStep);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LTT_LAUNCH
  return (int)cudaGetLastError();
}

// GOSS's threshold over gh (n,) float32: thr and p_tie (one float32
// each), counts = (n_gt, n_tie) int64; `state` kSelWords (5128) uint32
// words of scratch, zeroed here.  Three launches.
extern "C" int ltt_goss_select(const void* gh, int64_t n, int64_t top_k,
                               void* state, int64_t state_words, void* thr,
                               void* p_tie, void* counts, int blocks,
                               void* stream_ptr) {
  if (n < 1 || n > 0xFFFFFFFFll || top_k < 1 || top_k > n || blocks < 1 ||
      state_words != kSelWords)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t e = cudaMemsetAsync(state, 0, kSelWords * 4, stream);
  if (e != cudaSuccess) return (int)e;
  const float* x = (const float*)gh;
  uint32_t* st = (uint32_t*)state;
  float* t = (float*)thr;
  float* p = (float*)p_tie;
  int64_t* c = (int64_t*)counts;
  goss_select_kernel<0><<<blocks, kSelThreads, 0, stream>>>(x, n, top_k, st,
                                                            t, p, c);
  goss_select_kernel<1><<<blocks, kSelThreads, 0, stream>>>(x, n, top_k, st,
                                                            t, p, c);
  goss_select_kernel<2><<<blocks, kSelThreads, 0, stream>>>(x, n, top_k, st,
                                                            t, p, c);
  return (int)cudaGetLastError();
}

extern "C" int ltt_mvs_scores(const void* gh, float var_weight, void* s,
                              int64_t n, int blocks, void* stream_ptr) {
  if (n < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  mvs_scores_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream_ptr>>>(
      (const float*)gh, var_weight, (float*)s, n);
  return (int)cudaGetLastError();
}

// The class sum over K class rows of g and h (float32; row i of class k
// at k * ldg + i in g, k * ldh + i in h): mode 0 writes gh (n,) for GOSS's
// select and draw, mode 1 MVS's scores sqrt(gh * gh + var_weight) in place
// of `ltt_mvs_scores`.  One launch, `blocks` as the draw's
// (`sample_plan`).
extern "C" int ltt_class_sum(const void* g, int64_t ldg, const void* h,
                             int64_t ldh, int K, float var_weight, int mode,
                             void* out, int64_t n, int blocks,
                             void* stream_ptr) {
  if (n < 1 || K < 1 || blocks < 1 || (mode != 0 && mode != 1) ||
      (K > 1 && (ldg < n || ldh < n)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const float* gp = (const float*)g;
  const float* hp = (const float*)h;
  float* o = (float*)out;
  if (mode == 0)
    class_sum_kernel<false><<<blocks, kThreads, 0, stream>>>(
        gp, ldg, hp, ldh, K, var_weight, o, n);
  else
    class_sum_kernel<true><<<blocks, kThreads, 0, stream>>>(
        gp, ldg, hp, ldh, K, var_weight, o, n);
  return (int)cudaGetLastError();
}

// MVS's scan over the scores sorted ascending, `x` (n,): the packed first
// i with est > target (scratch words 0-1, ~0 if none) for the draw's mode
// 4.  `scratch`: the float32 words of `scan_layout(n)` (`scan_words` in
// ops/sample.py).  Two launches.
extern "C" int ltt_mvs_scan(const void* x, int64_t n, float target,
                            void* scratch, int64_t scratch_words,
                            void* stream_ptr) {
  if (n < 1 || n > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  ScanLevels L;
  if (scan_layout(n, &L) != scratch_words || L.top >= kMaxLevels - 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  // the packed first i to ~0, the completion counter to 0
  cudaError_t e = cudaMemsetAsync(scratch, 0xFF, 8, stream);
  if (e == cudaSuccess)
    e = cudaMemsetAsync((char*)scratch + 8, 0, 8, stream);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (int)((n + kTile - 1) / kTile);
  float* s = (float*)scratch;
  scan_up_kernel<<<blocks, kScanThreads, 0, stream>>>((const float*)x, n, s,
                                                      L);
  scan_down_kernel<<<blocks, kScanThreads, 0, stream>>>(
      (const float*)x, n, target, s, L, (unsigned long long*)scratch);
  return (int)cudaGetLastError();
}
