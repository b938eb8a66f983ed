// Kernel S: best numerical split of a batch of leaf histograms.
//
// Replaces the TPU kernel `find_best_split_pallas` / `_split_scan_kernel`
// (lightgbm_tpu/ops/split.py:899, :856) with its helpers `_scan_tile`
// (:599), `_tile_best` (:676) and `finish_split_partials` (:806).
//
// Stage 1, one block per (feature, leaf lane): an inclusive float32 scan
// over the B bins of [grad, hess, count] restricted to the value bins; the
// missing bin's stats are added for the default-left direction; the gain
// of every threshold is computed in float32 in exactly the order of
// `_split_gain` (leaf output, then gain given output, then minus the
// parent's gain shift) under the min_data / min_sum_hessian (or, with
// counts_proxy, hessian-only) / candidate masks; the block keeps the first
// maximum (lowest bin).  The scan adds in the order of the JAX reference's
// jnp.cumsum on the CPU (sequential within chunks of 16 bins, chunk
// totals scanned the same way, each chunk offset by the ones before it),
// as the plain version (`prefix_sum`) does: the same histogram then gives
// the same prefix sums, gains and choice on the card, on the CPU and in
// the reference, which matters where quantized histograms (integers times
// a scale) tie exactly.  The library is built with -fmad=false, so no
// multiply-add is contracted and the gains match the plain PyTorch
// expression bit for bit.
//
// Stage 2, one block per lane: the first maximum over features (lowest
// feature on ties), then the record: gain, feature, threshold,
// default_left, left stats and the (B,) goes-left mask over bin ids, as
// `finish_split_partials` builds it (ops/split.py:828-833).
//
// What bounds it on an H100: neither bytes nor operations.  One call reads
// W x F x B x 3 floats (172 KB for the two children of a split at 28
// features x 256 bins) and does a few dozen flops per bin; the two
// launches and the block-wide scan's barriers are the cost.  It runs once
// per split (both children in one launch), so it is latency that matters;
// fusing it into the histogram pass is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-15f;
constexpr float kNegInf = -1e30f;
constexpr int kMaxThreads = 256;
constexpr int kChunk = 16;
constexpr int kMaxBins = 2048;  // static shared scan buffer

struct SplitCfg {
  float l1, l2, mds, min_data, min_hess;
  int any_missing;
  int counts_proxy;  // count channel is a hess copy: hessian test only
};

__device__ __forceinline__ bool feasible(float lc, float lh, float rc,
                                         float rh, const SplitCfg& c) {
  if (c.counts_proxy) return lh >= c.min_hess && rh >= c.min_hess;
  return lc >= c.min_data && rc >= c.min_data && lh >= c.min_hess &&
         rh >= c.min_hess;
}

__device__ __forceinline__ float threshold_l1(float s, float l1) {
  if (l1 == 0.0f) return s;
  const float sgn = (float)((s > 0.0f) - (s < 0.0f));
  const float a = fabsf(s) - l1;
  return sgn * (a > 0.0f ? a : 0.0f);
}

__device__ __forceinline__ float leaf_output(float g, float h,
                                             const SplitCfg& c) {
  float out = -threshold_l1(g, c.l1) / ((h + c.l2) + kEps);
  if (c.mds > 0.0f) out = fminf(fmaxf(out, -c.mds), c.mds);
  return out;
}

// float32 a * b + c with the product exact in float64 and the sum rounded
// there and then to float32: the plain version's `fma32`, bit for bit
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return (float)((double)a * (double)b + (double)c);
}

// -(2 sg out + (h + l2) out out) with one product fused into the sum, as
// the JAX reference's CPU compile contracts it: the first product, or the
// second one in the default-left scan (`fuse_first` false)
__device__ __forceinline__ float gain_given_output(float g, float h, float out,
                                                   const SplitCfg& c,
                                                   bool fuse_first) {
  const float sg = threshold_l1(g, c.l1);
  if (fuse_first) return -fma32(2.0f * sg, out, ((h + c.l2) * out) * out);
  return -fma32((h + c.l2) * out, out, (2.0f * sg) * out);
}

__device__ __forceinline__ float split_gain(float gl, float hl, float gr,
                                            float hr, const SplitCfg& c,
                                            bool fuse_first) {
  const float lo = leaf_output(gl, hl, c);
  const float ro = leaf_output(gr, hr, c);
  return gain_given_output(gl, hl, lo, c, fuse_first) +
         gain_given_output(gr, hr, ro, c, fuse_first);
}

// Inclusive prefix sums of a[0..n), n <= kChunk^2, by one thread in the
// order of XLA's CPU cumsum: sequential within chunks of kChunk, the chunk
// totals summed sequentially, and each chunk after the first offset by
// the total of the ones before it.  `tot` holds n / kChunk + 1 floats.
__device__ void chunked_scan_serial(float* a, int n, float* tot) {
  const int nc = (n + kChunk - 1) / kChunk;
  for (int c = 0; c < nc; ++c) {
    const int e = min((c + 1) * kChunk, n);
    for (int i = c * kChunk + 1; i < e; ++i) a[i] = a[i - 1] + a[i];
    tot[c] = a[e - 1];
  }
  for (int c = 1; c < nc; ++c) tot[c] = tot[c - 1] + tot[c];
  for (int c = 1; c < nc; ++c) {
    const int e = min((c + 1) * kChunk, n);
    for (int i = c * kChunk; i < e; ++i) a[i] = a[i] + tot[c - 1];
  }
}

// per-(lane, feature) partial: [gain, bin, default_left, Lg, Lh, Lc, 0, 0]
__global__ void split_scan_kernel(const float* __restrict__ hist,
                                  const int32_t* __restrict__ num_bins,
                                  const int32_t* __restrict__ missing_type,
                                  const uint8_t* __restrict__ feature_mask,
                                  const float* __restrict__ lane, int F, int B,
                                  int per_thread, SplitCfg cfg,
                                  float* __restrict__ part) {
  __shared__ float cum[3][kMaxBins];
  __shared__ float tot[3][kMaxBins / kChunk];
  __shared__ float tot2[3][kMaxBins / kChunk / kChunk + 1];
  __shared__ float red_gain[kMaxThreads];
  __shared__ int red_bin[kMaxThreads];
  __shared__ int red_tid[kMaxThreads];

  const int f = blockIdx.x;
  const int w = blockIdx.y;
  const int t = threadIdx.x;
  const float* hf = hist + ((int64_t)w * F + f) * B * 3;
  const int nb = num_bins[f];
  const bool has_miss = cfg.any_missing && missing_type[f] != 0;
  const int nv = nb - (has_miss ? 1 : 0);
  float mg = 0.0f, mh = 0.0f, mc = 0.0f;
  if (has_miss) {
    mg = hf[(nb - 1) * 3];
    mh = hf[(nb - 1) * 3 + 1];
    mc = hf[(nb - 1) * 3 + 2];
  }
  const float pg = lane[w * 4], ph = lane[w * 4 + 1], pc = lane[w * 4 + 2];
  const float gshift = lane[w * 4 + 3];

  // float32 prefix sums of the value bins (bins from nv on count as 0) in
  // the order of XLA's CPU cumsum, which the plain version (`prefix_sum`)
  // and the JAX reference's jnp.cumsum follow: sequential within chunks of
  // kChunk bins (one thread per chunk and channel), the chunk totals
  // scanned the same way (one thread per channel), then every chunk after
  // the first offset by the total before it
  const int nc = (B + kChunk - 1) / kChunk;
  for (int q = t; q < 3 * nc; q += blockDim.x) {
    const int ch = q / nc, c = q % nc;
    const int e = min((c + 1) * kChunk, B);
    float acc = 0.0f;
    for (int j = c * kChunk; j < e; ++j) {
      const float v = j < nv ? hf[j * 3 + ch] : 0.0f;
      acc = j == c * kChunk ? v : acc + v;
      cum[ch][j] = acc;
    }
    tot[ch][c] = acc;
  }
  __syncthreads();
  if (t < 3 && nc > 1) chunked_scan_serial(tot[t], nc, tot2[t]);
  __syncthreads();
  for (int q = t; q < 3 * nc; q += blockDim.x) {
    const int ch = q / nc, c = q % nc;
    if (c == 0) continue;
    const int e = min((c + 1) * kChunk, B);
    for (int j = c * kChunk; j < e; ++j) cum[ch][j] = cum[ch][j] + tot[ch][c - 1];
  }
  __syncthreads();
  const int j0 = t * per_thread;
  const int j1 = min(j0 + per_thread, B);

  const bool fm = feature_mask[f] != 0;
  float best = kNegInf;
  int best_j = -1;
  float best_dl = 0.0f, best_lg = 0.0f, best_lh = 0.0f, best_lc = 0.0f;
  for (int j = j0; j < j1; ++j) {
    const float Lg = cum[0][j], Lh = cum[1][j], Lc = cum[2][j];
    const bool cand = j <= nv - 2;
    const float Rg = pg - Lg, Rh = ph - Lh, Rc = pc - Lc;
    float g_r = split_gain(Lg, Lh + kEps, Rg, Rh + kEps, cfg, true) - gshift;
    const bool ok_r = cand && feasible(Lc, Lh, Rc, Rh, cfg);
    g_r = ok_r ? g_r : kNegInf;
    float gain = g_r;
    bool dl = false;
    float wg = Lg, wh = Lh, wc = Lc;
    if (cfg.any_missing) {
      const float Llg = Lg + mg, Llh = Lh + mh, Llc = Lc + mc;
      const float Rlg = pg - Llg, Rlh = ph - Llh, Rlc = pc - Llc;
      float g_l =
          split_gain(Llg, Llh + kEps, Rlg, Rlh + kEps, cfg, false) - gshift;
      const bool ok_l = cand && feasible(Llc, Llh, Rlc, Rlh, cfg);
      g_l = ok_l ? g_l : kNegInf;
      if (mc <= 0.0f) g_l = kNegInf;
      dl = g_l > g_r;
      gain = dl ? g_l : g_r;
      if (dl) {
        wg = Llg;
        wh = Llh;
        wc = Llc;
      }
    }
    if (!fm) gain = kNegInf;
    if (best_j < 0 || gain > best) {
      best = gain;
      best_j = j;
      best_dl = dl ? 1.0f : 0.0f;
      best_lg = wg;
      best_lh = wh;
      best_lc = wc;
    }
  }

  // first maximum over threads: thread ranges ascend with t
  red_gain[t] = best;
  red_bin[t] = best_j < 0 ? B : best_j;
  red_tid[t] = t;
  __syncthreads();
  for (int off = blockDim.x / 2; off > 0; off >>= 1) {
    if (t < off) {
      const float go = red_gain[t + off];
      const int jo = red_bin[t + off];
      if (go > red_gain[t] || (go == red_gain[t] && jo < red_bin[t])) {
        red_gain[t] = go;
        red_bin[t] = jo;
        red_tid[t] = red_tid[t + off];
      }
    }
    __syncthreads();
  }
  if (t == red_tid[0]) {
    float* out = part + ((int64_t)w * F + f) * 8;
    out[0] = best;
    out[1] = (float)best_j;
    out[2] = best_dl;
    out[3] = best_lg;
    out[4] = best_lh;
    out[5] = best_lc;
  }
}

__global__ void split_finish_kernel(const float* __restrict__ part,
                                    const int32_t* __restrict__ num_bins,
                                    const int32_t* __restrict__ missing_type,
                                    int F, int B, int any_missing,
                                    float* __restrict__ gain,
                                    int32_t* __restrict__ feature,
                                    int32_t* __restrict__ threshold,
                                    uint8_t* __restrict__ default_left,
                                    float* __restrict__ left_stats,
                                    uint8_t* __restrict__ left_mask) {
  __shared__ float red_gain[kMaxThreads];
  __shared__ int red_f[kMaxThreads];
  const int w = blockIdx.x;
  const int t = threadIdx.x;
  const float* pw = part + (int64_t)w * F * 8;
  float best = kNegInf;
  int bf = -1;
  for (int f = t; f < F; f += blockDim.x) {
    const float g = pw[f * 8];
    if (bf < 0 || g > best) {
      best = g;
      bf = f;
    }
  }
  red_gain[t] = best;
  red_f[t] = bf < 0 ? F : bf;
  __syncthreads();
  for (int off = blockDim.x / 2; off > 0; off >>= 1) {
    if (t < off) {
      const float go = red_gain[t + off];
      const int fo = red_f[t + off];
      if (go > red_gain[t] || (go == red_gain[t] && fo < red_f[t])) {
        red_gain[t] = go;
        red_f[t] = fo;
      }
    }
    __syncthreads();
  }
  const int fs = red_f[0];
  const float* rec = pw + fs * 8;
  const int js = (int)rec[1];
  const bool dl = rec[2] > 0.5f;
  const int nb = num_bins[fs];
  const bool has_miss = any_missing && missing_type[fs] != 0;
  const int nv = nb - (has_miss ? 1 : 0);
  if (t == 0) {
    gain[w] = rec[0];
    feature[w] = fs;
    threshold[w] = js;
    default_left[w] = dl ? 1 : 0;
    left_stats[w * 3] = rec[3];
    left_stats[w * 3 + 1] = rec[4];
    left_stats[w * 3 + 2] = rec[5];
  }
  for (int j = t; j < B; j += blockDim.x) {
    const bool left =
        (j <= js && j < nv) || (dl && has_miss && j == nb - 1);
    left_mask[(int64_t)w * B + j] = left ? 1 : 0;
  }
}

}  // namespace

extern "C" int ltt_best_split(const void* hist, const void* num_bins,
                              const void* missing_type,
                              const void* feature_mask, const void* lane,
                              int W, int F, int B, float l1, float l2,
                              float mds, float min_data, float min_hess,
                              int any_missing, int counts_proxy, void* part,
                              void* gain,
                              void* feature, void* threshold,
                              void* default_left, void* left_stats,
                              void* left_mask, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (B < 1 || B > kMaxBins) return (int)cudaErrorInvalidValue;
  int threads = 32;
  while (threads < B && threads < kMaxThreads) threads <<= 1;
  const int per_thread = (B + threads - 1) / threads;
  SplitCfg cfg{l1, l2, mds, min_data, min_hess, any_missing, counts_proxy};
  split_scan_kernel<<<dim3(F, W), threads, 0, stream>>>(
      (const float*)hist, (const int32_t*)num_bins,
      (const int32_t*)missing_type, (const uint8_t*)feature_mask,
      (const float*)lane, F, B, per_thread, cfg, (float*)part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split_finish_kernel<<<W, kMaxThreads, 0, stream>>>(
      (const float*)part, (const int32_t*)num_bins,
      (const int32_t*)missing_type, F, B, any_missing, (float*)gain,
      (int32_t*)feature, (int32_t*)threshold, (uint8_t*)default_left,
      (float*)left_stats, (uint8_t*)left_mask);
  return (int)cudaGetLastError();
}
