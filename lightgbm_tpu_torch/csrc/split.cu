// Kernel S: best numerical split of a batch of leaf histograms, in one
// launch.
//
// Replaces the TPU kernel `find_best_split_pallas` / `_split_scan_kernel`
// (lightgbm_tpu/ops/split.py:899, :856) with its helpers `_scan_tile`
// (:599), `_tile_best` (:676) and `finish_split_partials` (:806).
//
// One block per (feature, leaf lane), in one launch:
//
// - Lane scalars.  Every thread computes the lane's gain shift from the
//   (W, 3) parent stats itself, with the operations and order of the plain
//   `lane_scalars`: the leaf output in float32, minus the fused product-sum
//   fma32(2 sg, out, (h + l2) out out), plus min_gain_to_split.
// - Scan.  The block stages its feature's (B, 3) histogram in shared
//   memory (bins from the missing bin on count as 0) and forms the prefix
//   sums of [grad, hess, count] in the order of the JAX reference's
//   jnp.cumsum on the CPU, which the plain version (`prefix_sum`) follows:
//   a thread scans each (channel, 16-bin chunk) sequentially, threads 0-2
//   scan the chunk totals the same way (one channel each), and every chunk
//   after the first is offset by the total of the ones before it.  The same
//   histogram then gives the same prefix sums, gains and choice on the
//   card, on the CPU and in the reference, which matters where quantized
//   histograms (integers times a scale) tie exactly.
// - Gains.  A thread a bin: both default directions, every gain in float32
//   in exactly the order of `_split_gain` under the min_data /
//   min_sum_hessian (or, with counts_proxy, hessian-only) and candidate
//   masks.  The library is built with -fmad=false, so no multiply-add is
//   contracted and the gains match the plain PyTorch expression bit for
//   bit.  The feature's first maximum (lowest bin on ties) goes to a
//   scratch slot.
// - Constrained mode (monotone_constraints, feature_contri): three
//   optional operands, each with a flag in the kernel's template, so the
//   unconstrained launch runs the code it ran before them.  With the lane
//   bounds (W, 2) [mn, mx] each child output is clipped to them before
//   its gain given output, and the products fused follow the site's
//   operand `fuse`, as the reference's compile of each unit fuses under
//   the clip (ops/split.py `_CLIP_FUSION`): 0 the root's (default right
//   its first product, default left its second, as unconstrained), 1 the
//   exact loop's (both the first), 2 a wave's children's (both the
//   second);
//   with the directions mono (F,) a candidate whose clipped outputs break
//   its feature's direction gets NEG_INF before the gain shift; with the
//   multipliers pen (F,) a real gain is scaled by its feature's after the
//   directions' max and before the feature mask (the TPU kernel's
//   `has_mono`, `has_pen` and `has_bounds`, ops/split.py:599-673,
//   :856-897).  A block loads its feature's direction and multiplier and
//   its lane's bounds once: 5 bytes a feature and 8 a lane on top of the
//   unconstrained call's.
// - Record.  The lane's last block to finish (a per-lane counter, which
//   that block resets to 0 for the next launch) takes the first maximum
//   over the features' slots (lowest feature on ties) and writes the
//   record: gain (NEG_INF where the lane's depth has reached max_depth > 0,
//   the growth loop's depth limit), feature, threshold, default_left, left
//   stats and the (B,) goes-left mask over bin ids, as
//   `finish_split_partials` builds it (ops/split.py:828-833).
//
// What bounds it on an H100: neither bytes nor operations.  One call reads
// W x F x B x 3 floats (172 KB for the two children of a split at 28
// features x 256 bins) and does about 53 flops per (lane, feature, bin):
// 0.05 us by bytes.  The exact growth loop calls it 255 times a tree, one
// call at a time, so what counts is the call's latency on the card and
// its cost to the host: one launch, no other kernel around it, and blocks
// spread over the card, each with a short dependent chain: one load, 16 +
// 16 adds of the scan, a bin's gains.  (One block per lane, a warp per
// feature, measured 0.024 ms of device time at W=2 on an H100: one SM then
// evaluates all 7,168 candidates of a lane.)
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-15f;
constexpr float kNegInf = -1e30f;
constexpr int kChunk = 16;
constexpr int kMaxBins = 2048;
constexpr int kThreads = 256;
constexpr int kMaxWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct SplitCfg {
  float l1, l2, mds, min_data, min_hess, min_gain;
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

// Constrained-mode flags of the kernel's template
constexpr int kBounds = 1;  // lane bounds: clip both child outputs
constexpr int kMono = 2;    // feature directions: drop violating candidates
constexpr int kPen = 4;     // feature gain multipliers

// The lane's bounds and the feature's direction (read where kMode has them)
struct Cons {
  float mn, mx;
  int mono;
};

template <int kMode>
__device__ __forceinline__ float split_gain(float gl, float hl, float gr,
                                            float hr, const SplitCfg& c,
                                            bool fuse_first, const Cons& k) {
  float lo = leaf_output(gl, hl, c);
  float ro = leaf_output(gr, hr, c);
  if (kMode & kBounds) {
    lo = fminf(fmaxf(lo, k.mn), k.mx);
    ro = fminf(fmaxf(ro, k.mn), k.mx);
  }
  const float g = gain_given_output(gl, hl, lo, c, fuse_first) +
                  gain_given_output(gr, hr, ro, c, fuse_first);
  if ((kMode & kMono) && ((k.mono > 0 && lo > ro) || (k.mono < 0 && lo < ro)))
    return kNegInf;
  return g;
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

// A candidate: net gain, bin, direction and left stats.
struct Cand {
  float gain;
  int j;
  bool dl;
  float lg, lh, lc;
};

// `o` wins over `a` when better, or equal at a lower index `k`.  A NaN
// gain ranks above every number, the first NaN above the later ones, as
// in the plain version's `torch.max` and `torch.argmax` (and the JAX
// package's `jnp.argmax`): non-finite gradients give the same record.
// Branch-free, so that the NaN tests cost the 2W = 128 call under 1% (a
// branch on them cost 14%: tools/split_ab.py, PERF.md).
__device__ __forceinline__ bool beats(float go, int ko, float ga, int ka) {
  const bool on = go != go, an = ga != ga, lower = ko < ka;
  return (go > ga) | ((go == ga) & lower) | (on & (!an | lower));
}

__device__ __forceinline__ Cand shfl_cand(const Cand& a, int off) {
  Cand o;
  o.gain = __shfl_down_sync(kFull, a.gain, off);
  o.j = __shfl_down_sync(kFull, a.j, off);
  o.dl = __shfl_down_sync(kFull, (int)a.dl, off) != 0;
  o.lg = __shfl_down_sync(kFull, a.lg, off);
  o.lh = __shfl_down_sync(kFull, a.lh, off);
  o.lc = __shfl_down_sync(kFull, a.lc, off);
  return o;
}

// The block's first maximum of `c` (by gain, then lowest index j), in
// thread 0; `red` holds a candidate per warp.
__device__ Cand block_first_max(Cand c, Cand* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Cand o = shfl_cand(c, off);
    if (beats(o.gain, o.j, c.gain, c.j)) c = o;
  }
  if (lane == 0) red[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int q = 1; q < (int)(blockDim.x >> 5); ++q)
      if (beats(red[q].gain, red[q].j, c.gain, c.j)) c = red[q];
  return c;
}

// Floats of a block's shared memory: the feature's (B, 3) histogram,
// scanned in place, the chunk totals (3 x nc) and the totals' own chunk
// totals (3 x (nc / 16 + 1)).
__host__ __device__ inline int smem_floats(int B) {
  const int nc = (B + kChunk - 1) / kChunk;
  return 3 * B + 3 * nc + 3 * (nc / kChunk + 1);
}

// A feature's best candidate in the scratch: [gain, bin, default_left,
// Lg, Lh, Lc] (bin and direction as float values, exact below 2^24).
constexpr int kPart = 8;

template <int kMode, int kFuse>
__global__ void best_split_kernel(const float* __restrict__ hist,
                                  const float* __restrict__ parent,
                                  const int32_t* __restrict__ num_bins,
                                  const int32_t* __restrict__ missing_type,
                                  const uint8_t* __restrict__ feature_mask,
                                  const int32_t* __restrict__ depth,
                                  int depth_stride, int max_depth,
                                  const int32_t* __restrict__ mono,
                                  const float* __restrict__ pen,
                                  const float* __restrict__ bounds, int F,
                                  int B, SplitCfg cfg,
                                  float* __restrict__ part,
                                  unsigned* __restrict__ done,
                                  float* __restrict__ gain_out,
                                  float* __restrict__ left_stats,
                                  int32_t* __restrict__ feature_out,
                                  int32_t* __restrict__ threshold_out,
                                  uint8_t* __restrict__ default_left,
                                  uint8_t* __restrict__ left_mask) {
  extern __shared__ float smem[];
  __shared__ Cand red[kMaxWarps];
  __shared__ bool last;
  const int f = blockIdx.x;
  const int w = blockIdx.y;
  const int t = threadIdx.x;
  const int nc = (B + kChunk - 1) / kChunk;
  float* cum = smem;                  // [j * 3 + ch]
  float* tot = cum + 3 * B;           // [ch * nc + c]
  float* tot2 = tot + 3 * nc;         // [ch * (nc / 16 + 1) + k]

  // the lane scalars, as `lane_scalars` computes them
  const float pg = parent[w * 3], ph = parent[w * 3 + 1];
  const float pc = parent[w * 3 + 2];
  const float gshift =
      gain_given_output(pg, ph, leaf_output(pg, ph, cfg), cfg, true) +
      cfg.min_gain;

  const float* hf = hist + ((int64_t)w * F + f) * B * 3;
  const int nb = num_bins[f];
  const bool has_miss = cfg.any_missing && missing_type[f] != 0;
  const int nv = nb - (has_miss ? 1 : 0);
  for (int i = t; i < 3 * B; i += blockDim.x)
    cum[i] = i / 3 < nv ? hf[i] : 0.0f;    // bins from nv on count as 0
  float mg = 0.0f, mh = 0.0f, mc = 0.0f;
  if (has_miss) {
    mg = hf[(nb - 1) * 3];
    mh = hf[(nb - 1) * 3 + 1];
    mc = hf[(nb - 1) * 3 + 2];
  }
  __syncthreads();
  // sequential within each 16-bin chunk, a thread a (channel, chunk)
  for (int q = t; q < 3 * nc; q += blockDim.x) {
    const int ch = q / nc, c = q % nc;
    const int j0 = c * kChunk, e = min(j0 + kChunk, B);
    float a = cum[j0 * 3 + ch];
    for (int j = j0 + 1; j < e; ++j) {
      a = a + cum[j * 3 + ch];
      cum[j * 3 + ch] = a;
    }
    tot[ch * nc + c] = a;
  }
  __syncthreads();
  // the chunk totals, a thread a channel
  if (t < 3 && nc > 1)
    chunked_scan_serial(tot + t * nc, nc, tot2 + t * (nc / kChunk + 1));
  __syncthreads();

  const bool fm = feature_mask[f] != 0;
  Cons k{0.0f, 0.0f, 0};
  if (kMode & kBounds) {
    k.mn = bounds[w * 2];
    k.mx = bounds[w * 2 + 1];
  }
  if (kMode & kMono) k.mono = mono[f];
  const float pf = (kMode & kPen) ? pen[f] : 1.0f;
  // the products fused under the clip (kFuse), else as unconstrained
  const bool right_first = !(kMode & kBounds) || kFuse != 2;
  const bool left_first = (kMode & kBounds) && kFuse == 1;
  Cand mine{-INFINITY, B, false, 0.f, 0.f, 0.f};
  for (int j = t; j < B; j += blockDim.x) {
    const int c = j / kChunk;
    float Lg = cum[j * 3], Lh = cum[j * 3 + 1], Lc = cum[j * 3 + 2];
    if (c > 0) {
      Lg = Lg + tot[c - 1];
      Lh = Lh + tot[nc + c - 1];
      Lc = Lc + tot[2 * nc + c - 1];
    }
    const bool cand = j <= nv - 2;
    const float Rg = pg - Lg, Rh = ph - Lh, Rc = pc - Lc;
    float g_r =
        split_gain<kMode>(Lg, Lh + kEps, Rg, Rh + kEps, cfg, right_first, k) -
        gshift;
    const bool ok_r = cand && feasible(Lc, Lh, Rc, Rh, cfg);
    g_r = ok_r ? g_r : kNegInf;
    float gain = g_r;
    bool dl = false;
    float wg = Lg, wh = Lh, wc = Lc;
    if (cfg.any_missing) {
      const float Llg = Lg + mg, Llh = Lh + mh, Llc = Lc + mc;
      const float Rlg = pg - Llg, Rlh = ph - Llh, Rlc = pc - Llc;
      float g_l = split_gain<kMode>(Llg, Llh + kEps, Rlg, Rlh + kEps, cfg,
                                    left_first, k) -
                  gshift;
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
    if ((kMode & kPen) && gain > 0.5f * kNegInf) gain = gain * pf;
    if (!fm) gain = kNegInf;
    // a thread's bins ascend: a later one wins only when better
    if (mine.j == B || beats(gain, j, mine.gain, mine.j))
      mine = Cand{gain, j, dl, wg, wh, wc};
  }
  // the feature's first maximum (lowest bin on ties) into the scratch
  const Cand best = block_first_max(mine, red);
  if (t == 0) {
    float* out = part + ((int64_t)w * F + f) * kPart;
    out[0] = best.gain;
    out[1] = (float)best.j;
    out[2] = best.dl ? 1.0f : 0.0f;
    out[3] = best.lg;
    out[4] = best.lh;
    out[5] = best.lc;
    __threadfence();
    // the lane's last block to finish its feature writes the record
    last = atomicAdd(done + w, 1u) == (unsigned)(F - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // first maximum over features (lowest feature on ties), from L2
  const float* pw = part + (int64_t)w * F * kPart;
  Cand fb{-INFINITY, F, false, 0.f, 0.f, 0.f};
  for (int q = t; q < F; q += blockDim.x) {
    const float g = __ldcg(pw + q * kPart);
    if (fb.j == F || beats(g, q, fb.gain, fb.j))
      fb = Cand{g, q, false, 0.f, 0.f, 0.f};
  }
  __syncthreads();                     // `red` is reused
  fb = block_first_max(fb, red);
  __shared__ int s_f, s_j;
  __shared__ bool s_dl;
  if (t == 0) {
    const float* r = pw + fb.j * kPart;
    const int js = (int)__ldcg(r + 1);
    const bool dls = __ldcg(r + 2) > 0.5f;
    const bool limited = max_depth > 0 && depth != nullptr &&
                         depth[w * depth_stride] >= max_depth;
    gain_out[w] = limited ? kNegInf : fb.gain;
    feature_out[w] = fb.j;
    threshold_out[w] = js;
    default_left[w] = dls ? 1 : 0;
    left_stats[w * 3] = __ldcg(r + 3);
    left_stats[w * 3 + 1] = __ldcg(r + 4);
    left_stats[w * 3 + 2] = __ldcg(r + 5);
    s_f = fb.j;
    s_j = js;
    s_dl = dls;
    done[w] = 0u;                      // ready for the next launch
  }
  __syncthreads();
  const int fs = s_f, js = s_j;
  const bool dls = s_dl;
  const int nbs = num_bins[fs];
  const bool hm = cfg.any_missing && missing_type[fs] != 0;
  const int nvs = nbs - (hm ? 1 : 0);
  for (int j = t; j < B; j += blockDim.x) {
    const bool left = (j <= js && j < nvs) || (dls && hm && j == nbs - 1);
    left_mask[(int64_t)w * B + j] = left ? 1 : 0;
  }
}

}  // namespace

// hist (W, F, B, 3) float32; parent (W, 3) float32; num_bins /
// missing_type (F,) int32; feature_mask (F,) uint8; depth int32 or null,
// lane w's at depth[w * depth_stride] (stride 0: one depth for all).
// The constrained mode's operands, each null where absent: mono (F,)
// int32 directions, pen (F,) float32 multipliers, bounds (W, 2) float32
// [mn, mx] a lane; `fuse` the site's fused products under the clip (0, 1
// or 2, above).
// `part` is W x F x 8 float32 scratch; `done` W uint32 counters, zero
// before the launch and zero again after it (the kernel resets
// them), so launches that share them must be ordered on one stream.  The
// record: gain (W,) float32, left_stats (W, 3) float32, feature /
// threshold (W,) int32, default_left (W,) and left_mask (W, B) uint8.
extern "C" int ltt_best_split(const void* hist, const void* parent,
                              const void* num_bins, const void* missing_type,
                              const void* feature_mask, const void* depth,
                              int depth_stride, int max_depth,
                              const void* mono, const void* pen,
                              const void* bounds, int fuse, int W, int F,
                              int B, float l1,
                              float l2, float mds, float min_data,
                              float min_hess, float min_gain, int any_missing,
                              int counts_proxy, void* part, void* done,
                              void* gain, void* left_stats, void* feature,
                              void* threshold, void* default_left,
                              void* left_mask, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (W < 1 || W > 65535 || F < 1 || B < 1 || B > kMaxBins)
    return (int)cudaErrorInvalidValue;
  int threads = (B + 31) / 32 * 32;
  if (threads > kThreads) threads = kThreads;
  SplitCfg cfg{l1, l2, mds, min_data, min_hess, min_gain, any_missing,
               counts_proxy};
  const int mode = (bounds ? kBounds : 0) | (mono ? kMono : 0) |
                   (pen ? kPen : 0);
  const dim3 grid(F, W);
  const size_t smem = smem_floats(B) * sizeof(float);
#define LTT_SPLIT_LAUNCH(M, U)                                               \
  best_split_kernel<M, U><<<grid, threads, smem, stream>>>(                  \
      (const float*)hist, (const float*)parent, (const int32_t*)num_bins,    \
      (const int32_t*)missing_type, (const uint8_t*)feature_mask,            \
      (const int32_t*)depth, depth_stride, max_depth, (const int32_t*)mono,  \
      (const float*)pen, (const float*)bounds, F, B, cfg, (float*)part,      \
      (unsigned*)done, (float*)gain, (float*)left_stats, (int32_t*)feature,  \
      (int32_t*)threshold, (uint8_t*)default_left, (uint8_t*)left_mask)
  constexpr int kClip = kBounds | kMono;
  if (fuse < 0 || fuse > 2) return (int)cudaErrorInvalidValue;
  switch (mode * 4 + (mode & kBounds ? fuse : 0)) {
    case 0: LTT_SPLIT_LAUNCH(0, 0); break;
    case kPen * 4: LTT_SPLIT_LAUNCH(kPen, 0); break;
    case kClip * 4: LTT_SPLIT_LAUNCH(kClip, 0); break;
    case kClip * 4 + 1: LTT_SPLIT_LAUNCH(kClip, 1); break;
    case kClip * 4 + 2: LTT_SPLIT_LAUNCH(kClip, 2); break;
    case (kClip | kPen) * 4: LTT_SPLIT_LAUNCH(kClip | kPen, 0); break;
    case (kClip | kPen) * 4 + 1: LTT_SPLIT_LAUNCH(kClip | kPen, 1); break;
    case (kClip | kPen) * 4 + 2: LTT_SPLIT_LAUNCH(kClip | kPen, 2); break;
    default: return (int)cudaErrorInvalidValue;  // bounds come with mono
  }
#undef LTT_SPLIT_LAUNCH
  return (int)cudaGetLastError();
}
