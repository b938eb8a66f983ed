// Kernel B: the row-sampling draw of bagging, GOSS and MVS.
//
// It replaces no TPU kernel: the JAX package draws its sampling masks in
// XLA, not in Pallas (`_draw_bag_mask_impl`,
// lightgbm_tpu/models/gbdt.py:1110; `GOSS._goss_mask_impl` and
// `MVS._mvs_mask_impl`, lightgbm_tpu/models/boosting.py:78, :162).  It was
// added because each draw is `jax.random.uniform(key, (N,))`, a 20-round
// Threefry-2x32 a row: as PyTorch tensor ops (the plain version,
// `uniform_rows` in utils/prng.py) that is about 160 int64 passes over the
// rows, where one kernel keeps the rounds in registers and moves a few
// bytes a row.
//
// Every mode writes the (N,) float32 weight a row that the boosting loop
// multiplies into the gradients (0 = out of the sample):
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
// minus 1.  The keys are int64 words in device memory, and so are GOSS's
// threshold and tie rate and MVS's mu: a CUDA graph of a tree's head reads
// this tree's values at every replay.  The divisions are IEEE (the build
// has no fast-math flag), so the weights are the plain version's bits.
//
// What bounds it on an H100: bytes, or nearly as much the Threefry's
// integer operations.  A row writes 4 bytes (bagging, plus a label byte
// when stratified) or reads 4 and writes 4 (GOSS's gh, MVS's s): 52.5 to
// 84 MB at 10.5M rows, 16 to 25 us at 3.35 TB/s.  A draw is about 85
// 32-bit integer operations.  GOSS draws a row's second uniform only
// where it is needed (a tie, or a row left out of the top set), so a row
// costs one draw in every mode but at ties.
//
// The design: a thread a row in a grid-stride loop, neighbouring threads on
// neighbouring rows (coalesced 4-byte loads and stores), the rounds
// unrolled in registers with funnel-shift rotations.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum Mode { kBag = 0, kStratified = 1, kGoss = 2, kMvs = 3 };

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

template <int M>
__global__ void __launch_bounds__(kThreads)
sample_kernel(const int64_t* __restrict__ words, const void* __restrict__ in,
              const float* __restrict__ sc0, const float* __restrict__ sc1,
              float c0, float c1, float* __restrict__ w, int64_t n) {
  const uint32_t a0 = (uint32_t)words[0], a1 = (uint32_t)words[1];
  uint32_t b0 = 0, b1 = 0;
  float s0 = 0.0f, s1 = 0.0f;
  if (M == kGoss) {
    b0 = (uint32_t)words[2];
    b1 = (uint32_t)words[3];
    s0 = *sc0;                 // thr
    s1 = *sc1;                 // p_tie
  }
  if (M == kMvs) s0 = max_nan(*sc0, 1e-35f);   // max(mu, 1e-35)
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const uint32_t row = (uint32_t)i;
    float out;
    if (M == kBag) {
      out = uniform(a0, a1, row) < c0 ? 1.0f : 0.0f;
    } else if (M == kStratified) {
      const uint8_t pos = static_cast<const uint8_t*>(in)[i];
      out = uniform(a0, a1, row) < (pos ? c0 : c1) ? 1.0f : 0.0f;
    } else if (M == kGoss) {
      const float g = static_cast<const float*>(in)[i];
      bool top = g > s0;
      if (!top && g == s0) top = uniform(b0, b1, row) < s1;
      out = top ? 1.0f : (uniform(a0, a1, row) < c0 ? c1 : 0.0f);
    } else {
      const float s = static_cast<const float*>(in)[i];
      const float p = min_nan(s / s0, 1.0f);
      out = uniform(a0, a1, row) < p ? 1.0f / max_nan(p, 1e-35f) : 0.0f;
    }
    w[i] = out;
  }
}

}  // namespace

// mode 0 bagging (c0 = fraction), 1 stratified bagging (`in` uint8 label
// signs, c0 / c1 = positive / negative fraction), 2 GOSS (`in` gh, sc0 /
// sc1 = device thr / p_tie, c0 = the rest's rate, c1 = its weight; words
// 2-3 the tie key), 3 MVS (`in` s, sc0 = device mu).  `words`: (4,) int64
// on the device, 0-1 the draw's key.  `blocks` from the wrapper
// (`sample_plan` in ops/sample.py).
extern "C" int ltt_sample(int mode, const void* words, const void* in,
                          const void* sc0, const void* sc1, float c0,
                          float c1, void* w, int64_t n, int blocks,
                          void* stream_ptr) {
  if (n < 1 || n > 0xFFFFFFFFll || blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int64_t* kw = (const int64_t*)words;
  const float* p0 = (const float*)sc0;
  const float* p1 = (const float*)sc1;
  float* out = (float*)w;
  switch (mode) {
    case kBag:
      sample_kernel<kBag><<<blocks, kThreads, 0, stream>>>(kw, in, p0, p1,
                                                          c0, c1, out, n);
      break;
    case kStratified:
      sample_kernel<kStratified><<<blocks, kThreads, 0, stream>>>(
          kw, in, p0, p1, c0, c1, out, n);
      break;
    case kGoss:
      sample_kernel<kGoss><<<blocks, kThreads, 0, stream>>>(kw, in, p0, p1,
                                                           c0, c1, out, n);
      break;
    case kMvs:
      sample_kernel<kMvs><<<blocks, kThreads, 0, stream>>>(kw, in, p0, p1,
                                                          c0, c1, out, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
