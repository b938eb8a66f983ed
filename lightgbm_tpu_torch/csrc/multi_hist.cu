// Kernel M: histograms of up to 64 row-disjoint subsets in one pass, at
// full resolution or coarse.
//
// Replaces the TPU kernel `histogram_pallas_multi` / `_hist_kernel_multi`
// (lightgbm_tpu/ops/histogram.py:396, :300):
//
//   s = sel[r]                       (-1 = the row is in no subset)
//   b = (bins[f, r] == miss_bin[f]) ? Bc - 1 : bins[f, r] >> shift
//   out[s, f, b, c] += vals[r, c]                for s >= 0
//
// Shift 0 without a missing-bin vector is the full-resolution pass; with a
// shift the fine bins collapse 2^shift-to-1 on the fly and a row at its
// feature's missing bin goes to the reserved last coarse slot (the
// coarse-to-fine first stage, histogram.py:350-357, with `miss_idx =
// max_bin - 1` set at :458-464).  With `two_col`, only grad and hess are
// accumulated and the count channel of the output is a copy of the hess
// channel (the two-column quantized pass, :513-517).  The TPU form fed a
// one-hot x (lane one-hot * values) product to the MXU, with a bf16 hi/lo
// split of float values; neither exists here.
//
// The accumulation body is kernel R's (group_hist.cuh), run over the
// one-byte selector: 16-row groups with 16-byte loads, a feature group a
// block, a grid of one wave, int32 atomics on int8 values and column fixed
// point on float values, fixed-order partials: exact, and the same on
// every launch.  An int32 selector is narrowed to int8 by the wrapper (one
// more launch).  Float values take one more launch before the histogram:
// each column's largest exponent over all rows, the fixed-point scale.
//
// What bounds it on an H100: bytes.  The growth loops launch it as the
// root pass (W = 1, every row in lane 0): the F x N bin matrix, the (N,
// cols) values and the (N,) selector, about 0.1 ms at 10.5M x 28 from
// HBM.  There every row of a warp adds into the same lane's few cells (17
// x 2 int32 coarse, 256 x 2 full); the one shared tile of the body still
// measured fastest there (PERF.md, kernel M's modes).
#include "group_hist.cuh"

namespace {

constexpr int kMaxSubsets = 64;

struct MultiTag {};    // names kernel M's launches in a profile

template <typename BinT, int COLS>
cudaError_t multi_cols(const void* bins, const int8_t* sel, const void* vals,
                       int val_int8, const CoarseMap& map, int64_t n, int F,
                       int B, int W, GroupPlan plan, const int32_t* exp_max,
                       int exp_blocks, void* partial, float* out,
                       cudaStream_t stream) {
  if (val_int8)
    return launch_group<MultiTag, BinT, int8_t, COLS>(
        bins, ByteLanes{sel}, map, vals, n, F, B, W, plan, nullptr, 0,
        partial, out, stream);
  return launch_group<MultiTag, BinT, float, COLS>(
      bins, ByteLanes{sel}, map, vals, n, F, B, W, plan, exp_max, exp_blocks,
      partial, out, stream);
}

template <typename BinT>
const void* multi_fn(int val_int8, int cols) {
#define LTT_FN(ValT, C)                                                      \
  (const void*)group_hist_kernel<MultiTag, BinT, ValT, C, ByteLanes,         \
                                 CoarseMap>
  if (val_int8) return cols == 2 ? LTT_FN(int8_t, 2) : LTT_FN(int8_t, 3);
  return cols == 2 ? LTT_FN(float, 2) : LTT_FN(float, 3);
#undef LTT_FN
}

}  // namespace

// Blocks of kernel M's histogram launch one SM runs at once with `smem`
// bytes of shared memory a block (negative: a CUDA error).
extern "C" int ltt_multi_active_blocks(int bin_bytes, int val_int8, int cols,
                                       int smem) {
  if ((bin_bytes != 1 && bin_bytes != 2) || (cols != 2 && cols != 3))
    return -(int)cudaErrorInvalidValue;
  const void* fn = bin_bytes == 1 ? multi_fn<uint8_t>(val_int8, cols)
                                  : multi_fn<uint16_t>(val_int8, cols);
  return val_int8 ? group_active_blocks<int8_t>(fn, smem)
                  : group_active_blocks<float>(fn, smem);
}

// bins (F, N) uint8/int16; sel (N,) int8 in [-1, width), 16-byte aligned;
// vals (N, cols) int8/float32 (cols = 2 with two_col, else 3), 16-byte
// aligned; shift >= 0; miss_bin (F,) int32 or null (read only with a
// shift); out (W, F, B, 3) float32, B the (coarse) bin count.  The plan
// (features per block, row blocks, rows per block: a multiple of 16, at
// most 2^22 with float values) comes from the wrapper (`group_plan`);
// `partial` holds row_blocks x F x W x B x cols int32 (int8 values) or
// float64; `exp_max` exp_blocks x cols int32 scratch (float values only).
extern "C" int ltt_multi_hist(const void* bins, int bin_bytes,
                              const void* sel, const void* vals, int val_int8,
                              int two_col, int64_t n, int num_features,
                              int num_bins, int width, int shift,
                              const void* miss_bin, int feat_per_block,
                              int row_blocks, int64_t rows_per_block,
                              int exp_blocks, void* exp_max, void* partial,
                              void* out, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (width < 1 || width > kMaxSubsets || shift < 0 || shift > 15 ||
      feat_per_block < 1 || rows_per_block % kGroup != 0 ||
      (uintptr_t)vals % 16 != 0 || (uintptr_t)sel % 16 != 0 ||
      (!val_int8 && (exp_max == nullptr || exp_blocks < 1 ||
                     rows_per_block > ((int64_t)1 << 22))))
    return (int)cudaErrorInvalidValue;
  const int cols = two_col ? 2 : 3;
  int32_t* em = val_int8 ? nullptr : (int32_t*)exp_max;
  if (!val_int8) {
    const cudaError_t err = launch_exp_max<MultiTag>(
        (const float*)vals, cols, n, exp_blocks, em, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const CoarseMap map{shift, shift > 0 ? (const int32_t*)miss_bin : nullptr,
                      num_bins - 1, nullptr};
  const int8_t* s8 = (const int8_t*)sel;
  const GroupPlan plan{feat_per_block, row_blocks, rows_per_block};
  float* o = (float*)out;
#define LTT_MULTI(BinT, COLS)                                                \
  multi_cols<BinT, COLS>(bins, s8, vals, val_int8, map, n, num_features,     \
                         num_bins, width, plan, em, exp_blocks, partial, o,  \
                         stream)
  cudaError_t err;
  if (bin_bytes == 1)
    err = two_col ? LTT_MULTI(uint8_t, 2) : LTT_MULTI(uint8_t, 3);
  else if (bin_bytes == 2)
    err = two_col ? LTT_MULTI(uint16_t, 2) : LTT_MULTI(uint16_t, 3);
  else
    err = cudaErrorInvalidValue;
#undef LTT_MULTI
  return (int)err;
}
