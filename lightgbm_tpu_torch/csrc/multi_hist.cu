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
// split of float values; neither exists here.  The accumulation body,
// shared with kernels V and V-lanes, is in subset_hist.cuh: one block per
// feature and row range, the (W, B, cols) tile in dynamic shared memory
// (64 x 256 x 2 x 4 = 128 KB at W = 64 two-column, 64 x 17 x 2 x 4 = 8.5 KB
// coarse), int32 atomics for int8 values, float64 for floats, fixed-order
// partials: exact, and the same on every run.
//
// What bounds it on an H100: bytes at the root pass (every row in lane 0:
// the F x N bin matrix, the (N, cols) values and the (N,) selector, about
// 0.1 ms at 10.5M x 28 from HBM), and in practice the shared-memory
// atomics, N x F x cols of them when every row is selected; at a coarse
// resolution the 16-17 bins of a feature take the atomics of all its rows,
// so equal addresses within a warp serialise more often.  The blocks of
// one row range run together (feature is the fast grid index), so the
// selector and the values of a row range are read from HBM once and from
// L2 by the other features' blocks.  Fewer atomics (warp aggregation of
// equal bins) are later work.
#include "subset_hist.cuh"

// bins (F, N) uint8/int16; sel (N,) int32/int8; vals (N, val_cols)
// int8/float32; shift >= 0; miss_bin (F,) int32 or null (read only with a
// shift); out (W, F, B, 3) float32, B the (coarse) bin count.  `partial`
// holds row_blocks x F x W x B x cols int32 (int8 values) or float64
// (float values).
extern "C" int ltt_multi_hist(const void* bins, int bin_bytes, const void* sel,
                              int sel_bytes, const void* vals, int val_int8,
                              int val_cols, int two_col, int64_t n,
                              int num_features, int num_bins, int width,
                              int shift, const void* miss_bin, int row_blocks,
                              void* partial, void* out, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int cols = two_col ? 2 : 3;
  if (val_cols < cols || width < 1 || width > kMaxSubsets || shift < 0 ||
      shift > 15)
    return (int)cudaErrorInvalidValue;
  const CoarseMap map{shift, shift > 0 ? (const int32_t*)miss_bin : nullptr,
                      num_bins - 1, -1};
  float* o = (float*)out;
  cudaError_t err;
  if (sel_bytes == 4) {
    const SelMember<int32_t> member{(const int32_t*)sel, width};
    err = subset_by_bins(bins, bin_bytes, member,
                         map, vals, val_int8, val_cols, cols, n, num_features,
                         num_bins, width, row_blocks, partial, o, stream);
  } else if (sel_bytes == 1) {
    const SelMember<int8_t> member{(const int8_t*)sel, width};
    err = subset_by_bins(bins, bin_bytes, member,
                         map, vals, val_int8, val_cols, cols, n, num_features,
                         num_bins, width, row_blocks, partial, o, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
