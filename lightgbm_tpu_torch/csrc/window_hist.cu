// Kernels V and V-lanes: windowed fine histograms of up to 64 row-disjoint
// subsets, the refine passes of coarse-to-fine split finding.
//
// Replace the TPU kernels
//   V:       `histogram_pallas_multi_win` / `_hist_kernel_multi_win`
//            (lightgbm_tpu/ops/histogram.py:628, :570), membership by an
//            explicit selector `sel[r]`;
//   V-lanes: `histogram_pallas_multi_win_lanes` /
//            `_hist_kernel_multi_win_lanes` (:1113, :1065), membership
//            `leaf_idx[r] == lane_ids[w]` (the leaf vector after the wave's
//            routing, so no (N,) selector is written or read).
//
// Per (subset s, feature f) only the fine bins in [win_lo[s, f],
// win_lo[s, f] + R) count, at relative positions, and a row at its
// feature's missing bin is left out (the windowed stats cover value bins;
// the missing bin lives in the coarse histogram's reserved slot):
//
//   rb = bins[f, r] - win_lo[s, f]
//   out[s, f, rb, c] += vals[r, c]
//       for 0 <= rb < R and bins[f, r] != miss_bin[f]
//
// The TPU kernels resolved each row's window start with a (FC, W) x (W, T)
// MXU contraction against the subset one-hot, because a per-row gather is
// slow there, and V-lanes its lane with a compare against the W ids.
// Here the block owns one feature, so its W window starts sit in shared
// memory and a row reads its own; V-lanes reads its lane from a leaf ->
// lane table in shared memory, built per block in lane order.  The
// accumulation body is kernel M's (subset_hist.cuh): int32 atomics on int8
// values, float64 on floats, the (W, R, cols) tile (64 x 32 x 2 x 4 = 16 KB
// at W = 64 two-column) in dynamic shared memory, fixed-order partials.
//
// What bounds it on an H100: bytes.  Every row's membership is read (the
// selector or the leaf vector), and, for the rows of the subsets, the bin
// matrix and the values; only the rows inside a window add, about 2 of the
// 16 coarse bins' worth, so the atomics are few beside kernel M's.
#include "subset_hist.cuh"

// bins (F, N) uint8/int16; sel (N,) int32/int8; vals (N, val_cols)
// int8/float32; win_lo (W, F) int32; miss_bin (F,) int32 or null; out
// (W, F, R, 3) float32.  `partial` holds row_blocks x F x W x R x cols int32
// (int8 values) or float64.
extern "C" int ltt_window_hist(const void* bins, int bin_bytes,
                               const void* sel, int sel_bytes,
                               const void* vals, int val_int8, int val_cols,
                               int two_col, const void* win_lo,
                               const void* miss_bin, int64_t n,
                               int num_features, int r_bins, int width,
                               int row_blocks, void* partial, void* out,
                               void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int cols = two_col ? 2 : 3;
  if (val_cols < cols || width < 1 || width > kMaxSubsets)
    return (int)cudaErrorInvalidValue;
  const WindowMap map{(const int32_t*)win_lo, (const int32_t*)miss_bin, -1,
                      nullptr};
  float* o = (float*)out;
  cudaError_t err;
  if (sel_bytes == 4) {
    const SelMember<int32_t> member{(const int32_t*)sel, width};
    err = subset_by_bins(bins, bin_bytes, member,
                         map, vals, val_int8, val_cols, cols, n, num_features,
                         r_bins, width, row_blocks, partial, o, stream);
  } else if (sel_bytes == 1) {
    const SelMember<int8_t> member{(const int8_t*)sel, width};
    err = subset_by_bins(bins, bin_bytes, member,
                         map, vals, val_int8, val_cols, cols, n, num_features,
                         r_bins, width, row_blocks, partial, o, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

// As ltt_window_hist, membership from leaf_idx (N,) uint8/int32 with every
// id below leaf_bound (<= 32768) and lane_ids (W,) int32.
extern "C" int ltt_lanes_window_hist(const void* bins, int bin_bytes,
                                     const void* leaf_idx, int idx_bytes,
                                     const void* lane_ids, int leaf_bound,
                                     const void* vals, int val_int8,
                                     int val_cols, int two_col,
                                     const void* win_lo, const void* miss_bin,
                                     int64_t n, int num_features, int r_bins,
                                     int width, int row_blocks, void* partial,
                                     void* out, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int cols = two_col ? 2 : 3;
  if (val_cols < cols || width < 1 || width > kMaxSubsets || leaf_bound < 1 ||
      leaf_bound > 32768)
    return (int)cudaErrorInvalidValue;
  const WindowMap map{(const int32_t*)win_lo, (const int32_t*)miss_bin, -1,
                      nullptr};
  const int32_t* ids = (const int32_t*)lane_ids;
  float* o = (float*)out;
  cudaError_t err;
  if (idx_bytes == 1) {
    err = subset_by_bins(
        bins, bin_bytes,
        LaneMember<uint8_t>{(const uint8_t*)leaf_idx, ids, width, leaf_bound,
                            nullptr},
        map, vals, val_int8, val_cols, cols, n, num_features, r_bins, width,
        row_blocks, partial, o, stream);
  } else if (idx_bytes == 4) {
    err = subset_by_bins(
        bins, bin_bytes,
        LaneMember<int32_t>{(const int32_t*)leaf_idx, ids, width, leaf_bound,
                            nullptr},
        map, vals, val_int8, val_cols, cols, n, num_features, r_bins, width,
        row_blocks, partial, o, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
