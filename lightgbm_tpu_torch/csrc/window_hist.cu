// Kernels V and V-lanes: windowed fine histograms of row-disjoint subsets,
// the refine passes of coarse-to-fine split finding.
//
// Replace the TPU kernels
//   V:       `histogram_pallas_multi_win` / `_hist_kernel_multi_win`
//            (lightgbm_tpu/ops/histogram.py:628, :570), membership by an
//            explicit selector `sel[r]`, up to 64 subsets;
//   V-lanes: `histogram_pallas_multi_win_lanes` /
//            `_hist_kernel_multi_win_lanes` (:1113, :1065), membership
//            `leaf_idx[r] == lane_ids[w]` (the leaf vector after the wave's
//            routing, so no (N,) selector is written or read), up to 128
//            lanes.
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
//
// V (subset_hist.cuh): a block owns one feature, its W window starts sit
// in shared memory and a row reads its own; int32 atomics on int8 values,
// float64 on floats, fixed-order partials.
//
// V-lanes runs on the body of kernels R and M (group_hist.cuh): 16-row
// groups, the leaf -> lane table (int8, built per block in lane order) in
// shared memory applied to 16 leaf ids at a time (one 16-byte load of
// uint8 ids, four of int32 ids), a feature group a block with the group's
// window starts in shared memory, a grid of one wave, int32 atomics on
// int8 values and column fixed point on float values (one more launch
// first: each column's largest exponent over all rows).  A wave's 2W
// children go through one call of up to 128 lanes, so the bin matrix is
// read once a wave.  The TPU reference's two calls of W lanes come from
// its lane width; they are no semantics of the pass.
//
// What bounds it on an H100: bytes.  Every row's membership is read (the
// selector or the leaf vector), and, for the rows of the subsets, the bin
// matrix and the values; only the rows inside a window add, about 2 of the
// 16 coarse bins' worth, so the atomics are few beside kernel M's.  At a
// wave's densities (about a quarter of the rows in lanes) nearly every
// 32-byte sector of the feature-major bins holds a lane row.
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
  const SubsetWindowMap map{(const int32_t*)win_lo, (const int32_t*)miss_bin,
                            -1, nullptr};
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

namespace {

struct LanesTag {};    // names kernel V-lanes' launches in a profile

template <typename BinT, typename IdxT, int COLS>
cudaError_t lanes_hist(const void* bins, const LeafLanes<IdxT>& member,
                       const WindowMap& map, const void* vals, int val_int8,
                       int64_t n, int F, int R, int W, GroupPlan plan,
                       const int32_t* exp_max, int exp_blocks, void* partial,
                       float* out, cudaStream_t stream) {
  if (val_int8)
    return launch_group<LanesTag, BinT, int8_t, COLS>(
        bins, member, map, vals, n, F, R, W, plan, nullptr, 0, partial, out,
        stream);
  return launch_group<LanesTag, BinT, float, COLS>(
      bins, member, map, vals, n, F, R, W, plan, exp_max, exp_blocks,
      partial, out, stream);
}

template <typename BinT, typename IdxT>
cudaError_t lanes_by_cols(int two_col, const void* bins,
                          const LeafLanes<IdxT>& member, const WindowMap& map,
                          const void* vals, int val_int8, int64_t n, int F,
                          int R, int W, GroupPlan plan,
                          const int32_t* exp_max, int exp_blocks,
                          void* partial, float* out, cudaStream_t stream) {
  if (two_col)
    return lanes_hist<BinT, IdxT, 2>(bins, member, map, vals, val_int8, n, F,
                                     R, W, plan, exp_max, exp_blocks, partial,
                                     out, stream);
  return lanes_hist<BinT, IdxT, 3>(bins, member, map, vals, val_int8, n, F, R,
                                   W, plan, exp_max, exp_blocks, partial, out,
                                   stream);
}

template <typename IdxT>
cudaError_t lanes_by_bins(int bin_bytes, int two_col, const void* bins,
                          const LeafLanes<IdxT>& member, const WindowMap& map,
                          const void* vals, int val_int8, int64_t n, int F,
                          int R, int W, GroupPlan plan,
                          const int32_t* exp_max, int exp_blocks,
                          void* partial, float* out, cudaStream_t stream) {
  if (bin_bytes == 1)
    return lanes_by_cols<uint8_t, IdxT>(two_col, bins, member, map, vals,
                                        val_int8, n, F, R, W, plan, exp_max,
                                        exp_blocks, partial, out, stream);
  if (bin_bytes == 2)
    return lanes_by_cols<uint16_t, IdxT>(two_col, bins, member, map, vals,
                                         val_int8, n, F, R, W, plan, exp_max,
                                         exp_blocks, partial, out, stream);
  return cudaErrorInvalidValue;
}

template <typename BinT, typename IdxT>
const void* lanes_fn(int val_int8, int cols) {
#define LTT_FN(ValT, C)                                                \
  (const void*)group_hist_kernel<LanesTag, BinT, ValT, C,              \
                                 LeafLanes<IdxT>, WindowMap>
  if (val_int8) return cols == 2 ? LTT_FN(int8_t, 2) : LTT_FN(int8_t, 3);
  return cols == 2 ? LTT_FN(float, 2) : LTT_FN(float, 3);
#undef LTT_FN
}

}  // namespace

// Blocks of kernel V-lanes' histogram launch one SM runs at once with
// `smem` bytes of shared memory a block (negative: a CUDA error).
extern "C" int ltt_lanes_active_blocks(int bin_bytes, int idx_bytes,
                                       int val_int8, int cols, int smem) {
  if ((bin_bytes != 1 && bin_bytes != 2) || (idx_bytes != 1 &&
                                              idx_bytes != 4) ||
      (cols != 2 && cols != 3))
    return -(int)cudaErrorInvalidValue;
  const void* fn =
      bin_bytes == 1
          ? (idx_bytes == 1 ? lanes_fn<uint8_t, uint8_t>(val_int8, cols)
                            : lanes_fn<uint8_t, int32_t>(val_int8, cols))
          : (idx_bytes == 1 ? lanes_fn<uint16_t, uint8_t>(val_int8, cols)
                            : lanes_fn<uint16_t, int32_t>(val_int8, cols));
  return val_int8 ? group_active_blocks<int8_t>(fn, smem)
                  : group_active_blocks<float>(fn, smem);
}

// bins (F, N) uint8/int16; leaf_idx (N,) uint8/int32 with every id below
// leaf_bound (<= 32768), 16-byte aligned; lane_ids (W,) int32, W <= 128;
// vals (N, cols) int8/float32 (cols = 2 with two_col, else 3), 16-byte
// aligned; win_lo (W, F) int32; miss_bin (F,) int32 or null; out (W, F, R,
// 3) float32.  The plan (features per block, row blocks, rows per block:
// a multiple of 16, at most 2^22 with float values) comes from the
// wrapper (`group_plan`); `partial` holds row_blocks x F x W x R x cols
// int32 (int8 values) or float64; `exp_max` exp_blocks x cols int32
// scratch (float values only).
extern "C" int ltt_lanes_window_hist(const void* bins, int bin_bytes,
                                     const void* leaf_idx, int idx_bytes,
                                     const void* lane_ids, int leaf_bound,
                                     const void* vals, int val_int8,
                                     int two_col, const void* win_lo,
                                     const void* miss_bin, int64_t n,
                                     int num_features, int r_bins, int width,
                                     int feat_per_block, int row_blocks,
                                     int64_t rows_per_block, int exp_blocks,
                                     void* exp_max, void* partial, void* out,
                                     void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (width < 1 || width > kMaxGroupLanes || leaf_bound < 1 ||
      leaf_bound > 32768 || feat_per_block < 1 ||
      rows_per_block % kGroup != 0 || (uintptr_t)vals % 16 != 0 ||
      (uintptr_t)leaf_idx % 16 != 0 ||
      (!val_int8 && (exp_max == nullptr || exp_blocks < 1 ||
                     rows_per_block > ((int64_t)1 << 22))))
    return (int)cudaErrorInvalidValue;
  const int cols = two_col ? 2 : 3;
  int32_t* em = val_int8 ? nullptr : (int32_t*)exp_max;
  if (!val_int8) {
    const cudaError_t err = launch_exp_max<LanesTag>(
        (const float*)vals, cols, n, exp_blocks, em, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const WindowMap map{(const int32_t*)win_lo, (const int32_t*)miss_bin,
                      nullptr, nullptr, width};
  const int32_t* ids = (const int32_t*)lane_ids;
  const GroupPlan plan{feat_per_block, row_blocks, rows_per_block};
  float* o = (float*)out;
  cudaError_t err;
  if (idx_bytes == 1) {
    const LeafLanes<uint8_t> member{
        {(const uint8_t*)leaf_idx, ids, width, leaf_bound, nullptr}};
    err = lanes_by_bins<uint8_t>(bin_bytes, two_col, bins, member, map, vals,
                                 val_int8, n, num_features, r_bins, width,
                                 plan, em, exp_blocks, partial, o, stream);
  } else if (idx_bytes == 4) {
    const LeafLanes<int32_t> member{
        {(const int32_t*)leaf_idx, ids, width, leaf_bound, nullptr}};
    err = lanes_by_bins<int32_t>(bin_bytes, two_col, bins, member, map, vals,
                                 val_int8, n, num_features, r_bins, width,
                                 plan, em, exp_blocks, partial, o, stream);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
