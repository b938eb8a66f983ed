// Kernels V and V-lanes: windowed fine histograms of row-disjoint subsets,
// the refine passes of coarse-to-fine split finding.
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
//
// Both run on the histogram body of kernels R and M (group_hist.cuh), up
// to 128 lanes, with the window map as the body's bin map (a feature
// group a block, the group's window starts in shared memory): 16-row
// groups, a grid of one wave, int32 atomics on int8 values and column
// fixed point on float values (one more launch first: each column's
// largest exponent over all rows), fixed-order partials, so a repeat
// launch gives the same bits.  They differ in the membership:
// - V reads a one-byte subset id a row (`ByteLanes`, as kernel M; the
//   wrapper narrows an int32 selector first).  The c2f loop launches it
//   once a tree, at the root's window (W = 1, every row in lane 0).
// - V-lanes maps 16 leaf ids at a time through a leaf -> lane table (int8,
//   built per block in lane order) in shared memory (one 16-byte load of
//   uint8 ids, four of int32 ids).  A wave's 2W children go through one
//   call, so the bin matrix is read once a wave.  The TPU reference's two
//   calls of W lanes come from its lane width; they are no semantics of
//   the pass.
//
// What bounds them on an H100: bytes.  Every row's membership is read (the
// selector or the leaf vector), and, for the rows of the subsets, the bin
// matrix and the values; only the rows inside a window add, about 2 of the
// 16 coarse bins' worth, so the atomics are few beside kernel M's.  At a
// wave's densities (about a quarter of the rows in lanes) nearly every
// 32-byte sector of the feature-major bins holds a lane row.
#include "group_hist.cuh"

namespace {

struct WindowTag {};   // names kernel V's launches in a profile
struct LanesTag {};    // names kernel V-lanes' launches in a profile

template <typename Tag, typename BinT, typename Member, int COLS>
cudaError_t window_pass(const void* bins, const Member& member,
                        const WindowMap& map, const void* vals, int val_int8,
                        int64_t n, int F, int R, int W, GroupPlan plan,
                        const int32_t* exp_max, int exp_blocks, void* partial,
                        float* out, cudaStream_t stream) {
  if (val_int8)
    return launch_group<Tag, BinT, int8_t, COLS>(
        bins, member, map, vals, n, F, R, W, plan, nullptr, 0, partial, out,
        stream);
  return launch_group<Tag, BinT, float, COLS>(
      bins, member, map, vals, n, F, R, W, plan, exp_max, exp_blocks,
      partial, out, stream);
}

// The bin matrix's element type (uint8, or int16 read as uint16) and the
// value columns.
template <typename Tag, typename Member>
cudaError_t window_dispatch(int bin_bytes, int two_col, const void* bins,
                            const Member& member, const WindowMap& map,
                            const void* vals, int val_int8, int64_t n, int F,
                            int R, int W, GroupPlan plan,
                            const int32_t* exp_max, int exp_blocks,
                            void* partial, float* out, cudaStream_t stream) {
#define LTT_PASS(BinT, COLS)                                                 \
  window_pass<Tag, BinT, Member, COLS>(bins, member, map, vals, val_int8, n, \
                                       F, R, W, plan, exp_max, exp_blocks,   \
                                       partial, out, stream)
  if (bin_bytes == 1) return two_col ? LTT_PASS(uint8_t, 2)
                                     : LTT_PASS(uint8_t, 3);
  if (bin_bytes == 2) return two_col ? LTT_PASS(uint16_t, 2)
                                     : LTT_PASS(uint16_t, 3);
#undef LTT_PASS
  return cudaErrorInvalidValue;
}

template <typename Tag, typename BinT, typename Member>
const void* window_fn(int val_int8, int cols) {
#define LTT_FN(ValT, C)                                                \
  (const void*)group_hist_kernel<Tag, BinT, ValT, C, Member, WindowMap>
  if (val_int8) return cols == 2 ? LTT_FN(int8_t, 2) : LTT_FN(int8_t, 3);
  return cols == 2 ? LTT_FN(float, 2) : LTT_FN(float, 3);
#undef LTT_FN
}

// Blocks of one windowed histogram launch an SM runs at once with `smem`
// bytes of shared memory a block (negative: a CUDA error).
template <typename Tag, typename Member>
int window_active_blocks(int bin_bytes, int val_int8, int cols, int smem) {
  if ((bin_bytes != 1 && bin_bytes != 2) || (cols != 2 && cols != 3))
    return -(int)cudaErrorInvalidValue;
  const void* fn = bin_bytes == 1
                       ? window_fn<Tag, uint8_t, Member>(val_int8, cols)
                       : window_fn<Tag, uint16_t, Member>(val_int8, cols);
  return val_int8 ? group_active_blocks<int8_t>(fn, smem)
                  : group_active_blocks<float>(fn, smem);
}

// The checks both launches share; then, for float values, the exponent
// launch (`em` the scratch, or null for int8 values).
template <typename Tag>
cudaError_t window_prologue(const void* vals, int val_int8, int two_col,
                            int64_t n, int width, int feat_per_block,
                            int64_t rows_per_block, int exp_blocks,
                            void* exp_max, int32_t** em,
                            cudaStream_t stream) {
  if (width < 1 || width > kMaxGroupLanes || feat_per_block < 1 ||
      rows_per_block % kGroup != 0 || (uintptr_t)vals % 16 != 0 ||
      (!val_int8 && (exp_max == nullptr || exp_blocks < 1 ||
                     rows_per_block > ((int64_t)1 << 22))))
    return cudaErrorInvalidValue;
  *em = val_int8 ? nullptr : (int32_t*)exp_max;
  if (val_int8) return cudaSuccess;
  return launch_exp_max<Tag>((const float*)vals, two_col ? 2 : 3, n,
                             exp_blocks, *em, stream);
}

}  // namespace

// Blocks of kernel V's histogram launch one SM runs at once with `smem`
// bytes of shared memory a block (negative: a CUDA error).
extern "C" int ltt_window_active_blocks(int bin_bytes, int val_int8, int cols,
                                        int smem) {
  return window_active_blocks<WindowTag, ByteLanes>(bin_bytes, val_int8, cols,
                                                    smem);
}

// Blocks of kernel V-lanes' histogram launch one SM runs at once.
extern "C" int ltt_lanes_active_blocks(int bin_bytes, int idx_bytes,
                                       int val_int8, int cols, int smem) {
  if (idx_bytes == 1)
    return window_active_blocks<LanesTag, LeafLanes<uint8_t>>(
        bin_bytes, val_int8, cols, smem);
  if (idx_bytes == 4)
    return window_active_blocks<LanesTag, LeafLanes<int32_t>>(
        bin_bytes, val_int8, cols, smem);
  return -(int)cudaErrorInvalidValue;
}

// Kernel V.  bins (F, N) uint8/int16; sel (N,) int8 with every id in [-1,
// width), 16-byte aligned; vals (N, cols) int8/float32 (cols = 2 with
// two_col, else 3), 16-byte aligned; win_lo (W, F) int32, W <= 128;
// miss_bin (F,) int32 or null; out (W, F, R, 3) float32.  The plan
// (features per block, row blocks, rows per block: a multiple of 16, at
// most 2^22 with float values) comes from the wrapper (`group_plan`);
// `partial` holds row_blocks x F x W x R x cols int32 (int8 values) or
// float64; `exp_max` exp_blocks x cols int32 scratch (float values only).
extern "C" int ltt_window_hist(const void* bins, int bin_bytes,
                               const void* sel, const void* vals,
                               int val_int8, int two_col, const void* win_lo,
                               const void* miss_bin, int64_t n,
                               int num_features, int r_bins, int width,
                               int feat_per_block, int row_blocks,
                               int64_t rows_per_block, int exp_blocks,
                               void* exp_max, void* partial, void* out,
                               void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if ((uintptr_t)sel % 16 != 0) return (int)cudaErrorInvalidValue;
  int32_t* em = nullptr;
  cudaError_t err = window_prologue<WindowTag>(
      vals, val_int8, two_col, n, width, feat_per_block, rows_per_block,
      exp_blocks, exp_max, &em, stream);
  if (err != cudaSuccess) return (int)err;
  const WindowMap map{(const int32_t*)win_lo, (const int32_t*)miss_bin,
                      nullptr, nullptr, width};
  const GroupPlan plan{feat_per_block, row_blocks, rows_per_block};
  return (int)window_dispatch<WindowTag>(
      bin_bytes, two_col, bins, ByteLanes{(const int8_t*)sel}, map, vals,
      val_int8, n, num_features, r_bins, width, plan, em, exp_blocks, partial,
      (float*)out, stream);
}

// Kernel V-lanes.  bins, vals, win_lo, miss_bin, out, the plan and the
// scratch as for kernel V; leaf_idx (N,) uint8/int32 with every id below
// leaf_bound (<= 32768), 16-byte aligned; lane_ids (W,) int32, W <= 128.
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
  if (leaf_bound < 1 || leaf_bound > 32768 || (uintptr_t)leaf_idx % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int32_t* em = nullptr;
  cudaError_t err = window_prologue<LanesTag>(
      vals, val_int8, two_col, n, width, feat_per_block, rows_per_block,
      exp_blocks, exp_max, &em, stream);
  if (err != cudaSuccess) return (int)err;
  const WindowMap map{(const int32_t*)win_lo, (const int32_t*)miss_bin,
                      nullptr, nullptr, width};
  const int32_t* ids = (const int32_t*)lane_ids;
  const GroupPlan plan{feat_per_block, row_blocks, rows_per_block};
  float* o = (float*)out;
  if (idx_bytes == 1) {
    const LeafLanes<uint8_t> member{
        {(const uint8_t*)leaf_idx, ids, width, leaf_bound, nullptr}};
    return (int)window_dispatch<LanesTag>(
        bin_bytes, two_col, bins, member, map, vals, val_int8, n,
        num_features, r_bins, width, plan, em, exp_blocks, partial, o,
        stream);
  }
  if (idx_bytes == 4) {
    const LeafLanes<int32_t> member{
        {(const int32_t*)leaf_idx, ids, width, leaf_bound, nullptr}};
    return (int)window_dispatch<LanesTag>(
        bin_bytes, two_col, bins, member, map, vals, val_int8, n,
        num_features, r_bins, width, plan, em, exp_blocks, partial, o,
        stream);
  }
  return (int)cudaErrorInvalidValue;
}
