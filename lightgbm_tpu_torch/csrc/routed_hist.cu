// Kernel R: row routing of a wave of splits, then the smaller children's
// histograms.
//
// Replaces the TPU kernel `histogram_pallas_multi_routed` /
// `_hist_kernel_multi_routed` with `_routed_parts`
// (lightgbm_tpu/ops/histogram.py:872, :783, :713) in mode "small", at full
// resolution (shift 0) or coarse (shift > 0: the coarse-to-fine wave,
// :831-836, :932-939).  The lane tables are a (5 or 6, W) int32 array:
//
//   row 0: the leaf each lane splits      row 1: its split column
//   row 2: its threshold bin              row 3: the new (right) leaf id
//   row 4: smaller child is the left one  row 5: default left (optional)
//
// Per row: lane = the lane whose leaf is the row's leaf (or none); the
// row goes left when its bin in the lane's column is <= the threshold, or,
// with row 5 and a per-feature missing bin, when the bin is the missing
// bin and the lane's default is left (histogram.py:740-749); a row going
// right takes the lane's new leaf id; the row is in subset `lane` when it
// goes to the smaller child.
//
// The TPU kernel resolved the lane, the column and the threshold with
// one-hot contractions on the MXU, because a per-row gather is slow there.
// Here a row reads its lane from a leaf -> lane table in shared memory and
// its split bin straight from the bin matrix.  Every feature's histogram
// block needs every row's lane, but the leaf vector must not change while
// another block still reads it, so this is two launches:
//
//   1. `route_kernel`, one thread per row: writes the new leaf vector and a
//      one-byte subset id (-1 = none), and the int32 selector when the
//      caller asks for it;
//   2. kernel M (`ltt_multi_hist`, multi_hist.cu) over that subset id.
//
// Routing always compares FINE bins; only the histogram half collapses
// them (`shift`, and the missing bin to the reserved last coarse slot).
//
// What bounds it on an H100: bytes.  Routing reads the leaf vector and,
// for the rows of the wave, one bin each (10.5 MB + at most 10.5 MB, plus
// 10.5 MB of leaf ids and subset ids written at 10.5M rows); the histogram
// reads the bin matrix, the values and the subset ids (294 + 21..31 +
// 10.5 MB).  The extra round trip of the subset ids (21 MB) is small
// beside the bin matrix.
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" int ltt_multi_hist(const void* bins, int bin_bytes, const void* sel,
                              int sel_bytes, const void* vals, int val_int8,
                              int val_cols, int two_col, int64_t n,
                              int num_features, int num_bins, int width,
                              int shift, const void* miss_bin, int row_blocks,
                              void* partial, void* out, void* stream_ptr);

namespace {

constexpr int kMaxLanes = 64;
constexpr int kMaxFeatures = 2048;

template <typename BinT, typename IdxT>
__global__ void route_kernel(const BinT* __restrict__ bins,
                             const IdxT* __restrict__ leaf_idx,
                             const int32_t* __restrict__ tables,
                             int table_rows, int width,
                             const int32_t* __restrict__ miss_bin,
                             int num_features, int leaf_bound, int64_t n,
                             IdxT* __restrict__ leaf_out,
                             int8_t* __restrict__ lane_out,
                             int32_t* __restrict__ sel_out) {
  extern __shared__ int8_t lane_of_leaf[];      // leaf_bound entries
  __shared__ int32_t l_feat[kMaxLanes], l_thr[kMaxLanes], l_new[kMaxLanes];
  __shared__ uint8_t l_small[kMaxLanes], l_dl[kMaxLanes];
  __shared__ int32_t mb[kMaxFeatures];
  for (int i = threadIdx.x; i < leaf_bound; i += blockDim.x)
    lane_of_leaf[i] = -1;
  const bool with_miss = table_rows >= 6 && miss_bin != nullptr;
  for (int w = threadIdx.x; w < width; w += blockDim.x) {
    l_feat[w] = tables[width + w];
    l_thr[w] = tables[2 * width + w];
    l_new[w] = tables[3 * width + w];
    l_small[w] = tables[4 * width + w] != 0;
    l_dl[w] = with_miss ? (tables[5 * width + w] != 0) : 0;
  }
  for (int f = threadIdx.x; f < num_features; f += blockDim.x)
    mb[f] = with_miss ? miss_bin[f] : -1;
  __syncthreads();
  if (threadIdx.x == 0) {
    // in lane order, so a leaf listed twice maps to its last lane (the
    // order of the reference's select chain); dummy lanes carry an id no
    // row holds
    for (int w = 0; w < width; ++w) {
      const int id = tables[w];
      if (id >= 0 && id < leaf_bound) lane_of_leaf[id] = (int8_t)w;
    }
  }
  __syncthreads();

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const int li = (int)leaf_idx[r];
    const int lane = (li >= 0 && li < leaf_bound) ? lane_of_leaf[li] : -1;
    int out_leaf = li;
    int sel = -1;
    if (lane >= 0) {
      const int feat = l_feat[lane];
      const int col = (int)bins[(int64_t)feat * n + r];
      bool gl = col <= l_thr[lane];
      if (l_dl[lane] && mb[feat] >= 0 && col == mb[feat]) gl = true;
      if (!gl) out_leaf = l_new[lane];
      if (gl == (l_small[lane] != 0)) sel = lane;
    }
    leaf_out[r] = (IdxT)out_leaf;
    lane_out[r] = (int8_t)sel;
    if (sel_out != nullptr) sel_out[r] = sel;
  }
}

template <typename BinT, typename IdxT>
cudaError_t route(const void* bins, const void* leaf_idx, const int32_t* tbl,
                  int table_rows, int width, const int32_t* miss_bin, int F,
                  int leaf_bound, int64_t n, int blocks, void* leaf_out,
                  int8_t* lane_out, int32_t* sel_out, cudaStream_t stream) {
  route_kernel<BinT, IdxT><<<blocks, 256, (size_t)leaf_bound, stream>>>(
      (const BinT*)bins, (const IdxT*)leaf_idx, tbl, table_rows, width,
      miss_bin, F, leaf_bound, n, (IdxT*)leaf_out, lane_out, sel_out);
  return cudaGetLastError();
}

}  // namespace

// bins (F, N) uint8/int16; vals (N, val_cols) int8/float32; leaf_idx (N,)
// uint8/int32 with ids < leaf_bound; tables (table_rows, W) int32;
// miss_bin (F,) int32 or null.  Writes leaf_out (N,) (same type as
// leaf_idx), lane (N,) int8 scratch, sel_out (N,) int32 when not null, and
// out (W, F, B, 3) float32 through kernel M, B the bin count at `shift`.
extern "C" int ltt_routed_hist(const void* bins, int bin_bytes,
                               const void* vals, int val_int8, int val_cols,
                               int two_col, const void* leaf_idx,
                               int idx_bytes, const void* tables,
                               int table_rows, const void* miss_bin,
                               int leaf_bound, int64_t n, int num_features,
                               int num_bins, int width, int shift,
                               int route_blocks, int row_blocks,
                               void* leaf_out, void* lane,
                               void* sel_out, void* partial, void* out,
                               void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (width < 1 || width > kMaxLanes || num_features > kMaxFeatures ||
      table_rows < 5 || leaf_bound < 1 || leaf_bound > 32768)
    return (int)cudaErrorInvalidValue;
  const int32_t* tbl = (const int32_t*)tables;
  const int32_t* mb = (const int32_t*)miss_bin;
  int8_t* ln = (int8_t*)lane;
  int32_t* so = (int32_t*)sel_out;
  cudaError_t err;
  if (bin_bytes == 1 && idx_bytes == 1) {
    err = route<uint8_t, uint8_t>(bins, leaf_idx, tbl, table_rows, width, mb,
                                  num_features, leaf_bound, n, route_blocks,
                                  leaf_out, ln, so, stream);
  } else if (bin_bytes == 1 && idx_bytes == 4) {
    err = route<uint8_t, int32_t>(bins, leaf_idx, tbl, table_rows, width, mb,
                                  num_features, leaf_bound, n, route_blocks,
                                  leaf_out, ln, so, stream);
  } else if (bin_bytes == 2 && idx_bytes == 1) {
    err = route<uint16_t, uint8_t>(bins, leaf_idx, tbl, table_rows, width, mb,
                                   num_features, leaf_bound, n, route_blocks,
                                   leaf_out, ln, so, stream);
  } else if (bin_bytes == 2 && idx_bytes == 4) {
    err = route<uint16_t, int32_t>(bins, leaf_idx, tbl, table_rows, width, mb,
                                   num_features, leaf_bound, n, route_blocks,
                                   leaf_out, ln, so, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return ltt_multi_hist(bins, bin_bytes, lane, 1, vals, val_int8, val_cols,
                        two_col, n, num_features, num_bins, width, shift,
                        miss_bin, row_blocks, partial, out, stream);
}
