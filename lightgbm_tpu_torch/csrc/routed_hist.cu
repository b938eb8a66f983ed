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
// goes to the smaller child.  Then, per subset s, feature f and column c:
//
//   b = (bins[f, r] == miss_bin[f]) ? Bc - 1 : bins[f, r] >> shift
//   out[s, f, b, c] += vals[r, c]
//
// (the missing bin goes to the reserved last coarse slot only with a
// shift); with `two_col` the count channel of the output is a copy of hess.
//
// The TPU kernel resolved the lane, the column and the threshold with
// one-hot contractions on the MXU, because a per-row gather is slow there.
// Here a row reads its lane from a leaf -> lane table in shared memory and
// its split bin straight from the bin matrix.  Every feature's histogram
// block needs every row's lane, but the leaf vector must not change while
// another block still reads it, so routing is a launch of its own:
//
//   1. `route_kernel`, one thread per row: writes the new leaf vector, a
//      one-byte subset id (-1 = none) and, when the caller asks for it, the
//      int32 selector; with float values, each block's largest exponent of
//      each column over its selected rows.  Routing always compares FINE
//      bins.
//   2. the histogram over the subset ids, on the body shared with kernels
//      M and V-lanes (group_hist.cuh: 16-row groups with 16-byte loads, a
//      feature group a block, a grid of one wave, fixed-point float sums),
//      then its fixed-order reduction over row blocks.
//
// What bounds it on an H100: bytes, and in practice the latency of the
// row scan.  A pass must read the bin matrix (294 MB at 10.5M x 28, feature
// major, so at a wave's row densities every 32-byte sector holds a row of
// the smaller children) and the subset ids and values of the rows: about
// 0.1 ms at 3.35 TB/s.  Where tiles are small (coarse: 64 x 17 x 2 int32 =
// 8.7 KB a feature) a block takes many features, and each subset word it
// loads serves all of them; at full resolution (131 KB int8, 194 KB float
// at W = 21) it takes one.  Float values are summed in the shared body's
// column fixed point, with each column's scale from the routing blocks'
// largest exponents over the selected rows.
#include "group_hist.cuh"

namespace {

constexpr int kMaxLanes = 64;
constexpr int kMaxFeatures = 2048;

struct RoutedTag {};   // names kernel R's histogram launches in a profile

// ---- 1. routing ------------------------------------------------------

// `fvals` (n, cols) float32 or null: with it, block b writes the largest
// exponent of each column over its selected rows to exp_max[b * cols + c].
template <typename BinT, typename IdxT>
__global__ void route_kernel(const BinT* __restrict__ bins,
                             const IdxT* __restrict__ leaf_idx,
                             const int32_t* __restrict__ tables,
                             int table_rows, int width,
                             const int32_t* __restrict__ miss_bin,
                             int num_features, int leaf_bound, int64_t n,
                             const float* __restrict__ fvals, int cols,
                             IdxT* __restrict__ leaf_out,
                             int8_t* __restrict__ lane_out,
                             int32_t* __restrict__ sel_out,
                             int32_t* __restrict__ exp_max) {
  extern __shared__ int8_t lane_of_leaf[];      // leaf_bound entries
  __shared__ int32_t l_feat[kMaxLanes], l_thr[kMaxLanes], l_new[kMaxLanes];
  __shared__ uint8_t l_small[kMaxLanes], l_dl[kMaxLanes];
  __shared__ int32_t mb[kMaxFeatures];
  __shared__ int32_t emax[3];
  for (int i = threadIdx.x; i < leaf_bound; i += blockDim.x)
    lane_of_leaf[i] = -1;
  if (threadIdx.x < 3) emax[threadIdx.x] = 0;
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

  int e0 = 0, e1 = 0, e2 = 0;
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
    if (fvals != nullptr && sel >= 0) {
      const float* v = fvals + r * cols;
      e0 = max(e0, exp_bits(v[0]));
      e1 = max(e1, exp_bits(v[1]));
      if (cols == 3) e2 = max(e2, exp_bits(v[2]));
    }
  }
  if (fvals == nullptr) return;
  e0 = __reduce_max_sync(0xffffffffu, e0);
  e1 = __reduce_max_sync(0xffffffffu, e1);
  e2 = __reduce_max_sync(0xffffffffu, e2);
  if ((threadIdx.x & 31) == 0) {
    atomicMax(&emax[0], e0);
    atomicMax(&emax[1], e1);
    atomicMax(&emax[2], e2);
  }
  __syncthreads();
  if (threadIdx.x < cols)
    exp_max[(int64_t)blockIdx.x * cols + threadIdx.x] = emax[threadIdx.x];
}

// ---- 2. the histogram, on the shared body ---------------------------------

template <typename BinT, int COLS>
cudaError_t routed_hist(int val_int8, const void* bins, const int8_t* lanes,
                        const void* vals, const int32_t* miss_bin, int shift,
                        int64_t n, int F, int B, int W, GroupPlan plan,
                        const int32_t* exp_max, int route_blocks,
                        void* partial, float* out, cudaStream_t stream) {
  const ByteLanes member{lanes};
  const CoarseMap map{shift, miss_bin, B - 1, nullptr};
  if (val_int8)
    return launch_group<RoutedTag, BinT, int8_t, COLS>(
        bins, member, map, vals, n, F, B, W, plan, nullptr, 0, partial, out,
        stream);
  return launch_group<RoutedTag, BinT, float, COLS>(
      bins, member, map, vals, n, F, B, W, plan, exp_max, route_blocks,
      partial, out, stream);
}

template <typename BinT, typename IdxT>
cudaError_t route(const void* bins, const void* leaf_idx, const int32_t* tbl,
                  int table_rows, int width, const int32_t* miss_bin, int F,
                  int leaf_bound, int64_t n, const float* fvals, int cols,
                  int blocks, void* leaf_out, int8_t* lane_out,
                  int32_t* sel_out, int32_t* exp_max, cudaStream_t stream) {
  route_kernel<BinT, IdxT><<<blocks, 256, (size_t)leaf_bound, stream>>>(
      (const BinT*)bins, (const IdxT*)leaf_idx, tbl, table_rows, width,
      miss_bin, F, leaf_bound, n, fvals, cols, (IdxT*)leaf_out, lane_out,
      sel_out, exp_max);
  return cudaGetLastError();
}

template <typename BinT>
const void* hist_fn(int val_int8, int cols) {
#define LTT_FN(ValT, C)                                               \
  (const void*)group_hist_kernel<RoutedTag, BinT, ValT, C, ByteLanes, \
                                 CoarseMap>
  if (val_int8) return cols == 2 ? LTT_FN(int8_t, 2) : LTT_FN(int8_t, 3);
  return cols == 2 ? LTT_FN(float, 2) : LTT_FN(float, 3);
#undef LTT_FN
}

}  // namespace

// Blocks of the histogram kernel one SM runs at once with `smem` bytes of
// shared memory a block (negative: a CUDA error).
extern "C" int ltt_routed_active_blocks(int bin_bytes, int val_int8,
                                        int cols, int smem) {
  if ((bin_bytes != 1 && bin_bytes != 2) || (cols != 2 && cols != 3))
    return -(int)cudaErrorInvalidValue;
  const void* fn = bin_bytes == 1 ? hist_fn<uint8_t>(val_int8, cols)
                                  : hist_fn<uint16_t>(val_int8, cols);
  return val_int8 ? group_active_blocks<int8_t>(fn, smem)
                  : group_active_blocks<float>(fn, smem);
}

// bins (F, N) uint8/int16; vals (N, cols) int8/float32 (cols = 2 with
// two_col, else 3), 16-byte aligned; leaf_idx (N,) uint8/int32 with ids <
// leaf_bound; tables (table_rows, W) int32; miss_bin (F,) int32 or null.
// Writes leaf_out (N,) (the type of leaf_idx), lane (N,) int8 scratch
// (16-byte aligned), sel_out (N,) int32 when not null, and out (W, F, B, 3)
// float32, B the bin count at `shift`.  The plan (features per block, row
// blocks, rows per block: a multiple of 16, at most 2^22 with float
// values) comes from the wrapper (`group_plan` in ops/histogram.py);
// `partial` holds row_blocks x F x W x B x cols int32 (int8 values) or
// float64 (float values); `exp_max` route_blocks x cols int32 scratch
// (float values only).
extern "C" int ltt_routed_hist(const void* bins, int bin_bytes,
                               const void* vals, int val_int8, int two_col,
                               const void* leaf_idx, int idx_bytes,
                               const void* tables, int table_rows,
                               const void* miss_bin, int leaf_bound,
                               int64_t n, int num_features, int num_bins,
                               int width, int shift, int route_blocks,
                               int feat_per_block, int row_blocks,
                               int64_t rows_per_block, void* leaf_out,
                               void* lane, void* sel_out, void* exp_max,
                               void* partial, void* out, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (width < 1 || width > kMaxLanes || num_features > kMaxFeatures ||
      table_rows < 5 || leaf_bound < 1 || leaf_bound > 32768 || shift < 0 ||
      shift > 15 || feat_per_block < 1 || rows_per_block % kGroup != 0 ||
      (uintptr_t)vals % 16 != 0 || (uintptr_t)lane % 16 != 0 ||
      (!val_int8 && (exp_max == nullptr ||
                     rows_per_block > ((int64_t)1 << 22))))
    return (int)cudaErrorInvalidValue;
  const int32_t* tbl = (const int32_t*)tables;
  const int32_t* mb = (const int32_t*)miss_bin;
  int8_t* ln = (int8_t*)lane;
  int32_t* so = (int32_t*)sel_out;
  const int cols = two_col ? 2 : 3;
  const float* fv = val_int8 ? nullptr : (const float*)vals;
  int32_t* em = val_int8 ? nullptr : (int32_t*)exp_max;
  cudaError_t err;
  if (bin_bytes == 1 && idx_bytes == 1) {
    err = route<uint8_t, uint8_t>(bins, leaf_idx, tbl, table_rows, width, mb,
                                  num_features, leaf_bound, n, fv, cols,
                                  route_blocks, leaf_out, ln, so, em, stream);
  } else if (bin_bytes == 1 && idx_bytes == 4) {
    err = route<uint8_t, int32_t>(bins, leaf_idx, tbl, table_rows, width, mb,
                                  num_features, leaf_bound, n, fv, cols,
                                  route_blocks, leaf_out, ln, so, em, stream);
  } else if (bin_bytes == 2 && idx_bytes == 1) {
    err = route<uint16_t, uint8_t>(bins, leaf_idx, tbl, table_rows, width, mb,
                                   num_features, leaf_bound, n, fv, cols,
                                   route_blocks, leaf_out, ln, so, em,
                                   stream);
  } else if (bin_bytes == 2 && idx_bytes == 4) {
    err = route<uint16_t, int32_t>(bins, leaf_idx, tbl, table_rows, width, mb,
                                   num_features, leaf_bound, n, fv, cols,
                                   route_blocks, leaf_out, ln, so, em,
                                   stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int32_t* hmb = shift > 0 ? mb : nullptr;
  float* o = (float*)out;
  const GroupPlan plan{feat_per_block, row_blocks, rows_per_block};
#define LTT_ROUTED(BinT, COLS)                                              \
  routed_hist<BinT, COLS>(val_int8, bins, ln, vals, hmb, shift, n,          \
                          num_features, num_bins, width, plan, em,          \
                          route_blocks, partial, o, stream)
  if (bin_bytes == 1)
    err = two_col ? LTT_ROUTED(uint8_t, 2) : LTT_ROUTED(uint8_t, 3);
  else
    err = two_col ? LTT_ROUTED(uint16_t, 2) : LTT_ROUTED(uint16_t, 3);
#undef LTT_ROUTED
  return (int)err;
}
