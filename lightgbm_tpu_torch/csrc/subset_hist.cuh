// The accumulation body of kernel V: histograms of up to 64 row-disjoint
// subsets, one block per (feature, row range).  (Kernels R, M and V-lanes
// run on the body over 16-row groups in group_hist.cuh.)
//
// A row adds its values to one (subset, bin) cell of the block's feature:
// the subset is s = sel[r] (-1 = no subset, `SelMember`), the cell b =
// bin - win_lo[s, f], kept when it lies in [0, R) and the bin is not the
// feature's missing bin (`SubsetWindowMap`).
//
// The block keeps its feature's (W, B, cols) tile in dynamic shared memory
// and adds with atomics: int32 for int8 values (exact and independent of
// the order of the atomics), float64 for float values.  Each block writes
// its tile as a partial; `subset_reduce_kernel` adds the partials of a
// cell in row-block order (int64 or float64) and rounds once to float32,
// so the result is the same on every run and equals the plain versions
// (float64 `index_add_`) bit for bit on integer values.  With two columns
// only grad and hess are summed and the count channel of the output is a
// copy of hess.
#pragma once

#include "group_hist.cuh"

namespace {

constexpr int kSubsetThreads = 1024;
constexpr int kMaxSubsets = 64;

template <typename SelT>
struct SelMember {
  const SelT* sel;
  int width;
  __host__ __device__ size_t smem_bytes() const { return 0; }
  __device__ void init(unsigned char*) {}
  __device__ int lane(int64_t r) const {
    const int s = (int)sel[r];
    return s < width ? s : -1;
  }
};

struct SubsetWindowMap {
  const int32_t* win_lo;     // (W, F)
  const int32_t* miss_bin;   // (F,) or null
  int mb;
  int* lo;                   // win_lo[:, f], in shared memory
  __host__ __device__ size_t smem_bytes(int width) const {
    return (size_t)width * sizeof(int);
  }
  __device__ void init(int f, int width, int num_features,
                       unsigned char* smem) {
    lo = reinterpret_cast<int*>(smem);
    for (int s = threadIdx.x; s < width; s += blockDim.x)
      lo[s] = win_lo[(int64_t)s * num_features + f];
    mb = miss_bin != nullptr ? miss_bin[f] : -1;
  }
  __device__ int bin(int b, int s) const { return b == mb ? -1 : b - lo[s]; }
};

template <typename BinT, typename ValT, typename AccT, typename Member,
          typename Map>
__global__ void __launch_bounds__(kSubsetThreads, 1)
subset_hist_kernel(const BinT* __restrict__ bins, Member member, Map map,
                   const ValT* __restrict__ vals, int val_cols, int cols,
                   int64_t n, int num_bins, int width, int64_t rows_per_block,
                   AccT* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char sh_raw[];
  AccT* sh = reinterpret_cast<AccT*>(sh_raw);
  const int f = blockIdx.x;
  const int num_features = gridDim.x;
  const int cells = width * num_bins * cols;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) sh[i] = AccT(0);
  unsigned char* extra = sh_raw + align16((size_t)cells * sizeof(AccT));
  member.init(extra);
  map.init(f, width, num_features, extra + align16(member.smem_bytes()));
  __syncthreads();

  const int64_t lo = (int64_t)blockIdx.y * rows_per_block;
  const int64_t hi = lo + rows_per_block < n ? lo + rows_per_block : n;
  const BinT* brow = bins + (int64_t)f * n;
  for (int64_t r = lo + threadIdx.x; r < hi; r += blockDim.x) {
    const int s = member.lane(r);
    if (s < 0) continue;
    const int b = map.bin((int)brow[r], s);
    if ((unsigned)b >= (unsigned)num_bins) continue;
    AccT* cell = sh + (s * num_bins + b) * cols;
    const ValT* v = vals + r * val_cols;
    for (int c = 0; c < cols; ++c) atomicAdd(cell + c, (AccT)v[c]);
  }
  __syncthreads();

  // partial layout: (row block, feature, subset, bin, column)
  AccT* out = partial + ((int64_t)blockIdx.y * num_features + f) * cells;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) out[i] = sh[i];
}

// Fixed-order reduction over row blocks; writes (W, F, B, 3) float32 with
// the count channel a copy of hess when cols == 2.
template <typename AccT, typename SumT>
__global__ void subset_reduce_kernel(const AccT* __restrict__ partial,
                                     int row_blocks, int num_features,
                                     int width, int num_bins, int cols,
                                     float* __restrict__ out) {
  const int64_t cells = (int64_t)width * num_bins * cols;
  const int64_t total = cells * num_features;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  SumT s = SumT(0);
  for (int r = 0; r < row_blocks; ++r) s += (SumT)partial[(int64_t)r * total + i];
  // i = ((f * W + w) * B + b) * cols + c
  const int c = (int)(i % cols);
  const int64_t fwb = i / cols;
  const int b = (int)(fwb % num_bins);
  const int64_t fw = fwb / num_bins;
  const int w = (int)(fw % width);
  const int f = (int)(fw / width);
  float* o = out + (((int64_t)w * num_features + f) * num_bins + b) * 3;
  o[c] = (float)s;
  if (cols == 2 && c == 1) o[2] = (float)s;
}

template <typename BinT, typename ValT, typename AccT, typename SumT,
          typename Member, typename Map>
cudaError_t launch_subset(const void* bins, Member member, Map map,
                          const void* vals, int val_cols, int cols, int64_t n,
                          int F, int B, int W, int row_blocks, void* partial,
                          float* out, cudaStream_t stream) {
  const size_t smem = align16((size_t)W * B * cols * sizeof(AccT)) +
                      align16(member.smem_bytes()) + map.smem_bytes(W);
  auto kern = subset_hist_kernel<BinT, ValT, AccT, Member, Map>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t rows_per_block = (n + row_blocks - 1) / row_blocks;
  kern<<<dim3(F, row_blocks), kSubsetThreads, smem, stream>>>(
      (const BinT*)bins, member, map, (const ValT*)vals, val_cols, cols, n, B,
      W, rows_per_block, (AccT*)partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = (int64_t)F * W * B * cols;
  const int rt = 256;
  subset_reduce_kernel<AccT, SumT><<<(unsigned)((total + rt - 1) / rt), rt, 0,
                                     stream>>>((const AccT*)partial,
                                               row_blocks, F, W, B, cols, out);
  return cudaGetLastError();
}

// int8 values accumulate in int32 and reduce in int64; float values in
// float64 throughout.
template <typename BinT, typename Member, typename Map>
cudaError_t subset_by_values(const void* bins, Member member, Map map,
                             const void* vals, int val_int8, int val_cols,
                             int cols, int64_t n, int F, int B, int W,
                             int row_blocks, void* partial, float* out,
                             cudaStream_t stream) {
  if (val_int8)
    return launch_subset<BinT, int8_t, int, long long>(
        bins, member, map, vals, val_cols, cols, n, F, B, W, row_blocks,
        partial, out, stream);
  return launch_subset<BinT, float, double, double>(
      bins, member, map, vals, val_cols, cols, n, F, B, W, row_blocks,
      partial, out, stream);
}

// The bin matrix's element type: uint8 or int16 (read as uint16).
template <typename Member, typename Map>
cudaError_t subset_by_bins(const void* bins, int bin_bytes, Member member,
                           Map map, const void* vals, int val_int8,
                           int val_cols, int cols, int64_t n, int F, int B,
                           int W, int row_blocks, void* partial, float* out,
                           cudaStream_t stream) {
  if (bin_bytes == 1)
    return subset_by_values<uint8_t>(bins, member, map, vals, val_int8,
                                     val_cols, cols, n, F, B, W, row_blocks,
                                     partial, out, stream);
  if (bin_bytes == 2)
    return subset_by_values<uint16_t>(bins, member, map, vals, val_int8,
                                      val_cols, cols, n, F, B, W, row_blocks,
                                      partial, out, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
