// Kernel Q: exact per-leaf sums for the quantized leaf renewal.
//
// Replaces the TPU kernel `leaf_stats_pallas` / `_leaf_stats_kernel`
// (lightgbm_tpu/ops/histogram.py:1239, :1214), and the generic histogram
// over leaf ids the JAX package uses beyond 256 leaves
// (lightgbm_tpu/ops/grow.py:1787-1790):
//
//   m = mask[r]
//   out[leaf_idx[r], :] += [grad[r] * m, hess[r] * m, m]
//
// The TPU form split the leaf id into nibbles and each float into bf16
// hi/lo parts for the MXU (about 2^-16 relative accuracy).  Here the mask
// is applied in the kernel, each block accumulates its contiguous row
// range into a (leaves, 3) float64 table in shared memory with atomics,
// writes it as a partial, and a second kernel adds the partials in block
// order and rounds once to float32: the same sums as the plain version
// (float64 index_add_), whatever the order of the atomics.
//
// What bounds it on an H100: bytes.  One pass reads the leaf ids and three
// float32 vectors: 13 bytes a row with uint8 ids, 136.5 MB at 10.5M rows,
// about 41 us at 3.35 TB/s.  Shared-memory atomics on 255 x 3 cells
// contend where many rows of a warp share a leaf; per-warp tables are
// later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

template <typename IdxT>
__global__ void __launch_bounds__(kThreads)
leaf_stats_kernel(const IdxT* __restrict__ leaf_idx,
                  const float* __restrict__ grad,
                  const float* __restrict__ hess,
                  const float* __restrict__ mask, int64_t n, int num_leaves,
                  int64_t rows_per_block, double* __restrict__ partial) {
  extern __shared__ double acc[];
  const int cells = num_leaves * 3;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) acc[i] = 0.0;
  __syncthreads();
  const int64_t lo = (int64_t)blockIdx.x * rows_per_block;
  const int64_t hi = lo + rows_per_block < n ? lo + rows_per_block : n;
  for (int64_t r = lo + threadIdx.x; r < hi; r += blockDim.x) {
    const int l = (int)leaf_idx[r];
    if (l < 0 || l >= num_leaves) continue;
    const float m = mask[r];
    double* cell = acc + l * 3;
    atomicAdd(cell, (double)(grad[r] * m));
    atomicAdd(cell + 1, (double)(hess[r] * m));
    atomicAdd(cell + 2, (double)m);
  }
  __syncthreads();
  double* out = partial + (int64_t)blockIdx.x * cells;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) out[i] = acc[i];
}

__global__ void leaf_stats_reduce_kernel(const double* __restrict__ partial,
                                         int row_blocks, int cells,
                                         float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  double s = 0.0;
  for (int r = 0; r < row_blocks; ++r) s += partial[(int64_t)r * cells + i];
  out[i] = (float)s;
}

template <typename IdxT>
cudaError_t launch(const void* leaf_idx, const float* g, const float* h,
                   const float* m, int64_t n, int num_leaves, int row_blocks,
                   double* partial, cudaStream_t stream) {
  const size_t smem = (size_t)num_leaves * 3 * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      leaf_stats_kernel<IdxT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t rows_per_block = (n + row_blocks - 1) / row_blocks;
  leaf_stats_kernel<IdxT><<<row_blocks, kThreads, smem, stream>>>(
      (const IdxT*)leaf_idx, g, h, m, n, num_leaves, rows_per_block, partial);
  return cudaGetLastError();
}

}  // namespace

// leaf_idx (N,) uint8/int32; grad/hess/mask (N,) float32; out (L, 3)
// float32; partial row_blocks x L x 3 float64.  Rows with an id outside
// [0, L) are skipped.
extern "C" int ltt_leaf_stats(const void* leaf_idx, int idx_bytes,
                              const void* grad, const void* hess,
                              const void* mask, int64_t n, int num_leaves,
                              int row_blocks, void* partial, void* out,
                              void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const float* g = (const float*)grad;
  const float* h = (const float*)hess;
  const float* m = (const float*)mask;
  double* part = (double*)partial;
  cudaError_t err;
  if (idx_bytes == 1) {
    err = launch<uint8_t>(leaf_idx, g, h, m, n, num_leaves, row_blocks, part,
                          stream);
  } else if (idx_bytes == 4) {
    err = launch<int32_t>(leaf_idx, g, h, m, n, num_leaves, row_blocks, part,
                          stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int cells = num_leaves * 3;
  const int rt = 256;
  leaf_stats_reduce_kernel<<<(cells + rt - 1) / rt, rt, 0, stream>>>(
      part, row_blocks, cells, (float*)out);
  return (int)cudaGetLastError();
}
