// Kernel M: histograms of up to 64 row-disjoint subsets in one pass.
//
// Replaces the TPU kernel `histogram_pallas_multi` / `_hist_kernel_multi`
// (lightgbm_tpu/ops/histogram.py:396, :300) at full resolution (shift 0):
//
//   s = sel[r]                       (-1 = the row is in no subset)
//   out[s, f, bins[f, r], c] += vals[r, c]      for s >= 0
//
// and, with `two_col`, only grad and hess are accumulated and the count
// channel of the output is a copy of the hess channel (the two-column
// quantized pass, ops/histogram.py:513-517).  The TPU form fed a one-hot
// x (lane one-hot * values) product to the MXU, with a bf16 hi/lo split of
// float values; neither exists here.  A row adds to one (subset, feature,
// bin) cell per feature, so each block owns one feature and a contiguous
// row range and accumulates the privatised (W, B, cols) tile of that
// feature in dynamic shared memory with atomics:
//
//   - quantized values (int8, |v| <= 127) accumulate in int32: exact and
//     independent of the order of the atomics (64 x 256 x 2 x 4 = 128 KB
//     at W = 64 two-column, 42 x 256 x 3 x 4 = 126 KB at W = 42);
//   - float values accumulate in float64 (21 x 256 x 3 x 8 = 126 KB at
//     W = 21), kernel H's determinism recipe.
//
// Each block writes its tile as a partial; a second kernel adds the
// partials of a feature in row-block order (in int64, or float64) and
// rounds once to float32.  So the result is the same on every run, and
// equals the plain version (`multi_histogram_plain`, float64 index_add_)
// bit for bit on integer values.
//
// What bounds it on an H100: bytes at the root pass (every row in lane 0:
// the F x N bin matrix, the (N, cols) values and the (N,) selector, about
// 0.1 ms at 10.5M x 28 from HBM), and in practice the shared-memory
// atomics, N x F x cols of them when every row is selected.  The blocks
// of one row range run together (feature is the fast grid index), so the
// selector and the values of a row range are read from HBM once and from
// L2 by the other features' blocks.  Fewer atomics (warp aggregation of
// equal bins) are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

template <typename BinT, typename SelT, typename ValT, typename AccT>
__global__ void __launch_bounds__(kThreads, 1)
multi_hist_kernel(const BinT* __restrict__ bins, const SelT* __restrict__ sel,
                  const ValT* __restrict__ vals, int val_cols, int cols,
                  int64_t n, int num_bins, int width, int64_t rows_per_block,
                  AccT* __restrict__ partial) {
  extern __shared__ unsigned char sh_raw[];
  AccT* sh = reinterpret_cast<AccT*>(sh_raw);
  const int f = blockIdx.x;
  const int num_features = gridDim.x;
  const int cells = width * num_bins * cols;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) sh[i] = AccT(0);
  __syncthreads();

  const int64_t lo = (int64_t)blockIdx.y * rows_per_block;
  const int64_t hi = lo + rows_per_block < n ? lo + rows_per_block : n;
  const BinT* brow = bins + (int64_t)f * n;
  for (int64_t r = lo + threadIdx.x; r < hi; r += blockDim.x) {
    const int s = (int)sel[r];
    if (s < 0 || s >= width) continue;
    const int b = (int)brow[r];
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
__global__ void multi_reduce_kernel(const AccT* __restrict__ partial,
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

template <typename BinT, typename SelT, typename ValT, typename AccT,
          typename SumT>
cudaError_t launch(const void* bins, const void* sel, const void* vals,
                   int val_cols, int cols, int64_t n, int F, int B, int W,
                   int row_blocks, void* partial, float* out,
                   cudaStream_t stream) {
  const size_t smem = (size_t)W * B * cols * sizeof(AccT);
  auto kern = multi_hist_kernel<BinT, SelT, ValT, AccT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t rows_per_block = (n + row_blocks - 1) / row_blocks;
  kern<<<dim3(F, row_blocks), kThreads, smem, stream>>>(
      (const BinT*)bins, (const SelT*)sel, (const ValT*)vals, val_cols, cols,
      n, B, W, rows_per_block, (AccT*)partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = (int64_t)F * W * B * cols;
  const int rt = 256;
  multi_reduce_kernel<AccT, SumT><<<(unsigned)((total + rt - 1) / rt), rt, 0,
                                    stream>>>((const AccT*)partial, row_blocks,
                                              F, W, B, cols, out);
  return cudaGetLastError();
}

template <typename BinT, typename SelT>
cudaError_t by_values(const void* bins, const void* sel, const void* vals,
                      int val_int8, int val_cols, int cols, int64_t n, int F,
                      int B, int W, int row_blocks, void* partial, float* out,
                      cudaStream_t stream) {
  if (val_int8)
    return launch<BinT, SelT, int8_t, int, long long>(
        bins, sel, vals, val_cols, cols, n, F, B, W, row_blocks, partial, out,
        stream);
  return launch<BinT, SelT, float, double, double>(
      bins, sel, vals, val_cols, cols, n, F, B, W, row_blocks, partial, out,
      stream);
}

}  // namespace

// bins (F, N) uint8/int16; sel (N,) int32/int8; vals (N, val_cols)
// int8/float32; out (W, F, B, 3) float32.  `partial` holds row_blocks x
// F x W x B x cols int32 (int8 values) or float64 (float values).
extern "C" int ltt_multi_hist(const void* bins, int bin_bytes, const void* sel,
                              int sel_bytes, const void* vals, int val_int8,
                              int val_cols, int two_col, int64_t n,
                              int num_features, int num_bins, int width,
                              int row_blocks, void* partial, void* out,
                              void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int cols = two_col ? 2 : 3;
  if (val_cols < cols) return (int)cudaErrorInvalidValue;
  float* o = (float*)out;
  cudaError_t err;
  if (bin_bytes == 1 && sel_bytes == 4) {
    err = by_values<uint8_t, int32_t>(bins, sel, vals, val_int8, val_cols,
                                      cols, n, num_features, num_bins, width,
                                      row_blocks, partial, o, stream);
  } else if (bin_bytes == 1 && sel_bytes == 1) {
    err = by_values<uint8_t, int8_t>(bins, sel, vals, val_int8, val_cols, cols,
                                     n, num_features, num_bins, width,
                                     row_blocks, partial, o, stream);
  } else if (bin_bytes == 2 && sel_bytes == 4) {
    err = by_values<uint16_t, int32_t>(bins, sel, vals, val_int8, val_cols,
                                       cols, n, num_features, num_bins, width,
                                       row_blocks, partial, o, stream);
  } else if (bin_bytes == 2 && sel_bytes == 1) {
    err = by_values<uint16_t, int8_t>(bins, sel, vals, val_int8, val_cols,
                                      cols, n, num_features, num_bins, width,
                                      row_blocks, partial, o, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
