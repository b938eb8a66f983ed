// Kernel H: masked per-leaf histogram.
//
// Replaces the TPU kernel `histogram_pallas` / `_hist_kernel`
// (lightgbm_tpu/ops/histogram.py:238, :199) as the JAX package's serial
// growth loop calls it through `masked_hist` (lightgbm_tpu/ops/grow.py:529):
//
//   m       = mask[r] * (leaf_idx[r] == leaf_id)
//   out[f, bins[f, r], :] += [grad[r] * m, hess[r] * m, m]
//
// The TPU form fed a one-hot x values product to the MXU with a bf16
// hi/lo split of the values; neither exists here.  Each block owns a
// contiguous row range and a chunk of features, and accumulates a
// privatized (chunk, B, 3) histogram in shared memory with atomics.  The
// sums are float64: every block writes its partial, and a second kernel
// adds the partials in block order and rounds once to float32.  The
// float64 sums of float32 inputs are exact or within 2^-53 relative, so
// the result does not depend on the order in which atomics land: the
// same inputs give the same bits on every run and on the CPU path
// (`histogram_plain`, which also sums in float64), and a near-tie between
// two split candidates cannot flip between runs.  The mask is fused, so
// no (N, 3) value tensor is materialised per leaf.
//
// What bounds it on an H100: bytes.  A pass must read leaf_idx for every
// row and bins/grad/hess/mask for the rows of the leaf; the root pass
// reads everything (10.5M x (28 + 13) bytes at the Higgs shape, about
// 0.13 ms at 3.35 TB/s).  This first version is simple: one row per
// thread per step, byte loads of the bins, and float64 shared-memory
// atomics, which cost more than the bytes on dense passes.  The partial
// buffer (row blocks x F x B x 3 float64) is written and read once per
// pass.  Vector loads, fewer partials and a cheaper accumulator are
// later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename BinT, typename IdxT>
__global__ void hist_masked_kernel(const BinT* __restrict__ bins,
                                   const float* __restrict__ grad,
                                   const float* __restrict__ hess,
                                   const float* __restrict__ mask,
                                   const IdxT* __restrict__ leaf_idx,
                                   const int32_t* __restrict__ leaf_id_ptr,
                                   int64_t n, int num_features, int num_bins,
                                   int feat_per_block, int64_t rows_per_block,
                                   double* __restrict__ partial) {
  extern __shared__ double sh[];
  const int f0 = blockIdx.y * feat_per_block;
  const int fc = min(feat_per_block, num_features - f0);
  const int cells = fc * num_bins * 3;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) sh[i] = 0.0;
  __syncthreads();

  const int32_t leaf_id = *leaf_id_ptr;
  const int64_t lo = (int64_t)blockIdx.x * rows_per_block;
  const int64_t hi = lo + rows_per_block < n ? lo + rows_per_block : n;
  for (int64_t r = lo + threadIdx.x; r < hi; r += blockDim.x) {
    if ((int32_t)leaf_idx[r] != leaf_id) continue;
    const float m = mask[r];
    const double g = (double)(grad[r] * m);
    const double h = (double)(hess[r] * m);
    const double c = (double)m;
    for (int f = 0; f < fc; ++f) {
      const int b = (int)bins[(int64_t)(f0 + f) * n + r];
      double* cell = sh + ((int64_t)f * num_bins + b) * 3;
      atomicAdd(cell, g);
      atomicAdd(cell + 1, h);
      atomicAdd(cell + 2, c);
    }
  }
  __syncthreads();

  // partial layout: (row block, feature, bin, channel)
  double* out = partial +
                ((int64_t)blockIdx.x * num_features + f0) * num_bins * 3;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) out[i] = sh[i];
}

// Fixed-order reduction of the per-block partials: row block 0 first.
__global__ void hist_reduce_kernel(const double* __restrict__ partial,
                                   int row_blocks, int64_t per_block,
                                   float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= per_block) return;
  double s = 0.0;
  for (int r = 0; r < row_blocks; ++r) s += partial[(int64_t)r * per_block + i];
  out[i] = (float)s;
}

template <typename BinT, typename IdxT>
cudaError_t launch(const void* bins, const float* grad, const float* hess,
                   const float* mask, const void* leaf_idx,
                   const int32_t* leaf_id, int64_t n, int F, int B,
                   int feat_per_block, int row_blocks, int threads,
                   double* partial, cudaStream_t stream) {
  const size_t smem = (size_t)feat_per_block * B * 3 * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      hist_masked_kernel<BinT, IdxT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t rows_per_block = (n + row_blocks - 1) / row_blocks;
  const dim3 grid(row_blocks, (F + feat_per_block - 1) / feat_per_block);
  hist_masked_kernel<BinT, IdxT><<<grid, threads, smem, stream>>>(
      (const BinT*)bins, grad, hess, mask, (const IdxT*)leaf_idx, leaf_id, n,
      F, B, feat_per_block, rows_per_block, partial);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ltt_hist_masked(const void* bins, int bin_bytes,
                               const void* grad, const void* hess,
                               const void* mask, const void* leaf_idx,
                               int idx_bytes, const void* leaf_id, int64_t n,
                               int num_features, int num_bins,
                               int feat_per_block, int row_blocks, int threads,
                               void* partial, void* out, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const float* g = (const float*)grad;
  const float* h = (const float*)hess;
  const float* m = (const float*)mask;
  const int32_t* lid = (const int32_t*)leaf_id;
  double* part = (double*)partial;
  cudaError_t err;
  if (bin_bytes == 1 && idx_bytes == 1) {
    err = launch<uint8_t, uint8_t>(bins, g, h, m, leaf_idx, lid, n,
                                   num_features, num_bins, feat_per_block,
                                   row_blocks, threads, part, stream);
  } else if (bin_bytes == 1 && idx_bytes == 4) {
    err = launch<uint8_t, int32_t>(bins, g, h, m, leaf_idx, lid, n,
                                   num_features, num_bins, feat_per_block,
                                   row_blocks, threads, part, stream);
  } else if (bin_bytes == 2 && idx_bytes == 1) {
    err = launch<uint16_t, uint8_t>(bins, g, h, m, leaf_idx, lid, n,
                                    num_features, num_bins, feat_per_block,
                                    row_blocks, threads, part, stream);
  } else if (bin_bytes == 2 && idx_bytes == 4) {
    err = launch<uint16_t, int32_t>(bins, g, h, m, leaf_idx, lid, n,
                                    num_features, num_bins, feat_per_block,
                                    row_blocks, threads, part, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int64_t per_block = (int64_t)num_features * num_bins * 3;
  const int rt = 256;
  hist_reduce_kernel<<<(unsigned)((per_block + rt - 1) / rt), rt, 0, stream>>>(
      part, row_blocks, per_block, (float*)out);
  return (int)cudaGetLastError();
}
