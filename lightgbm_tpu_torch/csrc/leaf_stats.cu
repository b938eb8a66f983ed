// Kernel Q: per-leaf sums for the quantized leaf renewal.
//
// Replaces the TPU kernel `leaf_stats_pallas` / `_leaf_stats_kernel`
// (lightgbm_tpu/ops/histogram.py:1239, :1214), and the generic histogram
// over leaf ids the JAX package uses beyond 256 leaves
// (lightgbm_tpu/ops/grow.py:1787-1790):
//
//   m = mask[r]
//   out[leaf_idx[r], :] += [grad[r] * m, hess[r] * m, m]
//       for 0 <= leaf_idx[r] < L (other rows are skipped)
//
// The products are taken in float32, as the plain version takes them.  The
// TPU form split the leaf id into nibbles and each float into bf16 hi/lo
// parts for the MXU; neither is semantics to copy.
//
// What bounds it on an H100: bytes.  One pass reads the leaf ids and three
// float32 vectors: 13 bytes a row with uint8 ids, 136.5 MB at 10.5M rows,
// about 41 us at 3.35 TB/s.  The design:
// - A thread takes 16 consecutive rows at a time: one 16-byte load of
//   uint8 ids (four of int32 ids) and four 16-byte loads each of grad,
//   hess and mask.  The next group's ids load while this group is added,
//   as in the histogram body of group_hist.cuh; holding the whole next
//   group in registers as well measured slower (140 registers a thread,
//   one block an SM; PERF.md).  Three blocks of 256 threads an SM.
// - Sums in that header's column fixed point, in three 32-bit words a cell
//   (`WordTile`: Hopper has no native 64-bit shared add, so the body's
//   int64 word is a compare-and-swap loop), at each column's scale: the
//   bound launch first takes each block's largest |grad * m|, |hess * m|
//   and |m|.  The sums do not depend on the order of the atomics, so a
//   repeat launch gives the same bits.  One tile a block: a tile a warp
//   measured no faster at 7, 31 or 255 leaves (PERF.md).  Each block
//   writes its tile as float64 partials; the header's `group_reduce_kernel`
//   adds them in row-block order and rounds once to float32.
// - The grid is one wave of row blocks, planned by the wrapper from an
//   occupancy query (`leaf_plan` in ops/histogram.py); a block holds at
//   most 2^15 rows, so no word overflows.
#include "group_hist.cuh"

namespace {

constexpr int kLeafThreads = 256;
// Blocks an SM runs at once: at most 85 registers a thread.  The sums are
// latency-bound below that (two blocks an SM measured 45% slower, PERF.md).
constexpr int kLeafMinBlocks = 3;

struct LeafTag {};     // names kernel Q's reduction in a profile

__device__ __forceinline__ void load16(float* dst,
                                       const float* __restrict__ p) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 x = q[i];
    dst[4 * i] = x.x;
    dst[4 * i + 1] = x.y;
    dst[4 * i + 2] = x.z;
    dst[4 * i + 3] = x.w;
  }
}

// 16 consecutive rows' leaf ids (uint8 packed four a word, or int32); rows
// at or past the block's end carry -1, which no leaf has.
template <typename IdxT>
struct LeafIds16 {
  static constexpr int kWords = 4 * (int)sizeof(IdxT);
  uint32_t w[kWords];
  int valid;
  __device__ void load(const IdxT* __restrict__ ids, int64_t r0,
                       int64_t hi) {
    if (r0 + kGroup <= hi) {
      const uint4* q = reinterpret_cast<const uint4*>(ids + r0);
#pragma unroll
      for (int i = 0; i < (int)sizeof(IdxT); ++i) store4(w + 4 * i, q[i]);
      valid = kGroup;
    } else {
      // the ragged last group (static indices keep `w` in registers)
#pragma unroll
      for (int i = 0; i < kWords; ++i) w[i] = 0;
#pragma unroll
      for (int k = 0; k < kGroup; ++k)
        if (r0 + k < hi) {
          if constexpr (sizeof(IdxT) == 1)
            w[k >> 2] |= (uint32_t)ids[r0 + k] << (8 * (k & 3));
          else
            w[k] = (uint32_t)ids[r0 + k];
        }
      valid = r0 < hi ? (int)(hi - r0) : 0;
    }
  }
  __device__ int get(int k) const {
    if (k >= valid) return -1;
    if constexpr (sizeof(IdxT) == 1)
      return (int)((w[k >> 2] >> (8 * (k & 3))) & 0xffu);
    else
      return (int)w[k];
  }
};

// 16 rows of a float vector (zeros past the block's end).
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ p,
                                          int64_t r0, int64_t hi) {
  if (r0 + kGroup <= hi) {
    load16(dst, p + r0);
  } else {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) dst[k] = r0 + k < hi ? p[r0 + k] : 0.0f;
  }
}

// Each block's largest |grad * mask|, |hess * mask| and |mask| over its
// rows (grid-stride), to bounds[block * 3 + c]: the columns' fixed-point
// scales.  Non-negative floats order as their bits; a NaN sorts above
// every number, so a column that holds one gives a NaN sum.
__global__ void __launch_bounds__(256)
leaf_bound_kernel(const float* __restrict__ grad,
                  const float* __restrict__ hess,
                  const float* __restrict__ mask, int64_t n,
                  float* __restrict__ bounds) {
  __shared__ unsigned bmax[3];
  if (threadIdx.x < 3) bmax[threadIdx.x] = 0u;
  __syncthreads();
  unsigned b[3] = {0u, 0u, 0u};
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n4 = n / 4;
  for (int64_t i = t0; i < n4; i += stride) {
    const float4 g = reinterpret_cast<const float4*>(grad)[i];
    const float4 h = reinterpret_cast<const float4*>(hess)[i];
    const float4 m = reinterpret_cast<const float4*>(mask)[i];
    const float gs[4] = {g.x, g.y, g.z, g.w}, hs[4] = {h.x, h.y, h.z, h.w},
                ms[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      b[0] = max(b[0], __float_as_uint(fabsf(gs[k] * ms[k])));
      b[1] = max(b[1], __float_as_uint(fabsf(hs[k] * ms[k])));
      b[2] = max(b[2], __float_as_uint(fabsf(ms[k])));
    }
  }
  for (int64_t r = n4 * 4 + t0; r < n; r += stride) {
    b[0] = max(b[0], __float_as_uint(fabsf(grad[r] * mask[r])));
    b[1] = max(b[1], __float_as_uint(fabsf(hess[r] * mask[r])));
    b[2] = max(b[2], __float_as_uint(fabsf(mask[r])));
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const unsigned w = __reduce_max_sync(kFullMask, b[c]);
    if ((threadIdx.x & 31) == 0) atomicMax(&bmax[c], w);
  }
  __syncthreads();
  if (threadIdx.x < 3)
    bounds[(int64_t)blockIdx.x * 3 + threadIdx.x] =
        __uint_as_float(bmax[threadIdx.x]);
}

// One block's rows into its (L, 3) tile, written as the block's float64
// partial.  `bounds` holds bound_blocks x 3 upper bounds of the columns'
// magnitudes.
template <typename IdxT>
__global__ void __launch_bounds__(kLeafThreads, kLeafMinBlocks)
leaf_stats_kernel(const IdxT* __restrict__ leaf_idx,
                  const float* __restrict__ grad,
                  const float* __restrict__ hess,
                  const float* __restrict__ mask, int64_t n, int num_leaves,
                  int64_t rows_per_block, const float* __restrict__ bounds,
                  int bound_blocks, double* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char sh_raw[];
  __shared__ int ebm[3];
  const int cells = num_leaves * 3;
  WordTile tile(sh_raw, cells);
  for (int i = threadIdx.x; i < cells; i += kLeafThreads) tile.zero(i);
  if (threadIdx.x < 3) ebm[threadIdx.x] = 1;
  __syncthreads();
  for (int i = threadIdx.x; i < bound_blocks * 3; i += kLeafThreads)
    atomicMax(&ebm[i % 3], exp_bits(bounds[i]));
  __syncthreads();
  const int e0 = ebm[0], e1 = ebm[1], e2 = ebm[2];

  const int64_t lo = (int64_t)blockIdx.x * rows_per_block;
  const int64_t hi = lo + rows_per_block < n ? lo + rows_per_block : n;
  constexpr int64_t kStep = (int64_t)kLeafThreads * kGroup;
  int64_t r0 = lo + (int64_t)threadIdx.x * kGroup;
  LeafIds16<IdxT> next;
  if (r0 < hi) next.load(leaf_idx, r0, hi);
  for (; r0 < hi; r0 += kStep) {
    const LeafIds16<IdxT> ids = next;
    float g[kGroup], h[kGroup], m[kGroup];
    load_rows(g, grad, r0, hi);
    load_rows(h, hess, r0, hi);
    load_rows(m, mask, r0, hi);
    if (r0 + kStep < hi) next.load(leaf_idx, r0 + kStep, hi);
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int l = ids.get(k);
      if ((unsigned)l >= (unsigned)num_leaves) continue;
      tile.add(l * 3, g[k] * m[k], e0);
      tile.add(l * 3 + 1, h[k] * m[k], e1);
      tile.add(l * 3 + 2, m[k], e2);
    }
  }
  __syncthreads();

  double* out = partial + (int64_t)blockIdx.x * cells;
  for (int i = threadIdx.x; i < cells; i += kLeafThreads)
    out[i] = tile.partial(i, ebm[i % 3]);
}

template <typename IdxT>
cudaError_t launch_leaf(const void* leaf_idx, const float* g, const float* h,
                        const float* m, int64_t n, int num_leaves,
                        int row_blocks, int64_t rows_per_block,
                        const float* bounds, int bound_blocks,
                        double* partial, cudaStream_t stream) {
  const size_t smem = WordTile::bytes(num_leaves * 3);
  cudaError_t err = cudaFuncSetAttribute(
      leaf_stats_kernel<IdxT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  leaf_stats_kernel<IdxT><<<row_blocks, kLeafThreads, smem, stream>>>(
      (const IdxT*)leaf_idx, g, h, m, n, num_leaves, rows_per_block, bounds,
      bound_blocks, partial);
  return cudaGetLastError();
}

}  // namespace

// Blocks of kernel Q's sum launch one SM runs at once with `smem` bytes of
// shared memory a block (negative: a CUDA error).
extern "C" int ltt_leaf_active_blocks(int idx_bytes, int smem) {
  const void* fn = idx_bytes == 1 ? (const void*)leaf_stats_kernel<uint8_t>
                   : idx_bytes == 4 ? (const void*)leaf_stats_kernel<int32_t>
                                    : nullptr;
  if (fn == nullptr) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                      kLeafThreads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// leaf_idx (N,) uint8/int32; grad/hess/mask (N,) float32; all 16-byte
// aligned; out (L, 3) float32.  Rows with an id outside [0, L) are
// skipped.  The plan (row blocks, rows per block: a multiple of 16, at
// most 2^15) comes from the wrapper (`leaf_plan`); `partial` holds
// row_blocks x L x 3 float64, `bounds` bound_blocks x 3 float32 scratch
// for the bound launch.  Three launches: bounds, sums, reduction.
extern "C" int ltt_leaf_stats(const void* leaf_idx, int idx_bytes,
                              const void* grad, const void* hess,
                              const void* mask, int64_t n, int num_leaves,
                              int row_blocks, int64_t rows_per_block,
                              int bound_blocks, void* bounds, void* partial,
                              void* out, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const float* g = (const float*)grad;
  const float* h = (const float*)hess;
  const float* m = (const float*)mask;
  if (num_leaves < 1 || row_blocks < 1 || rows_per_block % kGroup != 0 ||
      rows_per_block > kWordRows || bound_blocks < 1 ||
      (idx_bytes != 1 && idx_bytes != 4) ||
      ((uintptr_t)leaf_idx | (uintptr_t)g | (uintptr_t)h | (uintptr_t)m) %
              16 != 0)
    return (int)cudaErrorInvalidValue;
  float* bd = (float*)bounds;
  leaf_bound_kernel<<<bound_blocks, 256, 0, stream>>>(g, h, m, n, bd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  double* part = (double*)partial;
  err = idx_bytes == 1
            ? launch_leaf<uint8_t>(leaf_idx, g, h, m, n, num_leaves,
                                   row_blocks, rows_per_block, bd,
                                   bound_blocks, part, stream)
            : launch_leaf<int32_t>(leaf_idx, g, h, m, n, num_leaves,
                                   row_blocks, rows_per_block, bd,
                                   bound_blocks, part, stream);
  if (err != cudaSuccess) return (int)err;
  const int cells = num_leaves * 3;
  const int rt = 256;
  group_reduce_kernel<LeafTag, double, double>
      <<<(cells + rt - 1) / rt, rt, 0, stream>>>(part, row_blocks, 1, 1,
                                                 num_leaves, 3, (float*)out);
  return (int)cudaGetLastError();
}
