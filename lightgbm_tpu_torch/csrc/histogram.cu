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
// hi/lo split of the values; neither exists here.
//
// What bounds it on an H100: bytes.  A pass must read every row's leaf id
// and the bins, grad, hess and mask of the leaf's rows only: at the Higgs
// shape (10.5M rows x 28 features) the root pass needs 430 MB (0.13 ms at
// 3.35 TB/s), and a leaf of 1/255 of the rows about 12 MB (3.6 us).  The
// growth loop histograms the smaller child of every split, so most passes
// are small, and a pass must cost in proportion to its leaf's rows.
//
// The design, for that:
// - Compaction.  A block owns a contiguous row range and walks it in
//   chunks of 8,192 rows, 8 leaf ids a thread (one 8-byte load of uint8
//   ids, 32 bytes of int32), loaded a chunk ahead of their use.  Each
//   thread's matches become a bit mask; warp shuffles and one block-level
//   scan of the warp counts give each match its slot, and the matching
//   rows are appended to a shared-memory queue in row order.  Rows outside
//   the leaf cost one byte read and nothing else.
// - Accumulation over full warps of queued rows.  The queue is consumed in
//   batches of 1,024 rows once it holds one; a part batch is carried to the
//   next chunk, so a small leaf's rows of a whole block are added in one
//   batch.  A batch's masked values are staged in shared memory, their
//   loads in flight together with each warp's first bin loads.  Warp w
//   owns feature w (w + 32, ...) of the block's feature chunk and its
//   (B, 3) float64 tile: no other warp writes it, so there are no atomics.
//   Within a warp's step of 32 rows, lanes with equal bins are grouped by
//   one ballot per bin bit (a `__match_any_sync` built from ballots, which
//   measured faster than the instruction); the lowest lane of each group
//   sums its group's values in lane order and adds them to the tile.
//   Groups have distinct bins, so the load-add-store never collides.
// - Fewer partials.  Blocks run in clusters of 8, and the grid holds as
//   many clusters as the card runs at once (`ltt_hist_active_clusters`:
//   15 on an H100 with a block's 221 KB of shared memory; one more would
//   run as a second wave).  After the rows, each block of a cluster sums
//   one eighth of the cluster's eight tiles, reading them through
//   distributed shared memory in rank order, and writes that slice once:
//   15 partials at the Higgs shape (2.6 MB) instead of one a block.  A
//   second kernel adds the partials in cluster order and rounds once to
//   float32.
// Where it stands (PERF.md): the root pass at about 15x its bound; a small
// leaf's pass at about 19x, set by the bins being feature-major, so that
// each scattered leaf row reads 28 separate 32-byte sectors.
//
// Every sum is taken in an order fixed by the row order and the launch
// plan, so the same inputs give the same bits on every launch.  The sums
// are float64.  Integer-valued inputs (the quantized serial path) are
// summed exactly, so the result equals the plain version
// (`masked_histogram_plain`, float64 `index_add_`) bit for bit.  Float
// inputs are summed exactly too while every partial sum of a bin fits
// float64's 53 bits: while the values of a bin span fewer than about
// 29 - log2(rows in the bin) bits of exponent (24-bit float32
// significands, 53-bit float64 ones).  Wider spans (hessians p(1 - p) down
// to 1e-7 beside sums near 1e5) round in the last float64 bits, in an order
// other than the plain version's, and the two can then differ by one
// float32 rounding.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 8;
constexpr int kChunk = kThreads * kRowsPerThread;   // rows compacted at once
constexpr int kBatch = kThreads;                    // queued rows staged
constexpr int kQueue = kChunk + kBatch;             // a chunk + a carried part
constexpr int kCluster = 8;
constexpr int kUnroll = 8;                          // bin loads in flight
constexpr unsigned kFull = 0xffffffffu;

// Shared memory besides the tiles: the queue (uint32 row offsets in the
// block's range), the staged values (3 x float32 a row), the warp counts.
constexpr size_t kFixedSmem = kQueue * 4 + kBatch * 3 * 4 + (kWarps + 1) * 4;

// A thread's 8 leaf ids, loaded a chunk ahead of their use.
template <typename IdxT>
struct Ids {
  uint2 v[sizeof(IdxT)];
};

template <typename IdxT>
__device__ inline void load_ids(Ids<IdxT>& x, const IdxT* __restrict__ p,
                                int64_t r0, int64_t hi) {
  if (r0 + kRowsPerThread <= hi) {
#pragma unroll
    for (int i = 0; i < (int)sizeof(IdxT); ++i)
      x.v[i] = reinterpret_cast<const uint2*>(p + r0)[i];
  }
}

// Bit k set when row r0 + k (k < 8, r0 + k < hi) is in the leaf.
template <typename IdxT>
__device__ inline unsigned leaf_bits(const Ids<IdxT>& x,
                                     const IdxT* __restrict__ leaf_idx,
                                     int64_t r0, int64_t hi, int32_t leaf) {
  unsigned bits = 0;
  if (r0 + kRowsPerThread <= hi) {
#pragma unroll
    for (int i = 0; i < (int)sizeof(IdxT); ++i) {
      const uint32_t w[2] = {x.v[i].x, x.v[i].y};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if constexpr (sizeof(IdxT) == 1) {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            bits |= (unsigned)((int32_t)((w[j] >> (8 * b)) & 0xffu) == leaf)
                    << (j * 4 + b);
        } else {
          bits |= (unsigned)((int32_t)w[j] == leaf) << (i * 2 + j);
        }
      }
    }
  } else {
    for (int k = 0; r0 + k < hi; ++k)
      bits |= (unsigned)((int32_t)leaf_idx[r0 + k] == leaf) << k;
  }
  return bits;
}

// A lane's bins of queued rows s0 + 32u + lane (u < kUnroll), -1 past nb.
template <typename BinT>
__device__ inline void load_bins(int* bin, const BinT* __restrict__ brow,
                                 const uint32_t* queue, int j0, int s0,
                                 int nb, int lane) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int j = s0 + u * 32 + lane;
    bin[u] = j < nb ? (int)brow[queue[j0 + j]] : -1;
  }
}

// One warp adds those rows to its feature's (B, 3) tile.
__device__ inline void add_rows(const int* bin, int s0, int nb,
                                const float* sg, const float* sh,
                                const float* sc, double* tile, int nbits,
                                int lane) {
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int jb = s0 + u * 32;
    if (jb >= nb) break;                             // warp-uniform
    const bool live = jb + lane < nb;
    unsigned peers = __ballot_sync(kFull, live);
    for (int k = 0; k < nbits; ++k) {
      const bool bit = (bin[u] >> k) & 1;
      const unsigned set = __ballot_sync(kFull, bit);
      peers &= bit ? set : ~set;
    }
    if (live && (peers & below) == 0) {              // the group's first lane
      double g = 0.0, h = 0.0, c = 0.0;
      for (unsigned p = peers; p; p &= p - 1) {
        const int j = jb + __ffs(p) - 1;
        g += (double)sg[j];
        h += (double)sh[j];
        c += (double)sc[j];
      }
      double* cell = tile + bin[u] * 3;
      cell[0] += g;
      cell[1] += h;
      cell[2] += c;
    }
  }
}

template <typename BinT, typename IdxT>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
hist_masked_kernel(const BinT* __restrict__ bins,
                   const float* __restrict__ grad,
                   const float* __restrict__ hess,
                   const float* __restrict__ mask,
                   const IdxT* __restrict__ leaf_idx,
                   const int32_t* __restrict__ leaf_id_ptr, int64_t n,
                   int num_features, int num_bins, int feat_per_block,
                   int64_t rows_per_block, int nbits,
                   double* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int f0 = blockIdx.y * feat_per_block;
  const int fc = min(feat_per_block, num_features - f0);
  const int cells = fc * num_bins * 3;
  double* tile = reinterpret_cast<double*>(smem);
  uint32_t* queue = reinterpret_cast<uint32_t*>(
      smem + (size_t)feat_per_block * num_bins * 3 * sizeof(double));
  float* sg = reinterpret_cast<float*>(queue + kQueue);
  float* sh = sg + kBatch;
  float* sc = sh + kBatch;
  int* wsum = reinterpret_cast<int*>(sc + kBatch);   // kWarps + 1
  for (int i = threadIdx.x; i < cells; i += kThreads) tile[i] = 0.0;

  const int32_t leaf = *leaf_id_ptr;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t lo = (int64_t)blockIdx.x * rows_per_block;
  const int64_t hi = lo + rows_per_block < n ? lo + rows_per_block : n;
  const BinT* feat0 = bins + (int64_t)f0 * n + lo;
  const int off = t * kRowsPerThread;
  Ids<IdxT> ids;
  load_ids(ids, leaf_idx, lo + off, hi);
  int queued = 0;              // rows in the queue, the same in every thread
  for (int64_t base = lo; base < hi; base += kChunk) {
    // compaction: append the chunk's rows of the leaf to the queue in row
    // order, and load the next chunk's ids meanwhile
    unsigned bits = leaf_bits(ids, leaf_idx, base + off, hi, leaf);
    load_ids(ids, leaf_idx, base + kChunk + off, hi);
    const int cnt = __popc(bits);
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int v = wsum[lane];
      int x = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, x, d);
        if (lane >= d) x += y;
      }
      wsum[lane] = x - v;
      if (lane == 31) wsum[kWarps] = x;
    }
    __syncthreads();
    int pos = queued + wsum[warp] + incl - cnt;
    const uint32_t row0 = (uint32_t)(base - lo) + off;
    for (; bits; bits &= bits - 1) queue[pos++] = row0 + __ffs(bits) - 1;
    queued += wsum[kWarps];
    __syncthreads();

    // accumulation over whole batches; the last chunk flushes the rest
    const int ready = base + kChunk >= hi ? queued : queued / kBatch * kBatch;
    for (int j0 = 0; j0 < ready; j0 += kBatch) {
      const int nb = min(kBatch, ready - j0);
      float g = 0.f, h = 0.f, m = 0.f;
      if (t < nb) {
        const int64_t r = lo + queue[j0 + t];
        m = mask[r];
        g = grad[r];
        h = hess[r];
      }
      int bin[kUnroll];
      if (warp < fc)                 // in flight with the staging loads
        load_bins(bin, feat0 + (int64_t)warp * n, queue, j0, 0, nb, lane);
      if (t < nb) {
        sg[t] = g * m;
        sh[t] = h * m;
        sc[t] = m;
      }
      __syncthreads();
      for (int f = warp; f < fc; f += kWarps) {
        const BinT* brow = feat0 + (int64_t)f * n;
        double* ftile = tile + (size_t)f * num_bins * 3;
        for (int s0 = 0; s0 < nb; s0 += 32 * kUnroll) {
          if (f != warp || s0 != 0)
            load_bins(bin, brow, queue, j0, s0, nb, lane);
          add_rows(bin, s0, nb, sg, sh, sc, ftile, nbits, lane);
        }
      }
      __syncthreads();
    }
    // carry the part batch to the front (it is shorter than a batch, and
    // so than the batches consumed before it: the two ranges are disjoint)
    if (ready > 0 && ready < queued) {
      if (t < queued - ready) queue[t] = queue[ready + t];
      __syncthreads();
    }
    queued -= ready;
  }

  // the cluster's tiles summed in rank order, one slice a block
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int per = (cells + kCluster - 1) / kCluster;
  const int c0 = (int)cluster.block_rank() * per;
  const int c1 = min(cells, c0 + per);
  double* out = partial + ((int64_t)(blockIdx.x / kCluster) * num_features +
                           f0) * num_bins * 3;
  for (int i = c0 + t; i < c1; i += kThreads) {
    double s = 0.0;
#pragma unroll
    for (int q = 0; q < kCluster; ++q)
      s += cluster.map_shared_rank(tile, q)[i];
    out[i] = s;
  }
  cluster.sync();   // no block leaves while another reads its tile
}

// Fixed-order reduction of the per-cluster partials: cluster 0 first.
__global__ void hist_reduce_kernel(const double* __restrict__ partial,
                                   int clusters, int64_t per_cluster,
                                   float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= per_cluster) return;
  double s = 0.0;
  for (int c = 0; c < clusters; ++c)
    s += partial[(int64_t)c * per_cluster + i];
  out[i] = (float)s;
}

template <typename BinT, typename IdxT>
cudaError_t launch(const void* bins, const float* grad, const float* hess,
                   const float* mask, const void* leaf_idx,
                   const int32_t* leaf_id, int64_t n, int F, int B,
                   int feat_per_block, int row_blocks, int64_t rows_per_block,
                   int nbits, double* partial, cudaStream_t stream) {
  const size_t smem = (size_t)feat_per_block * B * 3 * sizeof(double) +
                      kFixedSmem;
  cudaError_t err = cudaFuncSetAttribute(
      hist_masked_kernel<BinT, IdxT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(row_blocks, (F + feat_per_block - 1) / feat_per_block);
  hist_masked_kernel<BinT, IdxT><<<grid, kThreads, smem, stream>>>(
      (const BinT*)bins, grad, hess, mask, (const IdxT*)leaf_idx, leaf_id, n,
      F, B, feat_per_block, rows_per_block, nbits, partial);
  return cudaGetLastError();
}

}  // namespace

// Clusters of kernel H the card runs at once with `smem` bytes a block.
extern "C" int ltt_hist_active_clusters(int bin_bytes, int idx_bytes,
                                        int smem) {
  const void* fn;
  if (bin_bytes == 1 && idx_bytes == 1)
    fn = (const void*)hist_masked_kernel<uint8_t, uint8_t>;
  else if (bin_bytes == 1 && idx_bytes == 4)
    fn = (const void*)hist_masked_kernel<uint8_t, int32_t>;
  else if (bin_bytes == 2 && idx_bytes == 1)
    fn = (const void*)hist_masked_kernel<uint16_t, uint8_t>;
  else if (bin_bytes == 2 && idx_bytes == 4)
    fn = (const void*)hist_masked_kernel<uint16_t, int32_t>;
  else
    return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}

// The plan (features per block, row blocks, rows per block, bin bits)
// comes from the wrapper (`hist_plan` in ops/histogram.py): row_blocks is
// a multiple of the cluster size, rows_per_block of 16, and the leaf ids
// are 16-byte aligned.
extern "C" int ltt_hist_masked(const void* bins, int bin_bytes,
                               const void* grad, const void* hess,
                               const void* mask, const void* leaf_idx,
                               int idx_bytes, const void* leaf_id, int64_t n,
                               int num_features, int num_bins,
                               int feat_per_block, int row_blocks,
                               int64_t rows_per_block, int nbits,
                               void* partial, void* out, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (row_blocks % kCluster != 0 || rows_per_block % kRowsPerThread != 0)
    return (int)cudaErrorInvalidValue;
  const float* g = (const float*)grad;
  const float* h = (const float*)hess;
  const float* m = (const float*)mask;
  const int32_t* lid = (const int32_t*)leaf_id;
  double* part = (double*)partial;
  cudaError_t err;
  if (bin_bytes == 1 && idx_bytes == 1) {
    err = launch<uint8_t, uint8_t>(bins, g, h, m, leaf_idx, lid, n,
                                   num_features, num_bins, feat_per_block,
                                   row_blocks, rows_per_block, nbits, part,
                                   stream);
  } else if (bin_bytes == 1 && idx_bytes == 4) {
    err = launch<uint8_t, int32_t>(bins, g, h, m, leaf_idx, lid, n,
                                   num_features, num_bins, feat_per_block,
                                   row_blocks, rows_per_block, nbits, part,
                                   stream);
  } else if (bin_bytes == 2 && idx_bytes == 1) {
    err = launch<uint16_t, uint8_t>(bins, g, h, m, leaf_idx, lid, n,
                                    num_features, num_bins, feat_per_block,
                                    row_blocks, rows_per_block, nbits, part,
                                    stream);
  } else if (bin_bytes == 2 && idx_bytes == 4) {
    err = launch<uint16_t, int32_t>(bins, g, h, m, leaf_idx, lid, n,
                                    num_features, num_bins, feat_per_block,
                                    row_blocks, rows_per_block, nbits, part,
                                    stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int64_t per_cluster = (int64_t)num_features * num_bins * 3;
  const int rt = 256;
  hist_reduce_kernel<<<(unsigned)((per_cluster + rt - 1) / rt), rt, 0,
                       stream>>>(part, row_blocks / kCluster, per_cluster,
                                 (float*)out);
  return (int)cudaGetLastError();
}
