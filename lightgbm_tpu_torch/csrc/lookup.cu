// Kernel L: fused leaf-value lookup and score add.
//
// Replaces the TPU kernel `_take_small_pallas` / `_lookup_kernel`
// (lightgbm_tpu/ops/lookup.py:35, :26), which resolved `vals[leaf_idx]`
// with a select chain over the table, and the separate score add that
// followed it (lightgbm_tpu/models/gbdt.py:2286-2290):
//
//   score[i] += vals[leaf_idx[i]]
//
// The same kernel adds into a float64 score, the validation sets' score
// (lightgbm_tpu/models/gbdt.py:2629: `take_small(vals, li)` cast to float64
// and added on the host): score64[i] += (double)vals32[leaf_idx[i]].  The
// table stays float32; each lane loads and stores its four float64 scores
// as two 16-byte double2 words.
//
// What bounds it on an H100: bytes.  One pass reads the ids and the score
// and writes the score back: 9 bytes a row with uint8 ids, 94.5 MB at
// 10.5M rows, about 28 us at 3.35 TB/s (float64 scores: 17 bytes a row
// with uint8 ids, 20 with int32 ids).  Nothing is materialised between
// the lookup and the add.
//
// The design, for that: every access is coalesced and many are in flight.
// - The table (at most 512 float32 leaf values) is staged in shared memory.
// - A warp works on tiles of 128 rows, lane i on rows 4i..4i+3 of a tile:
//   one 4-byte word of uint8 ids (128 contiguous bytes a warp) or one int4
//   of int32 ids, and one float4 of score (512 contiguous bytes a warp;
//   two double2, 1024 bytes a warp, for a float64 score).
// - Each lane loads four tiles' ids and scores before it stores any.
// - The grid is one sweep of the card (4 blocks of 256 threads an SM), and
//   the N / 128 whole tiles are split among the warps in contiguous ranges
//   that differ by at most one tile, so no block waits on a ragged last
//   sweep; the last warp adds the < 128 rows past the last whole tile.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTable = 512;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kTile = 128;       // rows a warp adds per tile, 4 a lane
constexpr int kUnroll = 4;       // tiles a lane has in flight

__device__ inline void ids4(const uint8_t* idx, int64_t r, int* e) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(idx + r);
  e[0] = w & 0xff;
  e[1] = (w >> 8) & 0xff;
  e[2] = (w >> 16) & 0xff;
  e[3] = w >> 24;
}

__device__ inline void ids4(const int32_t* idx, int64_t r, int* e) {
  const int4 v = *reinterpret_cast<const int4*>(idx + r);
  e[0] = v.x;
  e[1] = v.y;
  e[2] = v.z;
  e[3] = v.w;
}

// four consecutive scores of a lane, as one 16-byte word (float) or two
// (double)
template <typename ScoreT>
struct Score4;

template <>
struct Score4<float> {
  float4 v;
  __device__ inline void load(const float* s, int64_t r) {
    v = *reinterpret_cast<const float4*>(s + r);
  }
  __device__ inline void add(const float* tab, const int* e) {
    v.x += tab[e[0]];
    v.y += tab[e[1]];
    v.z += tab[e[2]];
    v.w += tab[e[3]];
  }
  __device__ inline void store(float* s, int64_t r) const {
    *reinterpret_cast<float4*>(s + r) = v;
  }
};

template <>
struct Score4<double> {
  double2 a, b;
  __device__ inline void load(const double* s, int64_t r) {
    a = *reinterpret_cast<const double2*>(s + r);
    b = *reinterpret_cast<const double2*>(s + r + 2);
  }
  __device__ inline void add(const float* tab, const int* e) {
    a.x += (double)tab[e[0]];
    a.y += (double)tab[e[1]];
    b.x += (double)tab[e[2]];
    b.y += (double)tab[e[3]];
  }
  __device__ inline void store(double* s, int64_t r) const {
    *reinterpret_cast<double2*>(s + r) = a;
    *reinterpret_cast<double2*>(s + r + 2) = b;
  }
};

template <typename IdxT, typename ScoreT>
__global__ void __launch_bounds__(kThreads, 4)
leaf_add_kernel(const IdxT* __restrict__ idx, const float* __restrict__ vals,
                int table, ScoreT* __restrict__ score, int64_t n,
                int64_t tiles) {
  __shared__ float tab[kMaxTable];
  for (int i = threadIdx.x; i < table; i += kThreads) tab[i] = vals[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarpsPerBlock;
  const int64_t w = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  int64_t t = w * tiles / warps;
  const int64_t t1 = (w + 1) * tiles / warps;
  for (; t + kUnroll <= t1; t += kUnroll) {
    int e[kUnroll][4];
    Score4<ScoreT> s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t r = (t + u) * kTile + lane * 4;
      ids4(idx, r, e[u]);
      s[u].load(score, r);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t r = (t + u) * kTile + lane * 4;
      s[u].add(tab, e[u]);
      s[u].store(score, r);
    }
  }
  for (; t < t1; ++t) {
    const int64_t r = t * kTile + lane * 4;
    int e[4];
    ids4(idx, r, e);
    Score4<ScoreT> s;
    s.load(score, r);
    s.add(tab, e);
    s.store(score, r);
  }
  if (w == warps - 1) {                      // the masked epilogue
    for (int64_t r = tiles * kTile + lane; r < n; r += 32)
      score[r] += (ScoreT)tab[(int)idx[r]];
  }
}

template <typename ScoreT>
int leaf_add(const void* idx, int idx_bytes, const void* vals, int table,
             void* score, int64_t n, int blocks, int64_t tiles,
             cudaStream_t stream) {
  if (table > kMaxTable || table < 1 || tiles != n / kTile || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (idx_bytes == 1) {
    leaf_add_kernel<uint8_t, ScoreT><<<blocks, kThreads, 0, stream>>>(
        (const uint8_t*)idx, (const float*)vals, table, (ScoreT*)score, n,
        tiles);
  } else if (idx_bytes == 4) {
    leaf_add_kernel<int32_t, ScoreT><<<blocks, kThreads, 0, stream>>>(
        (const int32_t*)idx, (const float*)vals, table, (ScoreT*)score, n,
        tiles);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// `blocks` comes from the wrapper (`lookup_plan` in ops/lookup.py);
// `tiles` is n / 128 rounded down.  score and idx are 16-byte aligned;
// `score_bytes` is 4 (a float32 score) or 8 (float64).
extern "C" int ltt_leaf_add(const void* idx, int idx_bytes, const void* vals,
                            int table, void* score, int score_bytes,
                            int64_t n, int blocks, int64_t tiles,
                            void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (score_bytes == 4)
    return leaf_add<float>(idx, idx_bytes, vals, table, score, n, blocks,
                           tiles, stream);
  if (score_bytes == 8)
    return leaf_add<double>(idx, idx_bytes, vals, table, score, n, blocks,
                            tiles, stream);
  return (int)cudaErrorInvalidValue;
}
