// Kernel T: route every row of a binned matrix through one tree's split
// records.
//
// It replaces no TPU kernel: the JAX package computes this in XLA
// (`route_rows`, lightgbm_tpu/ops/grow.py:1833, a `fori_loop` over the
// splits).  It is the scorer of a binned validation set after each tree:
// split t moves the rows of leaf rec_leaf[t] whose bin goes right
// (~rec_left_mask[t][bin] & rec_valid[t]) to leaf t + 1, and the output is
// each row's final leaf id.  The plain version, one masked pass over the
// rows a split (`route_rows_plain` in ops/route.py), launched six small
// kernels for each of a 255-leaf tree's 254 splits.
//
// What bounds it on an H100: bytes.  A row reads the bins of the features
// on its path (one byte each at uint8 bins) and writes its id; with
// feature-major bins, the 32 rows of a 32-byte sector share the sector, so
// the floor is the distinct sectors the rows' paths touch, at most the
// whole matrix: 14 MB at 500k x 28 uint8 bins, about 4 us at 3.35 TB/s.
//
// The design, simple first: a tree walk, one thread a row.
// - Every block stages the tree in shared memory: each record's feature,
//   its right-going bins as a bitset (254 x 256 bits = 8 KB at 255 leaves
//   and 256 bins), and the walk's links: first[l], the first valid record
//   t >= l that splits leaf l (leaf l exists from split l - 1 on), and
//   next[t], the next valid record after t that splits the same leaf.
//   Invalid records are in no chain, so they move nothing, as in the plain
//   version.
// - A row starts at first[0] in leaf 0; at record t it reads its bin of
//   feature[t]: right goes to leaf t + 1 and record first[t + 1], left
//   stays and goes to record next[t].  The walk ends where the chain ends,
//   after about depth loads a row (the plain loop's `li == rec_leaf[t]`
//   test over all 254 records would cost every row 254 steps).
// - Blocks of 1024 threads, two an SM, in a grid-stride loop over the
//   rows: the staging (a read of the (S, B) bool masks, 65 KB at 255 leaves
//   and 256 bins) is paid once a block, and 2048 rows an SM walk at once to
//   hide the loads' latency.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kBlocksPerSm = 2;
constexpr int kDefaultSmem = 48 * 1024;

__host__ __device__ inline int bitset_words(int B) { return (B + 31) / 32; }

// shared bytes of the staged tree: bitsets, then feature, valid leaf,
// next (S each) and first (S + 1); past the card's limit (227 KB on an
// H100) the attribute call fails and the launcher returns its error
inline int64_t route_smem_bytes(int S, int B) {
  return 4 * ((int64_t)S * bitset_words(B) + 4 * (int64_t)S + 1);
}

// right-going bits of 32 bins from 32 bool bytes (0 or 1)
__device__ inline uint32_t right_bits(const uint8_t* m, int nb, bool vec) {
  uint32_t left = 0;
  if (vec) {
    const uint4 a = *reinterpret_cast<const uint4*>(m);
    const uint4 b = *reinterpret_cast<const uint4*>(m + 16);
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t v = w[k];
      left |= ((v & 1u) | ((v >> 7) & 2u) | ((v >> 14) & 4u) |
               ((v >> 21) & 8u)) << (4 * k);
    }
    return ~left;
  }
  for (int b = 0; b < nb; ++b) left |= (uint32_t)(m[b] != 0) << b;
  return ~left & (nb == 32 ? 0xffffffffu : ((1u << nb) - 1u));
}

template <typename BinT, typename OutT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
tree_walk_kernel(const BinT* __restrict__ xt, int64_t n,
                 const int32_t* __restrict__ rec_leaf,
                 const int32_t* __restrict__ rec_feature,
                 const uint8_t* __restrict__ rec_left_mask,
                 const uint8_t* __restrict__ rec_valid, int S, int B,
                 OutT* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int nw = bitset_words(B);
  uint32_t* right = smem;                               // S * nw
  int32_t* feat = reinterpret_cast<int32_t*>(right + (int64_t)S * nw);
  int32_t* leafv = feat + S;                            // -1 where invalid
  int32_t* next = leafv + S;
  int32_t* first = next + S;                            // S + 1
  const int tid = threadIdx.x;
  for (int t = tid; t < S; t += kThreads) {
    feat[t] = rec_feature[t];
    leafv[t] = rec_valid[t] ? rec_leaf[t] : -1;
  }
  const bool vec = (B & 31) == 0 &&
                   (reinterpret_cast<uintptr_t>(rec_left_mask) & 15) == 0;
  for (int i = tid; i < S * nw; i += kThreads) {
    const int t = i / nw, w = i - t * nw;
    const int nb = min(32, B - 32 * w);
    right[i] = rec_valid[t]
        ? right_bits(rec_left_mask + (int64_t)t * B + 32 * w, nb, vec) : 0u;
  }
  __syncthreads();
  // the links: one thread a leaf, over the records in order
  for (int l = tid; l <= S; l += kThreads) {
    int prev = -1;
    first[l] = -1;
    for (int t = l; t < S; ++t) {
      if (leafv[t] == l) {
        if (prev < 0) first[l] = t; else next[prev] = t;
        prev = t;
      }
    }
    if (prev >= 0) next[prev] = -1;
  }
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t r = (int64_t)blockIdx.x * kThreads + tid; r < n; r += stride) {
    int leaf = 0;
    int node = first[0];
    while (node >= 0) {
      const int bin = (int)xt[(int64_t)feat[node] * n + r];
      if ((right[node * nw + (bin >> 5)] >> (bin & 31)) & 1u) {
        leaf = node + 1;
        node = first[leaf];
      } else {
        node = next[node];
      }
    }
    out[r] = (OutT)leaf;
  }
}

template <typename BinT, typename OutT>
int launch(const void* xt, int64_t n, const void* leaf, const void* feature,
           const void* left_mask, const void* valid, int S, int B, void* out,
           int blocks, cudaStream_t stream) {
  auto kern = tree_walk_kernel<BinT, OutT>;
  const int64_t smem = route_smem_bytes(S, B);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<blocks, kThreads, (size_t)smem, stream>>>(
      (const BinT*)xt, n, (const int32_t*)leaf, (const int32_t*)feature,
      (const uint8_t*)left_mask, (const uint8_t*)valid, S, B, (OutT*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// xt: (F, n) bins, `bin_bytes` 1 (uint8) or 2 (int16); the records: S
// int32 leaves and features, (S, B) bool masks of the bins that go left,
// S bool valid flags; out: n ids, `out_bytes` 1 (uint8) or 4 (int32).
// `blocks` comes from the wrapper (`route_plan` in ops/route.py).
extern "C" int ltt_route(const void* xt, int bin_bytes, int64_t n,
                         const void* leaf, const void* feature,
                         const void* left_mask, const void* valid, int S,
                         int B, void* out, int out_bytes, int blocks,
                         void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (S < 1 || B < 1 || blocks < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  if (bin_bytes == 1 && out_bytes == 1)
    return launch<uint8_t, uint8_t>(xt, n, leaf, feature, left_mask, valid,
                                    S, B, out, blocks, stream);
  if (bin_bytes == 1 && out_bytes == 4)
    return launch<uint8_t, int32_t>(xt, n, leaf, feature, left_mask, valid,
                                    S, B, out, blocks, stream);
  if (bin_bytes == 2 && out_bytes == 1)
    return launch<int16_t, uint8_t>(xt, n, leaf, feature, left_mask, valid,
                                    S, B, out, blocks, stream);
  if (bin_bytes == 2 && out_bytes == 4)
    return launch<int16_t, int32_t>(xt, n, leaf, feature, left_mask, valid,
                                    S, B, out, blocks, stream);
  return (int)cudaErrorInvalidValue;
}
