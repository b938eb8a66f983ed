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
// The design: one launch a call, whose table is packed once.
// - The first block to take a ticket (an atomicAdd on the launch's sync
//   words) packs the records into a table of int32 words in device
//   memory: for each record t a node (the record a row goes to when its
//   bin goes right: first[t + 1], the first valid record t' >= t + 1 that
//   splits leaf t + 1; the one it goes to when its bin goes left:
//   next[t], the next valid record on t's leaf; and those two records'
//   features), the root (first[0] and its feature), and each record's
//   right-going bins as a bitset (254 x 8 words at 255 leaves and 256
//   bins).  Invalid records are in no chain, so they move nothing, as in
//   the plain version.  It reads the records once (a thread a bitset
//   word), then builds the links in shared memory: first[] by an
//   atomicMin a record, next[] a warp a record, 32 later records a ballot.
//   Then it publishes the table (a fence, then a flag).
// - Every other block waits for the flag.  The packing block is running
//   when the others wait (it took its ticket first), so the wait needs no
//   co-resident grid; a wait that lasts seconds traps instead of hanging.
// - Each block copies the table (12 KB at 255 leaves) into shared memory
//   with 16-byte loads from L2, and the last block past that copy zeroes
//   the sync words for the next launch.  Then a thread walks each row:
//   from the root, at record t it reads its bin of t's feature and its
//   node (together: the node does not depend on the bin), then one bitset
//   word says right (leaf t + 1) or left; the node gives the next record
//   and its feature.  A step is one load of a bin and one of a bitset
//   word, after about depth steps a row.  Blocks of 1024 threads, two an
//   SM; a thread walks two rows at a time, so two independent loads are
//   in flight where one row's walk waits on each of its loads.
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kBlocksPerSm = 2;
constexpr int kDefaultSmem = 48 * 1024;
// the launch's sync words, zero between launches: tickets taken, the
// table published, blocks past their copy of it
constexpr int kTicket = 0, kReady = 1, kStaged = 2;
constexpr int kSyncWords = 4;
// polls of the published flag (about 100 ns each) before a waiting block
// traps: the pack takes microseconds
constexpr int64_t kSpinLimit = int64_t(1) << 24;

__host__ __device__ inline int bitset_words(int B) { return (B + 31) / 32; }

// the table: S nodes of 4 words (right: record, feature; left: record,
// feature), the root (record, feature, 2 words unused), then the bitsets
// (S * nw), padded to whole 16-byte words
__host__ __device__ inline int64_t table_words(int S, int B) {
  return 4 * (int64_t)S + 4 + ((int64_t)S * bitset_words(B) + 3) / 4 * 4;
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

// the packing block: the table of S records into `table`, with `links`
// (4 S + 1 int32 words of shared memory) for the chains
__device__ void pack_table(const int32_t* __restrict__ rec_leaf,
                           const int32_t* __restrict__ rec_feature,
                           const uint8_t* __restrict__ rec_left_mask,
                           const uint8_t* __restrict__ rec_valid, int S,
                           int B, int32_t* links, int32_t* table) {
  int32_t* leafv = links;             // S: the record's leaf, -1 off chain
  int32_t* feat = leafv + S;          // S
  int32_t* next = feat + S;           // S
  int32_t* first = next + S;          // S + 1
  const int nw = bitset_words(B);
  int4* nodes = reinterpret_cast<int4*>(table);
  int32_t* right = table + 4 * (int64_t)S + 4;
  const int tid = threadIdx.x;
  for (int t = tid; t < S; t += kThreads) {
    const int l = rec_leaf[t];
    // a valid record splits a leaf that exists before it: 0 <= l <= t
    leafv[t] = (rec_valid[t] && l >= 0 && l <= t) ? l : -1;
    feat[t] = rec_feature[t];
  }
  for (int l = tid; l <= S; l += kThreads) first[l] = INT_MAX;
  const bool vec = (B & 31) == 0 &&
                   (reinterpret_cast<uintptr_t>(rec_left_mask) & 15) == 0;
  for (int i = tid; i < S * nw; i += kThreads) {
    // the mask's bytes and the valid flag read side by side
    const int t = i / nw, w = i - t * nw;
    const int nb = min(32, B - 32 * w);
    const uint32_t bits =
        right_bits(rec_left_mask + (int64_t)t * B + 32 * w, nb, vec);
    right[i] = rec_valid[t] ? (int32_t)bits : 0;
  }
  __syncthreads();
  for (int t = tid; t < S; t += kThreads)
    if (leafv[t] >= 0) atomicMin(&first[leafv[t]], t);
  // next[t]: a warp a record, the later records 32 at a time
  const int lane = tid & 31;
  for (int t = tid >> 5; t < S; t += kThreads / 32) {
    const int l = leafv[t];
    int nxt = -1;
    if (l >= 0) {
      for (int base = t + 1; base < S; base += 32) {
        const int u = base + lane;
        const unsigned hit =
            __ballot_sync(0xffffffffu, u < S && leafv[u] == l);
        if (hit) {
          nxt = base + __ffs(hit) - 1;
          break;
        }
      }
    }
    if (lane == 0) next[t] = nxt;
  }
  __syncthreads();
  for (int t = tid - 1; t < S; t += kThreads) {
    // t = -1: the root, leaf 0's first record
    const int r = first[t + 1] == INT_MAX ? -1 : first[t + 1];
    const int fr = r >= 0 ? feat[r] : 0;
    if (t < 0) {
      nodes[S] = make_int4(r, fr, -1, 0);
      continue;
    }
    const int l = leafv[t] >= 0 ? next[t] : -1;
    nodes[t] = make_int4(r, fr, l, l >= 0 ? feat[l] : 0);
  }
}

// one step of a row's walk at record `node`: its bin goes right (leaf
// node + 1) or left; the node's record gives the next record and feature
__device__ __forceinline__ void step(const int32_t* right, int4 rec, int nw,
                                     int bin, int& node, int& f, int& leaf) {
  if ((right[node * nw + (bin >> 5)] >> (bin & 31)) & 1) {
    leaf = node + 1;
    node = rec.x;
    f = rec.y;
  } else {
    node = rec.z;
    f = rec.w;
  }
}

// xt: the bins, feature-major (F, n); table: table_words(S, B) words,
// written here by the packing block; sync: kSyncWords words, zero
template <typename BinT, typename OutT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
tree_walk_kernel(const BinT* __restrict__ xt, int64_t n,
                 const int32_t* __restrict__ rec_leaf,
                 const int32_t* __restrict__ rec_feature,
                 const uint8_t* __restrict__ rec_left_mask,
                 const uint8_t* __restrict__ rec_valid, int S, int B,
                 int32_t* table, int32_t* sync, OutT* __restrict__ out) {
  extern __shared__ int4 staged[];
  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(sync + kTicket, 1);
  __syncthreads();
  if (ticket == 0) {
    pack_table(rec_leaf, rec_feature, rec_left_mask, rec_valid, S, B,
               reinterpret_cast<int32_t*>(staged), table);
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicExch(sync + kReady, 1);
    }
  } else if (threadIdx.x == 0) {
    const volatile int32_t* ready = sync + kReady;
    for (int64_t polls = 0; *ready == 0; ++polls) {
      if (polls == kSpinLimit) __trap();
      __nanosleep(100);
    }
    __threadfence();
  }
  __syncthreads();
  // the table from L2: another block wrote it in this launch
  const int nw = bitset_words(B);
  const int64_t words = table_words(S, B);
  const int4* src = reinterpret_cast<const int4*>(table);
  for (int i = threadIdx.x; i < words / 4; i += kThreads)
    staged[i] = __ldcg(src + i);
  __syncthreads();
  if (threadIdx.x == 0 &&
      atomicAdd(sync + kStaged, 1) == (int)gridDim.x - 1) {
    // every block has its ticket and its copy: ready for the next launch
    sync[kTicket] = 0;
    sync[kReady] = 0;
    sync[kStaged] = 0;
  }
  const int4* nodes = staged;
  const int32_t* right = reinterpret_cast<const int32_t*>(staged + S + 1);
  const int4 root = nodes[S];
  const int64_t grid = (int64_t)gridDim.x * kThreads;
  for (int64_t ra = (int64_t)blockIdx.x * kThreads + threadIdx.x; ra < n;
       ra += 2 * grid) {
    const int64_t rb = ra + grid;
    int leaf_a = 0, leaf_b = 0;
    int node_a = root.x, f_a = root.y;
    int node_b = rb < n ? root.x : -1, f_b = root.y;
    while (node_a >= 0 || node_b >= 0) {
      int bin_a = 0, bin_b = 0;
      int4 rec_a, rec_b;
      if (node_a >= 0) {
        bin_a = (int)xt[(int64_t)f_a * n + ra];
        rec_a = nodes[node_a];
      }
      if (node_b >= 0) {
        bin_b = (int)xt[(int64_t)f_b * n + rb];
        rec_b = nodes[node_b];
      }
      if (node_a >= 0) step(right, rec_a, nw, bin_a, node_a, f_a, leaf_a);
      if (node_b >= 0) step(right, rec_b, nw, bin_b, node_b, f_b, leaf_b);
    }
    out[ra] = (OutT)leaf_a;
    if (rb < n) out[rb] = (OutT)leaf_b;
  }
}

struct Records {
  const int32_t* leaf;
  const int32_t* feature;
  const uint8_t* left_mask;
  const uint8_t* valid;
};

template <typename BinT, typename OutT>
int launch(const void* xt, int64_t n, Records r, int S, int B, void* table,
           void* sync, void* out, int blocks, cudaStream_t stream) {
  auto kern = tree_walk_kernel<BinT, OutT>;
  // the staged table; the packing block's links fit in it (4 S + 1 words)
  const int64_t smem = 4 * table_words(S, B);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<blocks, kThreads, (size_t)smem, stream>>>(
      (const BinT*)xt, n, r.leaf, r.feature, r.left_mask, r.valid, S, B,
      (int32_t*)table, (int32_t*)sync, (OutT*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// Route n rows through S split records in one launch.  xt: (F, n) bins,
// `bin_bytes` 1 (uint8) or 2 (int16); the records: S int32 leaves and
// features, (S, B) bool masks of the bins that go left, S bool valid
// flags; `table`: `words` int32 words, 16-byte aligned (`table_words(S,
// B)`, `route_table_words` in ops/route.py), which the launch packs;
// `sync`: kSyncWords int32 words, zero before the launch and left zero
// (no other launch may use them at the same time); out: n ids,
// `out_bytes` 1 (uint8) or 4 (int32).  `blocks` comes from the wrapper
// (`route_plan` in ops/route.py).  Past the card's shared memory (227 KB
// on an H100) the attribute call fails and this returns its error.
extern "C" int ltt_route(const void* xt, int bin_bytes, int64_t n,
                         const void* leaf, const void* feature,
                         const void* left_mask, const void* valid, int S,
                         int B, void* table, int64_t words, void* sync,
                         void* out, int out_bytes, int blocks,
                         void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (S < 0 || B < 1 || blocks < 1 || n < 1 || words != table_words(S, B))
    return (int)cudaErrorInvalidValue;
  const Records r{(const int32_t*)leaf, (const int32_t*)feature,
                  (const uint8_t*)left_mask, (const uint8_t*)valid};
  if (bin_bytes == 1 && out_bytes == 1)
    return launch<uint8_t, uint8_t>(xt, n, r, S, B, table, sync, out,
                                    blocks, stream);
  if (bin_bytes == 1 && out_bytes == 4)
    return launch<uint8_t, int32_t>(xt, n, r, S, B, table, sync, out,
                                    blocks, stream);
  if (bin_bytes == 2 && out_bytes == 1)
    return launch<int16_t, uint8_t>(xt, n, r, S, B, table, sync, out,
                                    blocks, stream);
  if (bin_bytes == 2 && out_bytes == 4)
    return launch<int16_t, int32_t>(xt, n, r, S, B, table, sync, out,
                                    blocks, stream);
  return (int)cudaErrorInvalidValue;
}
