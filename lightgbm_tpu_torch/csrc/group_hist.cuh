// The histogram body over 16-row groups shared by kernels R, M, V and
// V-lanes: histograms of up to 128 row-disjoint subsets ("lanes").  Kernel
// Q (leaf_stats.cu) sums in the same column fixed point, in 32-bit words
// (`WordTile`), and reduces with the same fixed-order reduction.
//
// A row adds its values to one (lane, bin) cell of each feature.  Two
// policies say which:
//
//   membership  ByteLanes:  the lane is a one-byte subset id per row, -1 =
//                           none (kernel R's routing output, the int8
//                           selector of kernels M and V);
//               LeafLanes:  the lane whose child-leaf id equals the row's
//                           leaf id, from a leaf -> lane table in shared
//                           memory (kernel V-lanes);
//   bin map     CoarseMap:  b = (bin == miss_bin[f]) ? Bc - 1 : bin >> shift
//                           (identity at shift 0 without missing bins;
//                           kernels R and M);
//               WindowMap:  b = bin - win_lo[s, f], kept when it lies in
//                           [0, R) and the bin is not the feature's missing
//                           bin (kernels V and V-lanes).
//
// What bounds a pass on an H100: bytes, and in practice the latency of
// the row scan.  A pass reads the bin matrix (feature major: at a wave's
// row densities every 32-byte sector holds a row of some lane), each
// row's membership and the lanes' values.  A scan that loads one row at a
// time per thread keeps a few KB in flight per SM.  The body keeps bytes
// in flight:
// - A thread takes 16 consecutive rows at a time: one 16-byte load of
//   membership (four for int32 leaf ids), and, when one of the 16 rows is
//   in a lane, the values as 16-byte loads and one 16-byte load of bins
//   per feature (32 for int16 bins), the bins of two features in flight
//   together (one with float values, whose 16 x 3 floats fill the
//   registers).  The next group's membership loads while this one is
//   added.  A group with no row in a lane loads nothing else.
// - A block takes a group of features and a range of rows, and keeps the
//   group's (features, W, B, cols) tile in shared memory: int32 for int8
//   values; for float values a 64-bit and a 32-bit integer word a cell
//   (below).  Each membership word it loads serves all its features.
// - The grid is one wave: (feature groups) x (row blocks), no more blocks
//   than the card runs at once at that shared memory (the wrapper asks the
//   card and plans it: `group_plan` in ops/histogram.py).  Row blocks
//   hold at most 2^24 rows (2^22 with float values), so no integer
//   partial can overflow.
// - Where one lane takes every row (kernel M's root pass, W = 1), the
//   atomics of a warp fall on a few cells.  One tile a block is as fast
//   there as a tile copy per warp and 13-25x faster than combining a
//   warp's equal cells by ballots first (both measured on an H100, PERF.md),
//   so every pass keeps the one tile.
// Each block writes its tile as a partial; `group_reduce_kernel` adds the
// partials of a cell in row-block order and rounds once to float32.  With
// two columns only grad and hess are summed and the count channel of the
// output is a copy of hess.
//
// Float values are summed in fixed point, so that the sum does not depend
// on the order of the atomics (float64 atomics round in that order, so
// values whose exponents span much, such as binary-logloss hessians down
// to 1e-7, can give other bits from one launch to the next).  Column c's
// scale comes from E, the largest biased float32 exponent of its values in
// the call (kernel R: its routing blocks' maxima over the selected rows;
// kernels M, V and V-lanes: `exp_max_kernel`'s over all rows, which bounds
// the lanes' values too): every |v| < 2^(E - 126), and a value v becomes
// the integer x = v * 2^(177 - E), |x| < 2^51, rounded to nearest (exact
// unless v is more than 2^27 times smaller than the largest).  The cell
// adds x >> 10 into an int64 word and the low 10 bits into a uint32 word
// (at most 2^22 rows: neither overflows), and the block's partial is
// (hi * 2^10 + lo) * 2^(E - 177) in float64: about 2^-52 of the column's
// largest value is the finest step, as fine as a float64 running sum.  A
// column that holds an infinity or a NaN gives NaN.  Integer sums are the
// same whatever the order of the atomics, so every launch gives the same
// bits.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kGroup = 16;        // consecutive rows a thread takes at once
constexpr int kLoBits = 10;       // a float value's bits in the uint32 word
constexpr int kMaxGroupLanes = 128;
constexpr unsigned kFullMask = 0xffffffffu;

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// The biased exponent of a float32 (0 for zeros and subnormals).
__device__ __forceinline__ int exp_bits(float v) {
  return (int)((__float_as_uint(v) >> 23) & 0xffu);
}

__device__ __forceinline__ void store4(uint32_t* w, uint4 v) {
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

// ---- membership ----------------------------------------------------------

// 16 rows' lanes (int8, -1 = none).
struct Lanes16 {
  uint32_t w[4];
  __device__ void load(const int8_t* __restrict__ p, int64_t r0, int64_t hi) {
    if (r0 + kGroup <= hi) {
      store4(w, *reinterpret_cast<const uint4*>(p + r0));
    } else {
      // the ragged last group (static indices keep `w` in registers)
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = 0xffffffffu;
#pragma unroll
      for (int k = 0; k < kGroup; ++k)
        if (r0 + k < hi)
          w[k >> 2] = (w[k >> 2] & ~(0xffu << (8 * (k & 3)))) |
                      ((uint32_t)(uint8_t)p[r0 + k] << (8 * (k & 3)));
    }
  }
  __device__ bool none() const {
    return (w[0] & w[1] & w[2] & w[3]) == 0xffffffffu;
  }
  __device__ int get(int k) const {
    return (int)(int8_t)(w[k >> 2] >> (8 * (k & 3)));
  }
  __device__ void set(int k, int lane) {
    w[k >> 2] |= (uint32_t)(uint8_t)lane << (8 * (k & 3));
  }
};

// A one-byte subset id a row (kernels R, M and V).
struct ByteLanes {
  const int8_t* ids;
  using Raw = Lanes16;
  __host__ __device__ size_t smem_bytes() const { return 0; }
  __device__ void fill(unsigned char*) {}
  __device__ void order() {}
  __device__ void load(Raw& x, int64_t r0, int64_t hi) const {
    x.load(ids, r0, hi);
  }
  __device__ Lanes16 lanes(const Raw& x) const { return x; }
};

// The lane whose child-leaf id equals the row's leaf id (kernel V-lanes).
// Lane ids are compared as int32: dead lanes carry a dummy id at or above
// `leaf_bound` (every row's leaf id is below it), which must not wrap onto
// leaf 0 of a uint8 leaf vector at 256, so such ids enter no table slot.
// A leaf listed twice maps to its last lane, the order of the reference's
// select chain; live child ids are distinct.
template <typename IdxT>
struct LeafLanes;

template <typename IdxT>
struct LeafTable {
  const IdxT* leaf_idx;
  const int32_t* lane_ids;
  int width;
  int leaf_bound;
  int8_t* table;
  __host__ __device__ size_t smem_bytes() const { return (size_t)leaf_bound; }
  __device__ void fill(unsigned char* smem) {
    table = reinterpret_cast<int8_t*>(smem);
    for (int i = threadIdx.x; i < leaf_bound; i += blockDim.x) table[i] = -1;
  }
  // after a barrier: lanes in order, by one thread
  __device__ void order() {
    if (threadIdx.x == 0) {
      for (int w = 0; w < width; ++w) {
        const int id = lane_ids[w];
        if (id >= 0 && id < leaf_bound) table[id] = (int8_t)w;
      }
    }
  }
};

// uint8 leaf ids: the 16 raw ids load a group ahead, and map to lanes
// (16 shared-memory reads; every id is below the table's 256 slots) when
// the group is added.
template <>
struct LeafLanes<uint8_t> : LeafTable<uint8_t> {
  struct Raw {
    uint32_t w[4];
    int valid;
  };
  __device__ void load(Raw& x, int64_t r0, int64_t hi) const {
    if (r0 + kGroup <= hi) {
      store4(x.w, *reinterpret_cast<const uint4*>(leaf_idx + r0));
      x.valid = kGroup;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) x.w[i] = 0;
#pragma unroll
      for (int k = 0; k < kGroup; ++k)
        if (r0 + k < hi)
          x.w[k >> 2] |= (uint32_t)leaf_idx[r0 + k] << (8 * (k & 3));
      x.valid = r0 < hi ? (int)(hi - r0) : 0;
    }
  }
  __device__ Lanes16 lanes(const Raw& x) const {
    Lanes16 out;
#pragma unroll
    for (int i = 0; i < 4; ++i) out.w[i] = 0;
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int id = (int)((x.w[k >> 2] >> (8 * (k & 3))) & 0xffu);
      out.set(k, k < x.valid ? (int)table[id] : -1);
    }
    return out;
  }
};

// int32 leaf ids: four 16-byte loads a group, mapped to lanes at once
// (the rare deep-tree case; the prefetch then holds lanes, not ids).
template <>
struct LeafLanes<int32_t> : LeafTable<int32_t> {
  using Raw = Lanes16;
  __device__ void load(Raw& x, int64_t r0, int64_t hi) const {
    int ids[kGroup];
    if (r0 + kGroup <= hi) {
      const int4* p = reinterpret_cast<const int4*>(leaf_idx + r0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int4 v = p[i];
        ids[4 * i] = v.x;
        ids[4 * i + 1] = v.y;
        ids[4 * i + 2] = v.z;
        ids[4 * i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) ids[k] = r0 + k < hi ? leaf_idx[r0 + k]
                                                            : -1;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) x.w[i] = 0;
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int id = ids[k];
      x.set(k, (id >= 0 && id < leaf_bound) ? (int)table[id] : -1);
    }
  }
  __device__ Lanes16 lanes(const Raw& x) const { return x; }
};

// ---- bin maps --------------------------------------------------------------

struct CoarseMap {
  int shift;
  const int32_t* miss_bin;   // (F,) or null
  int miss_idx;              // the reserved last coarse slot
  int* mb;                   // the group's missing bins, in shared memory
  struct Feat {
    int m;
  };
  __host__ __device__ size_t smem_bytes(int fpb, int) const {
    return align16((size_t)fpb * sizeof(int));
  }
  __device__ void init(int f0, int fc, int, int, unsigned char* smem) {
    mb = reinterpret_cast<int*>(smem);
    for (int i = threadIdx.x; i < fc; i += blockDim.x)
      mb[i] = miss_bin != nullptr ? miss_bin[f0 + i] : -1;
  }
  __device__ Feat feature(int q) const { return Feat{mb[q]}; }
  __device__ int bin(const Feat& ft, int b, int) const {
    return b == ft.m ? miss_idx : b >> shift;
  }
};

struct WindowMap {
  const int32_t* win_lo;     // (W, F)
  const int32_t* miss_bin;   // (F,) or null
  int* mb;                   // the group's missing bins, in shared memory
  int* lo;                   // win_lo[:, f0 + q] at lo[q * W + s]
  int width;
  struct Feat {
    int m;
    const int* lo;
  };
  __host__ __device__ size_t smem_bytes(int fpb, int w) const {
    return align16((size_t)fpb * sizeof(int) * (1 + (size_t)w));
  }
  __device__ void init(int f0, int fc, int fpb, int num_features,
                       unsigned char* smem) {
    mb = reinterpret_cast<int*>(smem);
    lo = mb + fpb;
    for (int i = threadIdx.x; i < fc; i += blockDim.x)
      mb[i] = miss_bin != nullptr ? miss_bin[f0 + i] : -1;
    for (int i = threadIdx.x; i < fc * width; i += blockDim.x) {
      const int q = i / width, s = i % width;
      lo[i] = win_lo[(int64_t)s * num_features + f0 + q];
    }
  }
  __device__ Feat feature(int q) const { return Feat{mb[q], lo + q * width}; }
  __device__ int bin(const Feat& ft, int b, int s) const {
    return b == ft.m ? -1 : b - ft.lo[s];
  }
};

// ---- bins and values -------------------------------------------------------

// 16 rows' bins of one feature, packed into words.
template <typename BinT>
struct Bins16 {
  static constexpr int kWords = 4 * (int)sizeof(BinT);
  uint32_t w[kWords];
  __device__ void load(const BinT* __restrict__ row, int64_t r0, int64_t hi,
                       bool vec) {
    if (vec && r0 + kGroup <= hi) {
      const uint4* p = reinterpret_cast<const uint4*>(row + r0);
#pragma unroll
      for (int i = 0; i < (int)sizeof(BinT); ++i) store4(w + 4 * i, p[i]);
    } else {
      constexpr int per = 4 / (int)sizeof(BinT);
      constexpr int bits = 8 * (int)sizeof(BinT);
#pragma unroll
      for (int i = 0; i < kWords; ++i) w[i] = 0;
#pragma unroll
      for (int k = 0; k < kGroup; ++k)
        if (r0 + k < hi)
          w[k / per] |= (uint32_t)row[r0 + k] << (bits * (k % per));
    }
  }
  __device__ int get(int k) const {
    if constexpr (sizeof(BinT) == 1)
      return (int)((w[k >> 2] >> (8 * (k & 3))) & 0xffu);
    else
      return (int)((w[k >> 1] >> (16 * (k & 1))) & 0xffffu);
  }
};

// 16 rows' values, (16, COLS) int8 or float32, row-major.
template <typename ValT, int COLS>
struct Vals16;

template <int COLS>
struct Vals16<int8_t, COLS> {
  uint32_t w[4 * COLS];
  __device__ void load(const int8_t* __restrict__ p, int64_t r0,
                       int64_t hi) {
    if (r0 + kGroup <= hi) {
      const uint4* q = reinterpret_cast<const uint4*>(p + r0 * COLS);
#pragma unroll
      for (int i = 0; i < COLS; ++i) store4(w + 4 * i, q[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 4 * COLS; ++i) w[i] = 0;
#pragma unroll
      for (int i = 0; i < kGroup * COLS; ++i)
        if (r0 + i / COLS < hi)
          w[i >> 2] |= (uint32_t)(uint8_t)p[r0 * COLS + i] << (8 * (i & 3));
    }
  }
  __device__ int get(int k, int c) const {
    const int i = k * COLS + c;
    return (int)(int8_t)(w[i >> 2] >> (8 * (i & 3)));
  }
};

template <int COLS>
struct Vals16<float, COLS> {
  float v[kGroup * COLS];
  __device__ void load(const float* __restrict__ p, int64_t r0, int64_t hi) {
    if (r0 + kGroup <= hi) {
      const float4* q = reinterpret_cast<const float4*>(p + r0 * COLS);
#pragma unroll
      for (int i = 0; i < 4 * COLS; ++i) {
        const float4 x = q[i];
        v[4 * i] = x.x;
        v[4 * i + 1] = x.y;
        v[4 * i + 2] = x.z;
        v[4 * i + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kGroup * COLS; ++i) v[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < kGroup * COLS; ++i)
        if (r0 + i / COLS < hi) v[i] = p[r0 * COLS + i];
    }
  }
  __device__ float get(int k, int c) const { return v[k * COLS + c]; }
};

// Threads a block: int8 values leave registers for 1024, float values
// (16 x 3 floats a thread) for 512.
template <typename ValT>
__host__ __device__ constexpr int group_threads() {
  return sizeof(ValT) == 1 ? 1024 : 512;
}

// Features whose bins load together: the most that fit the registers
// without spilling much (measured on kernel R: int8 values 2 of 1, 2, 4
// and 8; float values 1).
template <typename ValT>
__host__ __device__ constexpr int feat_batch() {
  return sizeof(ValT) == 1 ? 2 : 1;
}

// ---- the tile --------------------------------------------------------------

// A float value in column fixed point (see the top of the file): `scale`
// is 2^(177 - E), E the column's largest exponent (at least 1).  The
// product is exact in float64 and below 2^51; rounding it to an integer
// is the one rounding, the same on every launch.
__device__ __forceinline__ long long fixed_value(float v, double scale) {
  return __double2ll_rn((double)v * scale);
}

// The tile's cells: int32 for int8 values; for float values an int64
// word (hi) and, after it, a uint32 word (lo) a cell.
template <typename ValT>
struct Tile;

template <>
struct Tile<int8_t> {
  using Acc = int;
  int* t;
  __device__ Tile(unsigned char* raw, int) : t(reinterpret_cast<int*>(raw)) {}
  static __host__ __device__ size_t bytes(int cells) {
    return align16((size_t)cells * 4);
  }
  __device__ void zero(int i) { t[i] = 0; }
  __device__ void add(int i, int v, double) { atomicAdd(t + i, v); }
  __device__ int partial(int i, int) const { return t[i]; }
};

template <>
struct Tile<float> {
  using Acc = double;
  unsigned long long* hi;
  unsigned* lo;
  __device__ Tile(unsigned char* raw, int cells)
      : hi(reinterpret_cast<unsigned long long*>(raw)),
        lo(reinterpret_cast<unsigned*>(raw + align16((size_t)cells * 8))) {}
  static __host__ __device__ size_t bytes(int cells) {
    return align16((size_t)cells * 8) + align16((size_t)cells * 4);
  }
  __device__ void zero(int i) {
    hi[i] = 0ull;
    lo[i] = 0u;
  }
  __device__ void add(int i, float v, double scale) {
    const long long x = fixed_value(v, scale);
    atomicAdd(hi + i, (unsigned long long)(x >> kLoBits));
    const unsigned l = (unsigned)x & ((1u << kLoBits) - 1u);
    if (l) atomicAdd(lo + i, l);
  }
  __device__ double partial(int i, int ebm) const {
    if (ebm >= 255) return __longlong_as_double(0x7ff8000000000000ll);
    return (double)(long long)hi[i] * ldexp(1.0, ebm - 177 + kLoBits) +
           (double)lo[i] * ldexp(1.0, ebm - 177);
  }
};

// The same column fixed point in three 32-bit words a cell (kernel Q).
// Hopper has no native 64-bit shared-memory add: `Tile<float>`'s int64
// word compiles to a compare-and-swap loop (ATOMS.CAST.SPIN.64 in the
// SASS), where 32-bit words take one ATOMS.ADD each.  A value v becomes
// x = v * 2^(174 - E) (|x| < 2^48) truncated toward zero, in integer
// operations (measured faster than rounding to nearest, and than a float64
// product and conversion: PERF.md); its bits 0-15 and 16-31 add into two
// uint32 words and bits
// 32-47 (signed) into an int32 word, so a block holds at most 2^15 rows
// (no word overflows), and the partial is the three words at their
// weights in float64.  Finest step 2^-48 of the column's largest value.
constexpr int kWordRows = 1 << 15;

__device__ __forceinline__ long long fixed48(float v, int E) {
  const uint32_t u = __float_as_uint(v);
  const int e = (int)((u >> 23) & 0xffu);
  const uint32_t m = (u & 0x7fffffu) | (e ? 0x800000u : 0u);
  const int s = max(e, 1) + 24 - E;     // |v| = m * 2^(max(e, 1) - 150)
  // s <= 24: every |v| < 2^(E - 126)
  const long long x = s >= 0 ? (long long)m << s
                             : (long long)(m >> min(-s, 31));
  return (int)u < 0 ? -x : x;
}

struct WordTile {
  unsigned* w;               // cells words of bits 0-15, then 16-31, 32-47
  int cells;
  __device__ WordTile(unsigned char* raw, int cells_)
      : w(reinterpret_cast<unsigned*>(raw)), cells(cells_) {}
  static __host__ __device__ size_t bytes(int cells) {
    return align16((size_t)cells * 12);
  }
  __device__ void zero(int i) {
    w[i] = 0u;
    w[cells + i] = 0u;
    w[2 * cells + i] = 0u;
  }
  __device__ void add(int i, float v, int E) {
    const long long x = fixed48(v, E);
    const unsigned a = (unsigned)x & 0xffffu;
    const unsigned b = (unsigned)(x >> 16) & 0xffffu;
    const int c = (int)(x >> 32);
    if (a) atomicAdd(w + i, a);
    if (b) atomicAdd(w + cells + i, b);
    if (c) atomicAdd(reinterpret_cast<int*>(w + 2 * cells + i), c);
  }
  __device__ double partial(int i, int E) const {
    if (E >= 255) return __longlong_as_double(0x7ff8000000000000ll);
    return (double)(int)w[2 * cells + i] * ldexp(1.0, E - 174 + 32) +
           (double)w[cells + i] * ldexp(1.0, E - 174 + 16) +
           (double)w[i] * ldexp(1.0, E - 174);
  }
};

// ---- the kernels -----------------------------------------------------------

// Each block's largest exponent of each column of `vals` (n, cols) float32
// over all rows, to exp_max[block * cols + c]: the fixed-point scale of
// kernels M, V and V-lanes (kernel R takes it from its routing launch).
// `Tag` names the calling kernel in a profile, as below.
template <typename Tag>
__global__ void exp_max_kernel(const float* __restrict__ vals, int cols,
                               int64_t n, int32_t* __restrict__ exp_max) {
  __shared__ int32_t emax[3];
  if (threadIdx.x < 3) emax[threadIdx.x] = 0;
  __syncthreads();
  int e[3] = {0, 0, 0};
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const float* v = vals + r * cols;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      if (c < cols) e[c] = max(e[c], exp_bits(v[c]));
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int m = __reduce_max_sync(kFullMask, e[c]);
    if ((threadIdx.x & 31) == 0) atomicMax(&emax[c], m);
  }
  __syncthreads();
  if (threadIdx.x < cols)
    exp_max[(int64_t)blockIdx.x * cols + threadIdx.x] = emax[threadIdx.x];
}

// `Tag` only names the calling kernel (R, M, V or V-lanes), so that a
// profile tells their launches apart.
template <typename Tag, typename BinT, typename ValT, int COLS,
          typename Member, typename Map>
__global__ void __launch_bounds__(group_threads<ValT>(), 1)
group_hist_kernel(const BinT* __restrict__ bins, Member member, Map map,
                  const ValT* __restrict__ vals, int64_t n, int num_features,
                  int feat_per_block, int num_bins, int width,
                  int64_t rows_per_block, int bins_vec,
                  const int32_t* __restrict__ exp_max, int exp_blocks,
                  typename Tile<ValT>::Acc* __restrict__ partial) {
  constexpr int kThreads = group_threads<ValT>();
  constexpr int kFeatBatch = feat_batch<ValT>();
  using AccT = typename Tile<ValT>::Acc;
  extern __shared__ __align__(16) unsigned char sh_raw[];
  __shared__ int ebm[COLS];
  const int fcells = width * num_bins * COLS;
  const int f0 = blockIdx.x * feat_per_block;
  const int fc = min(feat_per_block, num_features - f0);
  const int cells = fc * fcells;
  const int tcells = feat_per_block * fcells;
  Tile<ValT> tile(sh_raw, tcells);
  unsigned char* extra = sh_raw + Tile<ValT>::bytes(tcells);
  for (int i = threadIdx.x; i < cells; i += kThreads) tile.zero(i);
  member.fill(extra);
  map.init(f0, fc, feat_per_block, num_features,
           extra + align16(member.smem_bytes()));
  if (threadIdx.x < COLS) ebm[threadIdx.x] = 1;
  __syncthreads();
  member.order();
  if (exp_max != nullptr) {
    // each column's largest exponent over the exponent blocks' maxima
    for (int i = threadIdx.x; i < exp_blocks * COLS; i += kThreads)
      atomicMax(&ebm[i % COLS], exp_max[i]);
  }
  __syncthreads();
  double scale[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) scale[c] = ldexp(1.0, 177 - ebm[c]);

  const int64_t lo = (int64_t)blockIdx.y * rows_per_block;
  const int64_t hi = lo + rows_per_block < n ? lo + rows_per_block : n;
  const BinT* fbins = bins + (int64_t)f0 * n;
  constexpr int64_t kStep = (int64_t)kThreads * kGroup;
  int64_t r0 = lo + (int64_t)threadIdx.x * kGroup;
  typename Member::Raw next;
  if (r0 < hi) member.load(next, r0, hi);
  for (; r0 < hi; r0 += kStep) {
    const typename Member::Raw cur = next;
    if (r0 + kStep < hi) member.load(next, r0 + kStep, hi);
    const Lanes16 ln = member.lanes(cur);
    if (ln.none()) continue;
    Vals16<ValT, COLS> v;
    v.load(vals, r0, hi);
    for (int fb = 0; fb < fc; fb += kFeatBatch) {
      Bins16<BinT> bb[kFeatBatch];
#pragma unroll
      for (int q = 0; q < kFeatBatch; ++q)
        if (fb + q < fc) bb[q].load(fbins + (int64_t)(fb + q) * n, r0, hi,
                                    bins_vec != 0);
#pragma unroll
      for (int q = 0; q < kFeatBatch; ++q) {
        if (fb + q >= fc) break;
        const int ft = (fb + q) * fcells;
        const typename Map::Feat fm = map.feature(fb + q);
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          const int s = ln.get(k);
          if ((unsigned)s >= (unsigned)width) continue;
          const int b = map.bin(fm, bb[q].get(k), s);
          if ((unsigned)b >= (unsigned)num_bins) continue;
          const int cell = ft + (s * num_bins + b) * COLS;
#pragma unroll
          for (int c = 0; c < COLS; ++c)
            tile.add(cell + c, v.get(k, c), scale[c]);
        }
      }
    }
  }
  __syncthreads();

  // partial layout: (row block, feature, lane, bin, column)
  AccT* out = partial + ((int64_t)blockIdx.y * num_features + f0) * fcells;
  for (int i = threadIdx.x; i < cells; i += kThreads)
    out[i] = (AccT)tile.partial(i, ebm[i % COLS]);
}

// Fixed-order reduction over row blocks; writes (W, F, B, 3) float32 with
// the count channel a copy of hess when cols == 2.
template <typename Tag, typename AccT, typename SumT>
__global__ void group_reduce_kernel(const AccT* __restrict__ partial,
                                    int row_blocks, int num_features,
                                    int width, int num_bins, int cols,
                                    float* __restrict__ out) {
  const int64_t total = (int64_t)num_features * width * num_bins * cols;
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

// The histogram kernel's dynamic shared memory: the tiles, the
// membership's table and the bin map's per-feature words.
template <typename ValT, typename Member, typename Map>
size_t group_smem(const Member& member, const Map& map, int fpb, int W,
                  int B, int cols) {
  return Tile<ValT>::bytes(fpb * W * B * cols) +
         align16(member.smem_bytes()) + map.smem_bytes(fpb, W);
}

// The launch plan, from the wrapper (`group_plan` in ops/histogram.py).
struct GroupPlan {
  int fpb;                   // features a block
  int row_blocks;
  int64_t rows_per_block;    // a multiple of 16
};

// The histogram launch, then the fixed-order reduction: int8 values
// accumulate in int32 and reduce in int64, float values in fixed point
// with float64 partials reduced in float64.  `exp_max` (float values
// only): exp_blocks x COLS exponent maxima.
template <typename Tag, typename BinT, typename ValT, int COLS,
          typename Member, typename Map>
cudaError_t launch_group(const void* bins, Member member, Map map,
                         const void* vals, int64_t n, int F, int B, int W,
                         GroupPlan plan, const int32_t* exp_max,
                         int exp_blocks, void* partial, float* out,
                         cudaStream_t stream) {
  using AccT = typename Tile<ValT>::Acc;
  using SumT = typename std::conditional<sizeof(ValT) == 1, long long,
                                         double>::type;
  const size_t smem = group_smem<ValT>(member, map, plan.fpb, W, B, COLS);
  auto kern = group_hist_kernel<Tag, BinT, ValT, COLS, Member, Map>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // 16-byte bin loads need every feature's row to start on 16 bytes
  const int bins_vec = (int)((uintptr_t)bins % 16 == 0 &&
                             (n * (int64_t)sizeof(BinT)) % 16 == 0);
  const dim3 grid((F + plan.fpb - 1) / plan.fpb, plan.row_blocks);
  kern<<<grid, group_threads<ValT>(), smem, stream>>>(
      (const BinT*)bins, member, map, (const ValT*)vals, n, F, plan.fpb, B, W,
      plan.rows_per_block, bins_vec, exp_max, exp_blocks, (AccT*)partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = (int64_t)F * W * B * COLS;
  const int rt = 256;
  group_reduce_kernel<Tag, AccT, SumT>
      <<<(unsigned)((total + rt - 1) / rt), rt, 0, stream>>>(
          (const AccT*)partial, plan.row_blocks, F, W, B, COLS, out);
  return cudaGetLastError();
}

// The exponent launch of kernels M, V and V-lanes: `blocks` x cols maxima.
template <typename Tag>
cudaError_t launch_exp_max(const float* vals, int cols, int64_t n, int blocks,
                           int32_t* exp_max, cudaStream_t stream) {
  exp_max_kernel<Tag><<<blocks, 256, 0, stream>>>(vals, cols, n, exp_max);
  return cudaGetLastError();
}

// Blocks of one histogram kernel an SM runs at once with `smem` bytes of
// shared memory a block (negative: a CUDA error).
template <typename ValT>
int group_active_blocks(const void* fn, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fn, group_threads<ValT>(), smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace
