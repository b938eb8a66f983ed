// Kernel R: row routing of a wave of splits, then the smaller children's
// histograms.
//
// Replaces the TPU kernel `histogram_pallas_multi_routed` /
// `_hist_kernel_multi_routed` with `_routed_parts`
// (lightgbm_tpu/ops/histogram.py:872, :783, :713) in mode "small", at full
// resolution (shift 0) or coarse (shift > 0: the coarse-to-fine wave,
// :831-836, :932-939).  The lane tables are a (5 or 6, W) int32 array:
//
//   row 0: the leaf each lane splits      row 1: its split column
//   row 2: its threshold bin              row 3: the new (right) leaf id
//   row 4: smaller child is the left one  row 5: default left (optional)
//
// Per row: lane = the lane whose leaf is the row's leaf (or none); the
// row goes left when its bin in the lane's column is <= the threshold, or,
// with row 5 and a per-feature missing bin, when the bin is the missing
// bin and the lane's default is left (histogram.py:740-749); a row going
// right takes the lane's new leaf id; the row is in subset `lane` when it
// goes to the smaller child.  Then, per subset s, feature f and column c:
//
//   b = (bins[f, r] == miss_bin[f]) ? Bc - 1 : bins[f, r] >> shift
//   out[s, f, b, c] += vals[r, c]
//
// (the missing bin goes to the reserved last coarse slot only with a
// shift); with `two_col` the count channel of the output is a copy of hess.
//
// The TPU kernel resolved the lane, the column and the threshold with
// one-hot contractions on the MXU, because a per-row gather is slow there.
// Here a row reads its lane from a leaf -> lane table in shared memory and
// its split bin straight from the bin matrix.  Every feature's histogram
// block needs every row's lane, but the leaf vector must not change while
// another block still reads it, so routing is a launch of its own:
//
//   1. `route_kernel`, one thread per row: writes the new leaf vector, a
//      one-byte subset id (-1 = none) and, when the caller asks for it, the
//      int32 selector; with float values, each block's largest exponent of
//      each column over its selected rows.  Routing always compares FINE
//      bins.
//   2. `routed_hist_kernel` over the subset ids, then
//      `routed_reduce_kernel`, which adds the row blocks' partials in
//      row-block order and rounds once to float32.
//
// What bounds it on an H100: bytes, and in practice the latency of the row
// scan.  A pass must read the bin matrix (294 MB at 10.5M x 28, feature
// major, so at a wave's row densities every 32-byte sector holds a row of
// the smaller children) and the subset ids and values of the rows: about
// 0.1 ms at 3.35 TB/s.  A scan that loads one row at a time per thread
// keeps a few KB in flight per SM and runs at 3.3 ms.  The design keeps
// bytes in flight:
// - A thread takes 16 consecutive rows at a time: one 16-byte load of
//   subset ids, and, when one of the 16 rows is selected, the values as
//   16-byte loads and one 16-byte load of bins per feature (32 for int16
//   bins), the bins of two features in flight together (one with float
//   values, whose 16 x 3 floats fill the registers).  The next
//   group's subset ids load while this one is added.  A group with no
//   selected row loads nothing else.
// - A block takes a group of features and a range of rows, and keeps the
//   group's (features, W, Bc, cols) tile in shared memory: int32 for int8
//   values; for float values a 64-bit and a 32-bit integer word a cell
//   (below).  Integer sums are the same whatever the order of the
//   atomics, so every launch gives the same bits.  Where tiles are small
//   (coarse: 64 x 17 x 2 int32 = 8.7 KB a feature) a block takes many
//   features, and each subset word it loads serves all of them; at full
//   resolution (131 KB int8, 194 KB float at W = 21) it takes one.
// - The grid is one wave: (feature groups) x (row blocks) no more blocks
//   than the card runs at once at that shared memory (the wrapper asks the
//   card once, `ltt_routed_active_blocks`, and plans it: `routed_plan`).
//   Row blocks hold at most 2^24 rows (2^22 with float values), so no
//   integer partial can overflow.
// Float values are summed in fixed point, so that the sum does not depend
// on the order of the atomics (float64 atomics round in that order, so
// values whose exponents span much, such as binary-logloss hessians down
// to 1e-7, can give other bits from one launch to the next).  Column c's
// scale comes from E, the largest biased float32 exponent of its selected
// values in the call (the routing blocks' maxima; every |v| < 2^(E -
// 126)): a value v becomes the integer x = v * 2^(177 - E), |x| < 2^51,
// rounded to nearest (exact unless v is more than 2^27 times smaller
// than the largest).  The cell adds x >> 10 into an int64 word and the
// low 10 bits into a uint32 word (at most 2^22 rows: neither overflows),
// and the block's partial is (hi * 2^10 + lo) * 2^(E - 177) in float64:
// about 2^-52 of the column's largest value is the finest step, as fine
// as a float64 running sum.  A column that holds an infinity or a NaN
// gives NaN.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLanes = 64;
constexpr int kMaxFeatures = 2048;
constexpr int kGroup = 16;        // consecutive rows a thread takes at once
constexpr int kLoBits = 10;       // a float value's bits in the uint32 word

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// ---- 1. routing ------------------------------------------------------

// The biased exponent of a float32 (0 for zeros and subnormals).
__device__ __forceinline__ int exp_bits(float v) {
  return (int)((__float_as_uint(v) >> 23) & 0xffu);
}

// `fvals` (n, cols) float32 or null: with it, block b writes the largest
// exponent of each column over its selected rows to exp_max[b * cols + c].
template <typename BinT, typename IdxT>
__global__ void route_kernel(const BinT* __restrict__ bins,
                             const IdxT* __restrict__ leaf_idx,
                             const int32_t* __restrict__ tables,
                             int table_rows, int width,
                             const int32_t* __restrict__ miss_bin,
                             int num_features, int leaf_bound, int64_t n,
                             const float* __restrict__ fvals, int cols,
                             IdxT* __restrict__ leaf_out,
                             int8_t* __restrict__ lane_out,
                             int32_t* __restrict__ sel_out,
                             int32_t* __restrict__ exp_max) {
  extern __shared__ int8_t lane_of_leaf[];      // leaf_bound entries
  __shared__ int32_t l_feat[kMaxLanes], l_thr[kMaxLanes], l_new[kMaxLanes];
  __shared__ uint8_t l_small[kMaxLanes], l_dl[kMaxLanes];
  __shared__ int32_t mb[kMaxFeatures];
  __shared__ int32_t emax[3];
  for (int i = threadIdx.x; i < leaf_bound; i += blockDim.x)
    lane_of_leaf[i] = -1;
  if (threadIdx.x < 3) emax[threadIdx.x] = 0;
  const bool with_miss = table_rows >= 6 && miss_bin != nullptr;
  for (int w = threadIdx.x; w < width; w += blockDim.x) {
    l_feat[w] = tables[width + w];
    l_thr[w] = tables[2 * width + w];
    l_new[w] = tables[3 * width + w];
    l_small[w] = tables[4 * width + w] != 0;
    l_dl[w] = with_miss ? (tables[5 * width + w] != 0) : 0;
  }
  for (int f = threadIdx.x; f < num_features; f += blockDim.x)
    mb[f] = with_miss ? miss_bin[f] : -1;
  __syncthreads();
  if (threadIdx.x == 0) {
    // in lane order, so a leaf listed twice maps to its last lane (the
    // order of the reference's select chain); dummy lanes carry an id no
    // row holds
    for (int w = 0; w < width; ++w) {
      const int id = tables[w];
      if (id >= 0 && id < leaf_bound) lane_of_leaf[id] = (int8_t)w;
    }
  }
  __syncthreads();

  int e0 = 0, e1 = 0, e2 = 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const int li = (int)leaf_idx[r];
    const int lane = (li >= 0 && li < leaf_bound) ? lane_of_leaf[li] : -1;
    int out_leaf = li;
    int sel = -1;
    if (lane >= 0) {
      const int feat = l_feat[lane];
      const int col = (int)bins[(int64_t)feat * n + r];
      bool gl = col <= l_thr[lane];
      if (l_dl[lane] && mb[feat] >= 0 && col == mb[feat]) gl = true;
      if (!gl) out_leaf = l_new[lane];
      if (gl == (l_small[lane] != 0)) sel = lane;
    }
    leaf_out[r] = (IdxT)out_leaf;
    lane_out[r] = (int8_t)sel;
    if (sel_out != nullptr) sel_out[r] = sel;
    if (fvals != nullptr && sel >= 0) {
      const float* v = fvals + r * cols;
      e0 = max(e0, exp_bits(v[0]));
      e1 = max(e1, exp_bits(v[1]));
      if (cols == 3) e2 = max(e2, exp_bits(v[2]));
    }
  }
  if (fvals == nullptr) return;
  e0 = __reduce_max_sync(0xffffffffu, e0);
  e1 = __reduce_max_sync(0xffffffffu, e1);
  e2 = __reduce_max_sync(0xffffffffu, e2);
  if ((threadIdx.x & 31) == 0) {
    atomicMax(&emax[0], e0);
    atomicMax(&emax[1], e1);
    atomicMax(&emax[2], e2);
  }
  __syncthreads();
  if (threadIdx.x < cols)
    exp_max[(int64_t)blockIdx.x * cols + threadIdx.x] = emax[threadIdx.x];
}

// ---- 2. the histogram over 16-row groups --------------------------------

__device__ __forceinline__ void store4(uint32_t* w, uint4 v) {
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

// 16 rows' subset ids (int8, -1 = none).
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
};

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
__host__ __device__ constexpr int routed_threads() {
  return sizeof(ValT) == 1 ? 1024 : 512;
}

// Features whose bins load together: the most that fit the registers
// without spilling much (measured: int8 values 2 of 1, 2, 4 and 8; float
// values 1).
template <typename ValT>
__host__ __device__ constexpr int feat_batch() {
  return sizeof(ValT) == 1 ? 2 : 1;
}

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

template <typename BinT, typename ValT, typename AccT, int COLS>
__global__ void __launch_bounds__(routed_threads<ValT>(), 1)
routed_hist_kernel(const BinT* __restrict__ bins,
                   const int8_t* __restrict__ lanes,
                   const ValT* __restrict__ vals,
                   const int32_t* __restrict__ miss_bin, int shift,
                   int64_t n, int num_features, int feat_per_block,
                   int num_bins, int width, int64_t rows_per_block,
                   int bins_vec, const int32_t* __restrict__ exp_max,
                   int route_blocks, AccT* __restrict__ partial) {
  constexpr int kThreads = routed_threads<ValT>();
  constexpr int kFeatBatch = feat_batch<ValT>();
  extern __shared__ __align__(16) unsigned char sh_raw[];
  __shared__ int ebm[COLS];
  const int fcells = width * num_bins * COLS;
  const int f0 = blockIdx.x * feat_per_block;
  const int fc = min(feat_per_block, num_features - f0);
  const int cells = fc * fcells;
  Tile<ValT> tile(sh_raw, feat_per_block * fcells);
  int* mb = reinterpret_cast<int*>(
      sh_raw + Tile<ValT>::bytes(feat_per_block * fcells));
  for (int i = threadIdx.x; i < cells; i += kThreads) tile.zero(i);
  for (int i = threadIdx.x; i < fc; i += kThreads)
    mb[i] = shift > 0 && miss_bin != nullptr ? miss_bin[f0 + i] : -1;
  if (threadIdx.x < COLS) ebm[threadIdx.x] = 1;
  __syncthreads();
  if (exp_max != nullptr) {
    // each column's largest exponent over the routing blocks' maxima
    for (int i = threadIdx.x; i < route_blocks * COLS; i += kThreads)
      atomicMax(&ebm[i % COLS], exp_max[i]);
    __syncthreads();
  }
  double scale[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) scale[c] = ldexp(1.0, 177 - ebm[c]);

  const int miss_idx = num_bins - 1;
  const int64_t lo = (int64_t)blockIdx.y * rows_per_block;
  const int64_t hi = lo + rows_per_block < n ? lo + rows_per_block : n;
  const BinT* fbins = bins + (int64_t)f0 * n;
  constexpr int64_t kStep = (int64_t)kThreads * kGroup;
  int64_t r0 = lo + (int64_t)threadIdx.x * kGroup;
  Lanes16 next;
  if (r0 < hi) next.load(lanes, r0, hi);
  for (; r0 < hi; r0 += kStep) {
    const Lanes16 ln = next;
    if (r0 + kStep < hi) next.load(lanes, r0 + kStep, hi);
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
        const int m = mb[fb + q];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          const int s = ln.get(k);
          if ((unsigned)s >= (unsigned)width) continue;
          const int bin = bb[q].get(k);
          const int b = bin == m ? miss_idx : bin >> shift;
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

  // partial layout: (row block, feature, subset, bin, column)
  AccT* out = partial + ((int64_t)blockIdx.y * num_features + f0) * fcells;
  for (int i = threadIdx.x; i < cells; i += kThreads)
    out[i] = (AccT)tile.partial(i, ebm[i % COLS]);
}

// Fixed-order reduction over row blocks; writes (W, F, B, 3) float32 with
// the count channel a copy of hess when cols == 2.
template <typename AccT, typename SumT>
__global__ void routed_reduce_kernel(const AccT* __restrict__ partial,
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

// The kernel's dynamic shared memory: the tiles and the missing bins.
template <typename ValT>
size_t routed_smem(int fpb, int W, int B, int cols) {
  return Tile<ValT>::bytes(fpb * W * B * cols) +
         align16((size_t)fpb * sizeof(int));
}

template <typename BinT, typename ValT, typename AccT, typename SumT,
          int COLS>
cudaError_t launch_routed(const void* bins, const int8_t* lanes,
                          const void* vals, const int32_t* miss_bin,
                          int shift, int64_t n, int F, int fpb, int B, int W,
                          int row_blocks, int64_t rows_per_block,
                          int bins_vec, const int32_t* exp_max,
                          int route_blocks, void* partial, float* out,
                          cudaStream_t stream) {
  const size_t smem = routed_smem<ValT>(fpb, W, B, COLS);
  auto kern = routed_hist_kernel<BinT, ValT, AccT, COLS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((F + fpb - 1) / fpb, row_blocks);
  kern<<<grid, routed_threads<ValT>(), smem, stream>>>(
      (const BinT*)bins, lanes, (const ValT*)vals, miss_bin, shift, n, F, fpb,
      B, W, rows_per_block, bins_vec, exp_max, route_blocks, (AccT*)partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = (int64_t)F * W * B * COLS;
  const int rt = 256;
  routed_reduce_kernel<AccT, SumT><<<(unsigned)((total + rt - 1) / rt), rt, 0,
                                     stream>>>((const AccT*)partial,
                                               row_blocks, F, W, B, COLS,
                                               out);
  return cudaGetLastError();
}

// int8 values accumulate in int32 and reduce in int64; float values in
// fixed point, with float64 partials reduced in float64.
template <typename BinT, int COLS>
cudaError_t routed_by_values(int val_int8, const void* bins,
                             const int8_t* lanes, const void* vals,
                             const int32_t* miss_bin, int shift, int64_t n,
                             int F, int fpb, int B, int W, int row_blocks,
                             int64_t rows_per_block, int bins_vec,
                             const int32_t* exp_max, int route_blocks,
                             void* partial, float* out, cudaStream_t stream) {
  if (val_int8)
    return launch_routed<BinT, int8_t, int, long long, COLS>(
        bins, lanes, vals, miss_bin, shift, n, F, fpb, B, W, row_blocks,
        rows_per_block, bins_vec, nullptr, 0, partial, out, stream);
  return launch_routed<BinT, float, double, double, COLS>(
      bins, lanes, vals, miss_bin, shift, n, F, fpb, B, W, row_blocks,
      rows_per_block, bins_vec, exp_max, route_blocks, partial, out, stream);
}

template <typename BinT, typename IdxT>
cudaError_t route(const void* bins, const void* leaf_idx, const int32_t* tbl,
                  int table_rows, int width, const int32_t* miss_bin, int F,
                  int leaf_bound, int64_t n, const float* fvals, int cols,
                  int blocks, void* leaf_out, int8_t* lane_out,
                  int32_t* sel_out, int32_t* exp_max, cudaStream_t stream) {
  route_kernel<BinT, IdxT><<<blocks, 256, (size_t)leaf_bound, stream>>>(
      (const BinT*)bins, (const IdxT*)leaf_idx, tbl, table_rows, width,
      miss_bin, F, leaf_bound, n, fvals, cols, (IdxT*)leaf_out, lane_out,
      sel_out, exp_max);
  return cudaGetLastError();
}

template <typename BinT>
const void* hist_fn(int val_int8, int cols) {
  if (val_int8)
    return cols == 2 ? (const void*)routed_hist_kernel<BinT, int8_t, int, 2>
                     : (const void*)routed_hist_kernel<BinT, int8_t, int, 3>;
  return cols == 2 ? (const void*)routed_hist_kernel<BinT, float, double, 2>
                   : (const void*)routed_hist_kernel<BinT, float, double, 3>;
}

}  // namespace

// Blocks of the histogram kernel one SM runs at once with `smem` bytes of
// shared memory a block (negative: a CUDA error).
extern "C" int ltt_routed_active_blocks(int bin_bytes, int val_int8,
                                        int cols, int smem) {
  if ((bin_bytes != 1 && bin_bytes != 2) || (cols != 2 && cols != 3))
    return -(int)cudaErrorInvalidValue;
  const void* fn = bin_bytes == 1 ? hist_fn<uint8_t>(val_int8, cols)
                                  : hist_fn<uint16_t>(val_int8, cols);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fn, val_int8 ? routed_threads<int8_t>()
                            : routed_threads<float>(), smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// bins (F, N) uint8/int16; vals (N, cols) int8/float32 (cols = 2 with
// two_col, else 3), 16-byte aligned; leaf_idx (N,) uint8/int32 with ids <
// leaf_bound; tables (table_rows, W) int32; miss_bin (F,) int32 or null.
// Writes leaf_out (N,) (the type of leaf_idx), lane (N,) int8 scratch
// (16-byte aligned), sel_out (N,) int32 when not null, and out (W, F, B, 3)
// float32, B the bin count at `shift`.  The plan (features per block, row
// blocks, rows per block: a multiple of 16, at most 2^22 with float
// values) comes from the wrapper (`routed_plan` in ops/histogram.py);
// `partial` holds row_blocks x F x W x B x cols int32 (int8 values) or
// float64 (float values); `exp_max` route_blocks x cols int32 scratch
// (float values only).
extern "C" int ltt_routed_hist(const void* bins, int bin_bytes,
                               const void* vals, int val_int8, int two_col,
                               const void* leaf_idx, int idx_bytes,
                               const void* tables, int table_rows,
                               const void* miss_bin, int leaf_bound,
                               int64_t n, int num_features, int num_bins,
                               int width, int shift, int route_blocks,
                               int feat_per_block, int row_blocks,
                               int64_t rows_per_block, void* leaf_out,
                               void* lane, void* sel_out, void* exp_max,
                               void* partial, void* out, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (width < 1 || width > kMaxLanes || num_features > kMaxFeatures ||
      table_rows < 5 || leaf_bound < 1 || leaf_bound > 32768 || shift < 0 ||
      shift > 15 || feat_per_block < 1 || rows_per_block % kGroup != 0 ||
      (uintptr_t)vals % 16 != 0 || (uintptr_t)lane % 16 != 0 ||
      (!val_int8 && (exp_max == nullptr ||
                     rows_per_block > ((int64_t)1 << 22))))
    return (int)cudaErrorInvalidValue;
  const int32_t* tbl = (const int32_t*)tables;
  const int32_t* mb = (const int32_t*)miss_bin;
  int8_t* ln = (int8_t*)lane;
  int32_t* so = (int32_t*)sel_out;
  const int cols = two_col ? 2 : 3;
  const float* fv = val_int8 ? nullptr : (const float*)vals;
  int32_t* em = val_int8 ? nullptr : (int32_t*)exp_max;
  cudaError_t err;
  if (bin_bytes == 1 && idx_bytes == 1) {
    err = route<uint8_t, uint8_t>(bins, leaf_idx, tbl, table_rows, width, mb,
                                  num_features, leaf_bound, n, fv, cols,
                                  route_blocks, leaf_out, ln, so, em, stream);
  } else if (bin_bytes == 1 && idx_bytes == 4) {
    err = route<uint8_t, int32_t>(bins, leaf_idx, tbl, table_rows, width, mb,
                                  num_features, leaf_bound, n, fv, cols,
                                  route_blocks, leaf_out, ln, so, em, stream);
  } else if (bin_bytes == 2 && idx_bytes == 1) {
    err = route<uint16_t, uint8_t>(bins, leaf_idx, tbl, table_rows, width, mb,
                                   num_features, leaf_bound, n, fv, cols,
                                   route_blocks, leaf_out, ln, so, em,
                                   stream);
  } else if (bin_bytes == 2 && idx_bytes == 4) {
    err = route<uint16_t, int32_t>(bins, leaf_idx, tbl, table_rows, width, mb,
                                   num_features, leaf_bound, n, fv, cols,
                                   route_blocks, leaf_out, ln, so, em,
                                   stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  // 16-byte bin loads need every feature's row to start on 16 bytes
  const int bins_vec = (int)((uintptr_t)bins % 16 == 0 &&
                             (n * bin_bytes) % 16 == 0);
  const int32_t* hmb = shift > 0 ? mb : nullptr;
  float* o = (float*)out;
  const int F = num_features;
#define LTT_ROUTED(BinT, COLS)                                              \
  routed_by_values<BinT, COLS>(val_int8, bins, ln, vals, hmb, shift, n, F,  \
                               feat_per_block, num_bins, width, row_blocks, \
                               rows_per_block, bins_vec, em, route_blocks,  \
                               partial, o, stream)
  if (bin_bytes == 1)
    err = two_col ? LTT_ROUTED(uint8_t, 2) : LTT_ROUTED(uint8_t, 3);
  else
    err = two_col ? LTT_ROUTED(uint16_t, 2) : LTT_ROUTED(uint16_t, 3);
#undef LTT_ROUTED
  return (int)err;
}
