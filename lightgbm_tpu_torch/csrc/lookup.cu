// Kernel L: fused leaf-value lookup and score add.
//
// Replaces the TPU kernel `_take_small_pallas` / `_lookup_kernel`
// (lightgbm_tpu/ops/lookup.py:35, :26), which resolved `vals[leaf_idx]`
// with a select chain over the table, and the separate score add that
// followed it (lightgbm_tpu/models/gbdt.py:2286-2290):
//
//   score[i] += vals[leaf_idx[i]]
//
// The table (at most 512 float32 leaf values) is staged in shared memory;
// each thread handles 16 bytes of leaf_idx (16 rows of uint8 ids, 4 of
// int32) and the matching score floats with 16-byte loads and stores.
//
// What bounds it on an H100: bytes.  One pass reads the ids and the score
// and writes the score back: 9 bytes a row with uint8 ids, 94.5 MB at
// 10.5M rows, about 28 us at 3.35 TB/s.  Nothing is materialised between
// the lookup and the add.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTable = 512;

template <typename IdxT>
__global__ void leaf_add_kernel(const IdxT* __restrict__ idx,
                                const float* __restrict__ vals, int table,
                                float* __restrict__ score, int64_t n) {
  __shared__ float tab[kMaxTable];
  for (int i = threadIdx.x; i < table; i += blockDim.x) tab[i] = vals[i];
  __syncthreads();
  constexpr int kPer = 16 / sizeof(IdxT);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * kPer;
  for (int64_t base = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * kPer;
       base < n; base += stride) {
    if (base + kPer <= n) {
      union {
        uint4 v;
        IdxT e[kPer];
      } ids;
      ids.v = *reinterpret_cast<const uint4*>(idx + base);
      float4* s4 = reinterpret_cast<float4*>(score + base);
#pragma unroll
      for (int q = 0; q < kPer / 4; ++q) {
        float4 s = s4[q];
        s.x += tab[(int)ids.e[q * 4]];
        s.y += tab[(int)ids.e[q * 4 + 1]];
        s.z += tab[(int)ids.e[q * 4 + 2]];
        s.w += tab[(int)ids.e[q * 4 + 3]];
        s4[q] = s;
      }
    } else {
      for (int64_t i = base; i < n; ++i) score[i] += tab[(int)idx[i]];
    }
  }
}

}  // namespace

extern "C" int ltt_leaf_add(const void* idx, int idx_bytes, const void* vals,
                            int table, void* score, int64_t n, int blocks,
                            void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (table > kMaxTable || table < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  if (idx_bytes == 1) {
    leaf_add_kernel<uint8_t><<<blocks, threads, 0, stream>>>(
        (const uint8_t*)idx, (const float*)vals, table, (float*)score, n);
  } else if (idx_bytes == 4) {
    leaf_add_kernel<int32_t><<<blocks, threads, 0, stream>>>(
        (const int32_t*)idx, (const float*)vals, table, (float*)score, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
