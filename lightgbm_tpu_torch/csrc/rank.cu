// Kernel U: the lambdas of every query of a ranking dataset in one launch.
//
// It replaces no TPU kernel: the JAX package computes LambdaRank's
// gradients in XLA (`LambdaRank._grads_impl`,
// lightgbm_tpu/objectives.py:714-776) over queries padded to
// (num_queries, max_docs), an all-pairs (cq, mq, mq) tensor a chunk of
// queries, two argsorts and a scatter-add.  For each query q (a contiguous
// row range [qb[q], qb[q + 1])) and each document i it computes
//   g_i = sum_{j: l_i > l_j} lam(i, j) - sum_{j: l_j > l_i} lam(j, i)
//   h_i = sum_{j: l_i > l_j} eta(i, j) + sum_{j: l_j > l_i} eta(j, i)
// with, for a pair (hi, lo) of labels l_hi > l_lo,
//   ds = s_hi - s_lo, delta = (gain_hi - gain_lo) |disc_hi - disc_lo| inv_q
//   (divided by 0.01 + |ds| under lambdamart_norm when the query's scores
//   are not all equal), p = 2 / (1 + exp(clip(2 sigmoid ds, -60, 60))),
//   lam = -delta p, eta = 2 delta p (2 - p),
// disc = 1 / log2(2 + rank) from a table the wrapper gives (`disc_tab`),
// and rank the position in a stable descending order of the query's
// scores: rank_i = #{j: s_j > s_i} + #{j < i: s_j == s_i}.  Each row is
// then multiplied by its weight when the data has weights.
//
// What bounds it on an H100: operations.  Its bytes are a score, label,
// gain and the two outputs a row (~45 MB at the MS-LTR shape, 2.27M rows:
// 0.014 ms at 3.35 TB/s), while the pairs of documents with different
// labels each take a float64 exp and two float64 divisions (about 150M
// unordered pairs at that shape).
//
// The design: one block a query.
// - The query's scores, labels, gains and discounts go into shared memory
//   (20 bytes a document; up to the wrapper's smem_docs, which
//   ops/rank.py's SMEM_DOCS caps at 225 KB of a block's 227).  A larger
//   query walks its rows from device memory (L2 holds them) and keeps its
//   discounts in the wrapper's float64 scratch row; no query size is
//   refused.
// - The rank is the count above, O(m^2) compares in one pass (the pairs
//   cost O(m^2) anyway): no sort, so the tie rule cannot differ.  On the
//   first iteration every score is equal and the ranks are the rows'
//   order inside the query.
// - A block reduction gives the query's min and max score.
// - A thread owns documents i = tid, tid + blockDim, ... and walks every j
//   in index order, summing g_i and h_i in float64, then rounds each once
//   to float32: no atomics, a repeat gives the same bits, and the plain
//   version (the same terms in float64, summed with torch.sum, rounded
//   once; ops/rank.py) gives the same bits unless a sum lands within a
//   float64 rounding of a float32 rounding boundary.  The build's
//   -fmad=false keeps every product its own rounding, as in PyTorch.
// - A query of one document writes zeros.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDefaultSmem = 48 * 1024;
// shared bytes a document: its discount (float64), score, gain, label
constexpr int kDocBytes = 20;

__global__ void __launch_bounds__(kThreads)
    lambda_kernel(const float* __restrict__ score,
                  const int64_t* __restrict__ qb,
                  const int32_t* __restrict__ label,
                  const float* __restrict__ gain,
                  const float* __restrict__ inv_max,
                  const double* __restrict__ disc_tab,
                  const float* __restrict__ weight, double coef, int norm,
                  int smem_docs, double* __restrict__ scratch,
                  float* __restrict__ grad, float* __restrict__ hess) {
  extern __shared__ double smem[];
  __shared__ float red_lo[kWarps], red_hi[kWarps];
  const int q = blockIdx.x;
  const int64_t start = qb[q];
  const int m = (int)(qb[q + 1] - start);
  const int tid = threadIdx.x;
  const double* D;
  double* Dw;
  const float* S;
  const float* G;
  const int32_t* L;
  if (m <= smem_docs) {
    double* d_s = smem;
    float* s_s = reinterpret_cast<float*>(d_s + smem_docs);
    float* g_s = s_s + smem_docs;
    int32_t* l_s = reinterpret_cast<int32_t*>(g_s + smem_docs);
    for (int i = tid; i < m; i += kThreads) {
      s_s[i] = score[start + i];
      g_s[i] = gain[start + i];
      l_s[i] = label[start + i];
    }
    D = Dw = d_s;
    S = s_s;
    G = g_s;
    L = l_s;
  } else {
    D = Dw = scratch + start;
    S = score + start;
    G = gain + start;
    L = label + start;
  }
  __syncthreads();
  // the query's min and max score
  float lo = INFINITY, hi = -INFINITY;
  for (int i = tid; i < m; i += kThreads) {
    lo = fminf(lo, S[i]);
    hi = fmaxf(hi, S[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if ((tid & 31) == 0) {
    red_lo[tid >> 5] = lo;
    red_hi[tid >> 5] = hi;
  }
  // each document's rank by the count, then its discount
  for (int i = tid; i < m; i += kThreads) {
    const float si = S[i];
    int r = 0;
    for (int j = 0; j < m; ++j) {
      const float sj = S[j];
      r += (sj > si) | ((sj == si) & (j < i));
    }
    Dw[i] = disc_tab[r];
  }
  __syncthreads();
  lo = red_lo[0];
  hi = red_hi[0];
  for (int w = 1; w < kWarps; ++w) {
    lo = fminf(lo, red_lo[w]);
    hi = fmaxf(hi, red_hi[w]);
  }
  const bool scaled = norm && hi != lo;
  const double inv = (double)inv_max[q];
  for (int i = tid; i < m; i += kThreads) {
    const double si = S[i], gi = G[i], di = D[i];
    const int li = L[i];
    double g = 0.0, h = 0.0;
#pragma unroll 1
    for (int j = 0; j < m; ++j) {
      const int lj = L[j];
      if (lj == li) continue;
      const bool up = li > lj;
      const double sj = S[j], gj = G[j];
      const double ds = up ? si - sj : sj - si;
      const double dg = up ? gi - gj : gj - gi;
      double delta = dg * fabs(di - D[j]) * inv;
      if (scaled) delta = delta / (0.01 + fabs(ds));
      const double x = fmin(fmax(coef * ds, -60.0), 60.0);
      const double p = 2.0 / (1.0 + exp(x));
      const double t = delta * p;
      const double eta = 2.0 * delta * p * (2.0 - p);
      g = up ? g - t : g + t;
      h = h + eta;
    }
    float gf = (float)g, hf = (float)h;
    if (weight != nullptr) {
      const float w = weight[start + i];
      gf = gf * w;
      hf = hf * w;
    }
    grad[start + i] = gf;
    hess[start + i] = hf;
  }
}

}  // namespace

// score, gain, grad, hess, weight (or null): (n,) float32; label (n,) int32;
// qb (nq + 1,) int64; inv_max (nq,) float32; disc_tab (max docs,) float64;
// scratch: (n,) float64 when a query holds more than smem_docs documents,
// else null; smem_docs: the largest query that fits, which sizes the
// dynamic shared memory (more than a block may take fails the launch).
extern "C" int ltt_lambdarank(const void* score, const void* qb, int nq,
                              const void* label, const void* gain,
                              const void* inv_max, const void* disc_tab,
                              const void* weight, double coef, int norm,
                              int smem_docs, void* scratch, void* grad,
                              void* hess, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (nq < 1 || smem_docs < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)smem_docs * kDocBytes;
  if (smem > (size_t)kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        lambda_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lambda_kernel<<<nq, kThreads, smem, stream>>>(
      (const float*)score, (const int64_t*)qb, (const int32_t*)label,
      (const float*)gain, (const float*)inv_max, (const double*)disc_tab,
      (const float*)weight, coef, norm, smem_docs, (double*)scratch,
      (float*)grad, (float*)hess);
  return (int)cudaGetLastError();
}
