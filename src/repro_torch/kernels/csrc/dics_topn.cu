// dics_topn: the DICS serving leaf — Eq. 6 similarity, Eq. 7 neighbour
// mass over the query's history, candidate rule and running top-N, fused.
//
// Replaces the Pallas TPU kernel src/repro/kernels/topn.py::
// _dics_topn_kernel with its merge _merge_topn (wrapper dics_topn_pallas,
// pl.pallas_call at :219). Plain version: src/repro_torch/kernels/ref.py::
// dics_topn (the jnp path of repro/core/dics.py::dics_partial_topn).
//
// For every worker w and query row b, with history h = {q : hist[b, q]}:
//   sim(p, q) = co[p, q] / max(sqrt(cnt[p] * cnt[q]), 1e-12), 0 where the
//               square root is 0 and on the diagonal;
//   mass(p)   = the k_nn largest sim(p, q), q in h (zeros beyond |h|),
//               added one by one in descending order;
//   p is a candidate if its slot is live, the user has not rated it, the
//   user is known and mass(p) > 0; others score -inf with their real ids;
// and the N best (score, id) pairs in the order (score desc, id asc), as
// topn_select gives them. sqrtf and '/' are IEEE-rounded (no fast-math)
// and the sum has a fixed order, so the scores equal the plain version's
// bit for bit.
//
// What bounds it: bytes — each query's history row is read once, and the
// co entries of the (candidate, history) pairs, from L2. The TPU kernel
// runs k_nn dense max-extract passes over [block_p, I] per query; here
// the history, a few items on average, is compacted first, so the work
// is I * |h| similarities and a k_nn insertion list per candidate.
//
// Design: one CTA per (query, worker). The history indices are compacted
// into shared memory; each thread owns candidates p = t, t + T, ... and
// keeps a register list of its k_nn largest sims and a sorted top-N of its
// candidates. Each warp merges its 32 lists with N rounds of a shuffle
// arg-max over (score desc, id asc, lane asc), popping the winner's head
// (topn_merge.cuh); warp 0 then merges the eight warp lists the same
// way.
#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topn_merge.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxN = 32;
constexpr int kMaxKnn = 32;

__global__ void __launch_bounds__(kThreads) dics_topn_kernel(
    const float* __restrict__ co, const float* __restrict__ cnt,
    const uint8_t* __restrict__ hist, const uint8_t* __restrict__ known,
    const int* __restrict__ ids, int* __restrict__ out_ids,
    float* __restrict__ out_sc, int B, int I, int N, int K) {
  extern __shared__ int hist_s[];  // [I] compacted history indices
  __shared__ int n_hist;
  __shared__ float wsc[kWarps][kMaxN];
  __shared__ int wid[kWarps][kMaxN];
  const int64_t w = blockIdx.y;
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  co += w * I * (int64_t)I;
  cnt += w * I;
  ids += w * I;
  hist += (w * B + b) * (int64_t)I;
  out_ids += (w * B + b) * N;
  out_sc += (w * B + b) * N;
  const bool is_known = known[w * B + b] != 0;

  if (tid == 0) n_hist = 0;
  __syncthreads();
  if (is_known) {
    for (int q = tid; q < I; q += kThreads) {
      if (hist[q]) hist_s[atomicAdd(&n_hist, 1)] = q;
    }
  }
  __syncthreads();
  const int h = n_hist;  // the order of hist_s does not change any sum

  float lsc[kMaxN];
  int lid[kMaxN];
  for (int j = 0; j < kMaxN; ++j) {
    lsc[j] = -INFINITY;
    lid[j] = INT_MAX;
  }
  float worst_sc = -INFINITY;
  int worst_id = INT_MAX;
  for (int p = tid; p < I; p += kThreads) {
    const int id = ids[p];
    float s = -INFINITY;
    if (is_known && id >= 0 && !hist[p]) {
      float top[kMaxKnn];
      for (int j = 0; j < K; ++j) top[j] = 0.f;
      const float cp = cnt[p];
      const float* co_p = co + (int64_t)p * I;
      for (int x = 0; x < h; ++x) {
        const int q = hist_s[x];
        if (q == p) continue;  // an item is not its own neighbour
        const float denom = sqrtf(cp * cnt[q]);
        const float v = denom > 0.f ? co_p[q] / fmaxf(denom, 1e-12f) : 0.f;
        if (v > top[K - 1]) {
          int j = K - 1;
          while (j > 0 && v > top[j - 1]) {
            top[j] = top[j - 1];
            --j;
          }
          top[j] = v;
        }
      }
      float acc = 0.f;
      for (int j = 0; j < K; ++j) acc = acc + top[j];
      if (acc > 0.f) s = acc;
    }
    if (better(s, id, worst_sc, worst_id)) {
      int j = N - 1;
      while (j > 0 && better(s, id, lsc[j - 1], lid[j - 1])) {
        lsc[j] = lsc[j - 1];
        lid[j] = lid[j - 1];
        --j;
      }
      lsc[j] = s;
      lid[j] = id;
      worst_sc = lsc[N - 1];
      worst_id = lid[N - 1];
    }
  }

  warp_merge(lsc, lid, N, N, lane, wsc[warp], wid[warp]);
  __syncthreads();
  if (warp == 0) {
    const bool has = lane < kWarps;
    warp_merge(has ? wsc[lane] : wsc[0], has ? wid[lane] : wid[0],
               has ? N : 0, N, lane, out_sc, out_ids);
  }
}

}  // namespace

extern "C" int dics_topn_launch(const void* co, const void* cnt,
                                const void* hist, const void* known,
                                const void* ids, void* out_ids, void* out_sc,
                                int W, int B, int I, int N, int K,
                                void* stream) {
  if (W == 0 || B == 0) return 0;
  const size_t smem = (size_t)I * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dics_topn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(B, W);
  dics_topn_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)co, (const float*)cnt, (const uint8_t*)hist,
      (const uint8_t*)known, (const int*)ids, (int*)out_ids, (float*)out_sc,
      B, I, N, K);
  return (int)cudaGetLastError();
}
