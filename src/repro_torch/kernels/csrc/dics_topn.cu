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
// topn_select gives them. sqrtf and '/' are IEEE-rounded (no fast-math),
// the sum has a fixed order and co is read as co[p, q] (never assumed
// symmetric), so the scores equal the plain version's bit for bit.
//
// What bounds it: bytes — each query's history row is read once, and the
// co entries of the (candidate, history) pairs, from L2. The TPU kernel
// runs k_nn dense max-extract passes over [block_p, I] per query; here
// the history, a few items on average, is compacted first, so the work
// is I * |h| similarities and a k_nn insertion list per candidate.
//
// Design (tests/test_torch_kernels.py::dics_topn_schedule models it on
// the CPU): one CTA of 8 warps serves kGroup queries of one worker,
// strided over its rows (CTA c of n takes rows c, c + n, ...: the serve
// plane pads each worker's rows at the end, so this spreads the real
// queries evenly over the CTAs).
// Each warp compacts one query's history row into a shared-memory list
// (ballots, so no atomics) and a bitmap. A query without a history (or
// an unknown user) has no candidate, so its list is the worker's N
// smallest ids at -inf: the CTA computes that list once, as one "empty"
// work item, and copies it. For every other query all 8 warps take a
// share of the candidates (warp w: p = 32 w + lane + 256 j), so a long
// history is spread over the CTA. Each lane keeps its candidate's k_nn
// list in registers (a sorted list of KCAP >= k_nn entries, KCAP in
// {4, 8, 10, 16, 32}: compile-time indices, predicated inserts, no local
// memory) and loads kLoads co entries ahead of their inserts. Each warp
// keeps a running top-N across its candidates with one entry per lane
// (lane j holds the j-th best; a new entry finds its rank by a ballot
// and shifts the tail by a shuffle). The 8 warp lists of a query are
// merged by N rounds of an 8-lane shuffle arg-max.
#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "smem_limit.cuh"
#include "topn_merge.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 8;            // queries per CTA (fewer when I is large)
constexpr int kEmpty = kGroup;       // the work item of history-less queries
constexpr int kMaxN = 32;
constexpr int kLoads = 8;            // co loads issued ahead of their inserts
constexpr size_t kMaxDynamicSmem = 200 * 1024;

__host__ __device__ size_t smem_per_query(int I) {
  return (size_t)I * sizeof(int) + (size_t)((I + 31) / 32) * sizeof(uint32_t);
}

// Insert v into the descending list top[0..KCAP).
template <int KCAP>
__device__ __forceinline__ void insert_desc(float (&top)[KCAP], float v) {
  if (!(v > top[KCAP - 1])) return;
#pragma unroll
  for (int j = KCAP - 1; j > 0; --j) {
    top[j] = v > top[j - 1] ? top[j - 1] : (v > top[j] ? v : top[j]);
  }
  top[0] = v > top[0] ? v : top[0];
}

// Eq. 7 mass of candidate p over the compacted history hl[0..H): the
// K largest sims (zeros beyond |h|) added in descending order; -inf when
// not positive. p is never in its own history, so the diagonal is out.
template <int KCAP>
__device__ __forceinline__ float neighbour_mass(const float* co_p, float cp,
                                                const float* cnt,
                                                const int* hl, int H, int K) {
  float top[KCAP];
#pragma unroll
  for (int j = 0; j < KCAP; ++j) top[j] = 0.f;
  for (int x0 = 0; x0 < H; x0 += kLoads) {
    float c[kLoads], cq[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      c[j] = 0.f;
      if (x0 + j < H) {
        const int q = hl[x0 + j];
        c[j] = co_p[q];
        cq[j] = cnt[q];
      }
    }
    // A sim that is not positive never enters the list (its entries are
    // >= 0), so only a positive count is divided.
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      if (c[j] > 0.f) {
        const float denom = sqrtf(cp * cq[j]);
        insert_desc(top, denom > 0.f ? c[j] / fmaxf(denom, 1e-12f) : 0.f);
      }
    }
  }
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < KCAP; ++j) {
    if (j < K) acc = acc + top[j];
  }
  return acc > 0.f ? acc : -INFINITY;
}

template <int KCAP>
__global__ void __launch_bounds__(kThreads) dics_topn_kernel(
    const float* __restrict__ co, const float* __restrict__ cnt,
    const uint8_t* __restrict__ hist, const uint8_t* __restrict__ known,
    const int* __restrict__ ids, int* __restrict__ out_ids,
    float* __restrict__ out_sc, int B, int I, int N, int K, int G) {
  extern __shared__ int smem[];
  __shared__ int n_hist[kGroup];
  __shared__ int work[kGroup + 1];
  __shared__ int n_work;
  __shared__ float psc[kGroup + 1][kWarps][kMaxN];
  __shared__ int pid[kGroup + 1][kWarps][kMaxN];
  __shared__ float msc[kGroup + 1][kMaxN];
  __shared__ int mid[kGroup + 1][kMaxN];
  const int64_t w = blockIdx.y;
  const int b0 = blockIdx.x, stride = gridDim.x;  // query qb: row b0 + qb * stride
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int words = (I + 31) / 32;
  int* hl = smem;                                          // [G][I]
  uint32_t* hb = reinterpret_cast<uint32_t*>(smem + G * I);  // [G][words]
  co += w * I * (int64_t)I;
  cnt += w * I;
  ids += w * I;

  // Compact each query's history: warp qb takes query qb, the bytes of
  // kLoads words loaded before their ballots.
  for (int qb = warp; qb < G; qb += kWarps) {
    const int64_t b = b0 + (int64_t)qb * stride;
    int count = 0;
    if (b < B && known[w * B + b]) {
      const uint8_t* row = hist + (w * B + b) * (int64_t)I;
      for (int base = 0; base < I; base += 32 * kLoads) {
        bool in[kLoads];
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          const int p = base + 32 * j + lane;
          in[j] = p < I && row[p];
        }
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          const int p = base + 32 * j + lane;
          const unsigned m = __ballot_sync(kFull, in[j]);
          if (lane == 0 && p - lane < I) hb[qb * words + p / 32] = m;
          if (in[j]) hl[qb * I + count + __popc(m & ((1u << lane) - 1))] = p;
          count += __popc(m);
        }
      }
    }
    if (lane == 0) n_hist[qb] = count;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    bool empty = false;
    for (int qb = 0; qb < G && b0 + qb * stride < B; ++qb) {
      if (n_hist[qb] > 0) {
        work[n++] = qb;
      } else {
        empty = true;
      }
    }
    if (empty) work[n++] = kEmpty;
    n_work = n;
  }
  __syncthreads();

  // Every warp's share of the candidates, for each work item.
  for (int x = 0; x < n_work; ++x) {
    const int qb = work[x];
    const int H = qb == kEmpty ? 0 : n_hist[qb];
    const int* hlq = hl + qb * I;
    const uint32_t* hbq = hb + qb * words;
    float lsc = -INFINITY;
    int lid = INT_MAX;
    for (int base = warp * 32; base < I; base += kThreads) {
      const int p = base + lane;
      float s = -INFINITY;
      int id = INT_MAX;
      if (p < I) {
        id = ids[p];
        if (H > 0 && id >= 0 && !((hbq[p >> 5] >> (p & 31)) & 1u)) {
          s = neighbour_mass<KCAP>(co + (int64_t)p * I, cnt[p], cnt, hlq, H,
                                   K);
        }
      }
      offer(lsc, lid, s, id, N, lane);
    }
    if (lane < N) {
      psc[x][warp][lane] = lsc;
      pid[x][warp][lane] = lid;
    }
  }
  __syncthreads();

  // Merge the 8 warp lists of each work item: lane l < 8 owns list l.
  for (int x = warp; x < n_work; x += kWarps) {
    merge_lists<kWarps>(&psc[x][0][0], &pid[x][0][0], kMaxN, N, lane,
                        msc[x], mid[x]);
  }
  __syncthreads();

  // Each query's list: its own work item's, or the empty item's.
  for (int t = tid; t < G * N; t += kThreads) {
    const int qb = t / N, r = t % N;
    const int64_t b = b0 + (int64_t)qb * stride;
    if (b >= B) continue;
    int x = n_work - 1;                       // the empty item, last
    for (int y = 0; y < n_work; ++y) {
      if (work[y] == qb) x = y;
    }
    out_ids[(w * B + b) * N + r] = mid[x][r];
    out_sc[(w * B + b) * N + r] = msc[x][r];
  }
}

template <int KCAP>
int launch(const void* co, const void* cnt, const void* hist,
           const void* known, const void* ids, void* out_ids, void* out_sc,
           int W, int B, int I, int N, int K, cudaStream_t stream) {
  int G = kGroup;
  while (G > 1 && G * smem_per_query(I) > kMaxDynamicSmem) --G;
  const size_t smem = G * smem_per_query(I);
  if (smem > kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  // Static and dynamic shared memory may pass 48 KB together: the
  // instance may take the whole budget.
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err = allow_dynamic_smem(
      dics_topn_kernel<KCAP>, (int)kMaxDynamicSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + G - 1) / G, W);
  dics_topn_kernel<KCAP><<<grid, kThreads, smem, stream>>>(
      (const float*)co, (const float*)cnt, (const uint8_t*)hist,
      (const uint8_t*)known, (const int*)ids, (int*)out_ids, (float*)out_sc,
      B, I, N, K, G);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dics_topn_launch(const void* co, const void* cnt,
                                const void* hist, const void* known,
                                const void* ids, void* out_ids, void* out_sc,
                                int W, int B, int I, int N, int K,
                                void* stream) {
  if (W == 0 || B == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
#define DICS_TOPN_LAUNCH(KCAP)                                               \
  if (K <= KCAP)                                                             \
    return launch<KCAP>(co, cnt, hist, known, ids, out_ids, out_sc, W, B, I, \
                        N, K, s);
  DICS_TOPN_LAUNCH(4)
  DICS_TOPN_LAUNCH(8)
  DICS_TOPN_LAUNCH(10)
  DICS_TOPN_LAUNCH(16)
  DICS_TOPN_LAUNCH(32)
#undef DICS_TOPN_LAUNCH
  return (int)cudaErrorInvalidValue;
}
