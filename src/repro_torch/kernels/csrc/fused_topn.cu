// fused_topn: the serving leaf — score, mask and running top-N in one pass.
//
// Replaces the Pallas TPU kernel src/repro/kernels/topn.py::
// _fused_topn_kernel with its merge _merge_topn (wrapper fused_topn_pallas,
// pl.pallas_call at :118). Plain version: src/repro_torch/kernels/ref.py::
// fused_topn (masked_scores, then topn_select).
//
// For every worker w and query row b: the N best (score, id) pairs over
// the worker's items, in the order (score desc, id asc). Masked items
// score -inf and keep their real ids (-1 for an empty slot), so a short
// list surfaces them with ids ascending, as topn_select does; unused
// entries are (-inf, INT_MAX), after every real entry. The [B, I] score
// matrix is never written. Each score is one FMA chain over k ascending
// from 0 (as masked_scores.cu's), so scores are bit-identical to the
// earlier design's.
//
// What bounds it: bytes, the mask (1 byte per (row, item)) read once; the
// item table is read from L2 once per CTA. The selection work is a
// compare per candidate plus the insertions into the running lists.
//
// Design (tests/test_torch_kernels.py::fused_topn_schedule models it on
// the CPU): one CTA of 8 warps serves 8 queries of one worker, strided
// over its rows (CTA c of n takes rows c, c + n, ...: the serve plane
// pads each worker's rows at the end, so this spreads the real queries
// and the padding evenly over the CTAs). The CTA walks the worker's
// items 1,024 at a time, each thread owning 4 consecutive items. A
// pass's item vectors, ids and the queries' mask bytes come into shared
// memory by coalesced cp.async copies, issued while the previous pass's
// lists take their scores (plain loads where a source is not 16-byte
// aligned: I % 16 != 0, a mask at an odd address). Each thread reads its
// 4 vectors into registers once, its ids and one 4-byte mask word per
// query, and scores its 4 items against every query of the group, the 4
// FMA chains side by side, into a shared score tile (-inf where not a
// finite candidate). Warp q then keeps query q's running top-N, one
// entry per lane in registers (topn_merge.cuh's offer): each lane marks
// which of its 32 scores of the pass beat the list's last entry and only
// marked rounds are offered; while the list still fills, a score below
// the N-th best of the 32 lanes' best scores is not marked (N items of
// the pass score at least that much). One list a query, not one a (warp,
// query): every item is offered to one list, so the insertions are
// those of one top-N over I items (about N (1 + ln(I / N))), not eight
// times those over I / 8. A row with no candidate (an unknown user, a
// padding row) takes the worker's N smallest ids at -inf: every warp
// keeps that list over its own items, and the 8 warp lists are merged
// once for the CTA by N rounds of an 8-lane shuffle arg-max. A row with 1
// to N - 1 finite scores needs its smallest non-candidate ids as well:
// the CTA runs an exact pass over that row's items (every item offered
// with its score or -inf, split over the warps and merged), which is
// rare. No per-thread array is indexed at run time.
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
constexpr int kItems = 4;                 // consecutive items a thread
constexpr int kSpan = kThreads * kItems;  // items a CTA scores per pass
constexpr int kGroup = kWarps;            // queries a CTA, a list a warp
constexpr int kEmpty = kGroup;            // the list of candidate-less rows
constexpr int kMaxN = 32;
static_assert(kItems == 4, "a thread's scores of a query are one float4");

// Dynamic shared memory, in 4-byte words then bytes: the staged vectors
// (stage_pass), the pass's scores (kSpan a query) and ids, the staged ids,
// then the staged mask bytes.
__host__ __device__ constexpr int vec_words(int K) {
  return kThreads * (kItems * K + 4);
}
constexpr int smem_bytes(int K) {
  return (vec_words(K) + kGroup * kSpan + 2 * kSpan) * 4 + kGroup * kSpan;
}

// Issues a 16-byte cp.async copy global -> shared.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// The pass at `first`, staged in shared memory: its items' vectors (thread
// t's kItems * K floats at t * (kItems * K + 4), so each thread's block
// starts 16-byte aligned and its float4 reads hit distinct banks), their
// ids, and each query row's mask bytes. Where a source is 16-byte
// aligned it comes by coalesced cp.async copies, else by plain loads and
// stores.
struct Stage {
  float* vec;     // [kThreads][kItems * K + 4]
  int* ids;       // [kSpan]
  uint8_t* mask;  // [kGroup][kSpan]
};

template <int KCAP>
__device__ __forceinline__ void stage_pass(const Stage& st, const float* items,
                                           const int* ids, const uint8_t* rows,
                                           int64_t row_step, int n_rows,
                                           int first, int I, int K,
                                           bool async_vec, bool async_ids,
                                           bool async_mask) {
  const int tid = threadIdx.x;
  const int n_items = min(kSpan, I - first);
  const int n = n_items * K;
  const float* src = items + (int64_t)first * K;
  const int n4 = async_vec ? n / 4 : 0;
  for (int x = tid; x < n4; x += kThreads) {
    const int e = 4 * x;
    const int owner = K == KCAP ? e / (kItems * KCAP) : e / (kItems * K);
    copy16(st.vec + e + 4 * owner, src + e);
  }
  for (int e = 4 * n4 + tid; e < n; e += kThreads)
    st.vec[e + 4 * (e / (kItems * K))] = __ldg(src + e);
  const int i4 = async_ids ? n_items / 4 : 0;
  if (tid < i4) copy16(st.ids + 4 * tid, ids + first + 4 * tid);
  for (int p = 4 * i4 + tid; p < n_items; p += kThreads)
    st.ids[p] = __ldg(ids + first + p);
  const int m16 = async_mask ? n_items / 16 : 0;
  for (int x = tid; x < n_rows * m16; x += kThreads) {
    const int q = x / m16, c = x - q * m16;
    copy16(st.mask + q * kSpan + 16 * c, rows + q * row_step + first + 16 * c);
  }
  for (int x = tid; x < n_rows * (n_items - 16 * m16); x += kThreads) {
    const int q = x / (n_items - 16 * m16);
    const int p = 16 * m16 + x - q * (n_items - 16 * m16);
    st.mask[q * kSpan + p] = __ldg(rows + q * row_step + first + p);
  }
  asm volatile("cp.async.commit_group;\n");
}

// The thread's kItems vectors from its block of the tile (zeros past I).
template <int KCAP>
__device__ __forceinline__ void read_items(const float* mine, int p0, int I,
                                           int K, float (&it)[kItems][KCAP]) {
  if (K == KCAP && p0 + kItems <= I) {  // kItems rows are KCAP float4s
    const float4* src = reinterpret_cast<const float4*>(mine);
#pragma unroll
    for (int q = 0; q < KCAP; ++q) {
      const float4 v = src[q];
      const int f = 4 * q;
      it[f / KCAP][f % KCAP] = v.x;
      it[(f + 1) / KCAP][(f + 1) % KCAP] = v.y;
      it[(f + 2) / KCAP][(f + 2) % KCAP] = v.z;
      it[(f + 3) / KCAP][(f + 3) % KCAP] = v.w;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
#pragma unroll
    for (int k = 0; k < KCAP; ++k)
      it[j][k] = p0 + j < I && k < K ? mine[j * K + k] : 0.f;
  }
}

// The staged mask bytes of items i0 .. i0 + 3 (i0 within the pass, p0 in
// the worker) of one row, byte j at bits 8j; 0 past I.
__device__ __forceinline__ uint32_t mask_word(const uint8_t* row, int i0,
                                              int p0, int I) {
  if (p0 + kItems <= I) return *reinterpret_cast<const uint32_t*>(row + i0);
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (p0 + j < I && row[i0 + j]) m |= 0xffu << (8 * j);
  }
  return m;
}

// A query's vector from its shared row (kPad floats, 16-byte aligned).
template <int KCAP>
__device__ __forceinline__ void load_query(const float* row,
                                           float (&uq)[KCAP]) {
#pragma unroll
  for (int k = 0; k < KCAP; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + k);
    uq[k] = v.x;
    if (k + 1 < KCAP) uq[k + 1] = v.y;
    if (k + 2 < KCAP) uq[k + 2] = v.z;
    if (k + 3 < KCAP) uq[k + 3] = v.w;
  }
}

// A score: one FMA chain over k ascending from 0.
template <int KCAP>
__device__ __forceinline__ float score(const float (&uq)[KCAP],
                                       const float (&it)[KCAP], int K) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < KCAP; ++k) {
    if (k < K) acc = fmaf(uq[k], it[k], acc);
  }
  return acc;
}

// Offers the thread's kItems entries to the warp's list, first voting
// whether any lane holds one that beats its last entry.
__device__ __forceinline__ void offer_items(float& lsc, int& lid,
                                            const float (&s)[kItems],
                                            const int (&id)[kItems], int N,
                                            int lane) {
  const float last_sc = __shfl_sync(kFull, lsc, N - 1);
  const int last_id = __shfl_sync(kFull, lid, N - 1);
  bool hit = false;
#pragma unroll
  for (int j = 0; j < kItems; ++j) hit |= better(s[j], id[j], last_sc, last_id);
  if (!__any_sync(kFull, hit)) return;
#pragma unroll
  for (int j = 0; j < kItems; ++j) offer(lsc, lid, s[j], id[j], N, lane);
}

// A score below which no item of the pass can make a top-N: the N-th
// largest of the 32 lanes' best scores (at least N items score at least
// that much), or -inf where fewer than N lanes hold a finite score.
__device__ __forceinline__ float pass_floor(float best, int N) {
  int key = __float_as_int(best);  // order-preserving for the int compare
  key = key < 0 ? key ^ 0x7fffffff : key;
  int taken = 0;
  for (int r = 0; r < N; ++r) {
    const int top = __reduce_max_sync(kFull, key);
    taken += __popc(__ballot_sync(kFull, key == top));
    if (taken >= N) {
      const int bits = top < 0 ? top ^ 0x7fffffff : top;
      return __int_as_float(bits);
    }
    if (key == top) key = INT_MIN;
  }
  return -INFINITY;
}

// Warp q's pass over its query's kSpan scores of the pass (sc, -inf where
// not a finite candidate; ids the pass's item ids): each lane first marks
// which of its 32 entries (items 32 j + lane) beat the list's last entry
// (and, while the list still fills, are no lower than the pass's floor),
// reading an id only where the score ties, then the rounds with a mark
// are offered in order.
__device__ __forceinline__ void take_scores(float& lsc, int& lid,
                                            const float* sc, const int* ids,
                                            int N, int lane) {
  const float last_sc = __shfl_sync(kFull, lsc, N - 1);
  const int last_id = __shfl_sync(kFull, lid, N - 1);
  // While the list still fills (its last entry is -inf, in whichever
  // pass), only scores no lower than the pass's floor can make it.
  float floor = -INFINITY;
  if (last_sc == -INFINITY) {
    float best = -INFINITY;
#pragma unroll 8
    for (int j = 0; j < kSpan / 32; ++j) best = fmaxf(best, sc[32 * j + lane]);
    if (!__any_sync(kFull, best > -INFINITY)) return;  // no candidate yet
    floor = pass_floor(best, N);
  }
  unsigned marks = 0;
#pragma unroll 8
  for (int j = 0; j < kSpan / 32; ++j) {
    const float s = sc[32 * j + lane];
    if (s >= floor && (s > last_sc || (s == last_sc && s > -INFINITY &&
                                       ids[32 * j + lane] < last_id)))
      marks |= 1u << j;
  }
  for (unsigned m = __reduce_or_sync(kFull, marks); m; m &= m - 1) {
    const int j = __ffs(m) - 1;
    const bool mine = (marks >> j) & 1u;
    offer(lsc, lid, mine ? sc[32 * j + lane] : -INFINITY,
          mine ? ids[32 * j + lane] : INT_MAX, N, lane);
  }
}

template <int KCAP>
__global__ void __launch_bounds__(kThreads) fused_topn_kernel(
    const float* __restrict__ u, const float* __restrict__ items,
    const uint8_t* __restrict__ mask, const int* __restrict__ ids,
    int* __restrict__ out_ids, float* __restrict__ out_sc, int B, int I, int K,
    int N) {
  constexpr int kPad = (KCAP + 3) / 4 * 4;
  extern __shared__ __align__(16) float smem[];  // see smem_bytes
  __shared__ __align__(16) float u_s[kGroup][kPad];  // queries, 0 past K
  __shared__ float psc[kWarps][kMaxN];  // warp lists to merge
  __shared__ int pid[kWarps][kMaxN];
  __shared__ float msc[kGroup + 1][kMaxN];
  __shared__ int mid[kGroup + 1][kMaxN];
  __shared__ int src_of[kGroup];   // the list each query takes
  __shared__ unsigned exact_rows;  // queries that take the exact pass
  const int64_t w = blockIdx.y;
  // Query qb is row b0 + qb * stride; warp qb keeps its list.
  const int b0 = blockIdx.x, stride = gridDim.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  items += w * I * K;
  ids += w * I;
  const uint8_t* rows = mask + (w * B + b0) * (int64_t)I;  // query 0's row
  const int64_t row_step = (int64_t)stride * I;
  const int n_rows = (B - b0 + stride - 1) / stride;  // queries with a row
  float* scores = smem + vec_words(K);        // [kGroup][kSpan]
  int* pass_ids = reinterpret_cast<int*>(scores + kGroup * kSpan);
  const Stage st{smem, pass_ids + kSpan,
                 reinterpret_cast<uint8_t*>(pass_ids + 2 * kSpan)};
  // Sources that start 16-byte aligned come by cp.async.
  const bool async_vec = (reinterpret_cast<uintptr_t>(items) & 15) == 0;
  const bool async_ids = (reinterpret_cast<uintptr_t>(ids) & 15) == 0;
  const bool async_mask =
      I % 16 == 0 && (reinterpret_cast<uintptr_t>(mask) & 15) == 0;

  for (int t = tid; t < kGroup * kPad; t += kThreads) {
    const int qb = t / kPad, k = t % kPad;
    const int64_t b = b0 + (int64_t)qb * stride;
    u_s[qb][k] = b < B && k < K ? u[(w * B + b) * K + k] : 0.f;
  }

  float lsc = -INFINITY, e_sc = -INFINITY;  // warp's query list, -inf list
  int lid = INT_MAX, e_id = INT_MAX;
  stage_pass<KCAP>(st, items, ids, rows, row_step, n_rows, 0, I, K, async_vec,
                   async_ids, async_mask);
  for (int base = 0; base < I; base += kSpan) {
    const int i0 = tid * kItems, p0 = base + i0;
    float it[kItems][KCAP];
    int id[kItems];
    uint32_t mw[kGroup];
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // the pass at `base` is staged; the last scores taken
    read_items<KCAP>(st.vec + tid * (kItems * K + 4), p0, I, K, it);
    if (p0 + kItems <= I) {
      const int4 v = reinterpret_cast<const int4*>(st.ids)[tid];
      id[0] = v.x;
      id[1] = v.y;
      id[2] = v.z;
      id[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        id[j] = p0 + j < I ? st.ids[i0 + j] : INT_MAX;
    }
#pragma unroll
    for (int qb = 0; qb < kGroup; ++qb)
      mw[qb] = qb < n_rows ? mask_word(st.mask + qb * kSpan, i0, p0, I) : 0u;
    {  // rows without a candidate: every item at -inf
      float s[kItems];
#pragma unroll
      for (int j = 0; j < kItems; ++j) s[j] = -INFINITY;
      offer_items(e_sc, e_id, s, id, N, lane);
    }
#pragma unroll
    for (int qb = 0; qb < kGroup; ++qb) {
      float s[kItems];  // finite candidates' scores, -inf elsewhere
#pragma unroll
      for (int j = 0; j < kItems; ++j) s[j] = -INFINITY;
      if (__any_sync(kFull, mw[qb] != 0)) {  // the 4 chains side by side
        float uq[KCAP];
        load_query<KCAP>(u_s[qb], uq);
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          const float v = score<KCAP>(uq, it[j], K);
          if (((mw[qb] >> (8 * j)) & 0xffu) && v > -INFINITY) s[j] = v;
        }
      }
      reinterpret_cast<float4*>(scores + qb * kSpan)[tid] =
          make_float4(s[0], s[1], s[2], s[3]);
    }
    reinterpret_cast<int4*>(pass_ids)[tid] = make_int4(id[0], id[1], id[2],
                                                       id[3]);
    __syncthreads();  // the pass's scores are in, its stage read
    if (base + kSpan < I)  // the next pass comes in meanwhile
      stage_pass<KCAP>(st, items, ids, rows, row_step, n_rows, base + kSpan, I,
                       K, async_vec, async_ids, async_mask);
    if (warp < n_rows)
      take_scores(lsc, lid, scores + warp * kSpan, pass_ids, N, lane);
  }

  if (lane < N) {
    psc[warp][lane] = e_sc;
    pid[warp][lane] = e_id;
    msc[warp][lane] = lsc;
    mid[warp][lane] = lid;
  }
  __syncthreads();
  if (warp == 0)
    merge_lists<kWarps>(&psc[0][0], &pid[0][0], kMaxN, N, lane, msc[kEmpty],
                        mid[kEmpty]);
  __syncthreads();

  // Each query's list: its own (N finite entries), the shared one (none),
  // or an exact pass (1 to N - 1).
  if (warp == 0) {
    const bool real = lane < n_rows;
    int c = 0;
    if (real) {
      for (int r = 0; r < N; ++r) c += msc[lane][r] > -INFINITY;
      src_of[lane] = c == 0 ? kEmpty : lane;
    }
    const unsigned m = __ballot_sync(kFull, real && c > 0 && c < N);
    if (lane == 0) exact_rows = m;
  }
  __syncthreads();
  for (unsigned m = exact_rows; m; m &= m - 1) {
    const int qb = __ffs(m) - 1;
    const uint8_t* row = rows + qb * row_step;
    float uq[KCAP];
#pragma unroll
    for (int k = 0; k < KCAP; ++k) uq[k] = u_s[qb][k];
    float l_sc = -INFINITY;
    int l_id = INT_MAX;
    for (int base = warp * 32; base < I; base += kThreads) {
      const int p = base + lane;
      float s = -INFINITY;
      int id = INT_MAX;
      if (p < I) {
        id = ids[p];
        if (row[p]) {
          float it[KCAP];
#pragma unroll
          for (int k = 0; k < KCAP; ++k)
            it[k] = k < K ? items[(int64_t)p * K + k] : 0.f;
          s = score<KCAP>(uq, it, K);
        }
      }
      offer(l_sc, l_id, s, id, N, lane);
    }
    if (lane < N) {
      psc[warp][lane] = l_sc;
      pid[warp][lane] = l_id;
    }
    __syncthreads();
    if (warp == 0)
      merge_lists<kWarps>(&psc[0][0], &pid[0][0], kMaxN, N, lane, msc[qb],
                          mid[qb]);
    __syncthreads();
  }

  for (int t = tid; t < kGroup * N; t += kThreads) {
    const int qb = t / N, r = t % N;
    const int64_t b = b0 + (int64_t)qb * stride;
    if (b >= B) continue;
    const int x = src_of[qb];
    out_ids[(w * B + b) * N + r] = mid[x][r];
    out_sc[(w * B + b) * N + r] = msc[x][r];
  }
}


template <int KCAP>
int launch(const void* u, const void* items, const void* mask,
           const void* ids, void* out_ids, void* out_sc, int W, int B, int I,
           int K, int N, cudaStream_t stream) {
  // The staged pass and the score tile pass 48 KB at every k: the
  // instance may take what its largest k needs.
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err = allow_dynamic_smem(fused_topn_kernel<KCAP>,
                                             smem_bytes(KCAP), smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + kGroup - 1) / kGroup, W);
  fused_topn_kernel<KCAP><<<grid, kThreads, smem_bytes(K), stream>>>(
      (const float*)u, (const float*)items, (const uint8_t*)mask,
      (const int*)ids, (int*)out_ids, (float*)out_sc, B, I, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_topn_launch(const void* u, const void* items,
                                 const void* mask, const void* ids,
                                 void* out_ids, void* out_sc, int W, int B,
                                 int I, int K, int N, void* stream) {
  if (W == 0 || B == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
#define FUSED_TOPN_LAUNCH(KCAP)                                             \
  if (K <= KCAP)                                                            \
    return launch<KCAP>(u, items, mask, ids, out_ids, out_sc, W, B, I, K, N, \
                        s);
  FUSED_TOPN_LAUNCH(4)
  FUSED_TOPN_LAUNCH(8)
  FUSED_TOPN_LAUNCH(10)
  FUSED_TOPN_LAUNCH(16)
  FUSED_TOPN_LAUNCH(32)
#undef FUSED_TOPN_LAUNCH
  return (int)cudaErrorInvalidValue;
}
