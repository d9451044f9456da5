// The running top-N lists of the serving kernels, shared by fused_topn.cu
// and dics_topn.cu so both keep the order that
// src/repro_torch/kernels/ref.py::topn_select defines: score descending,
// then id ascending; unused entries are (-inf, INT_MAX), after every real
// entry. A warp keeps one list with one entry per lane (`offer`); lists
// of several warps are merged through shared memory (`merge_lists`).
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// True when (s, id) comes before (s2, id2).
__device__ __forceinline__ bool better(float s, int id, float s2, int id2) {
  return s > s2 || (s == s2 && id < id2);
}

// Offer each lane's (s, id) to the warp's running top-N (lane j holds
// entry j of N, sorted by better()): the offers that beat the last entry
// go in lane order, each re-checked against the new last entry. Every
// lane of the warp must call it.
__device__ __forceinline__ void offer(float& lsc, int& lid, float s, int id,
                                      int N, int lane) {
  unsigned pend = __ballot_sync(
      kFull, better(s, id, __shfl_sync(kFull, lsc, N - 1),
                    __shfl_sync(kFull, lid, N - 1)));
  while (pend) {
    const int src = __ffs(pend) - 1;
    const float cs = __shfl_sync(kFull, s, src);
    const int cid = __shfl_sync(kFull, id, src);
    const int r = __popc(
        __ballot_sync(kFull, lane < N && !better(cs, cid, lsc, lid)));
    const float up_s = __shfl_up_sync(kFull, lsc, 1);
    const int up_id = __shfl_up_sync(kFull, lid, 1);
    if (r < N && lane == r) {
      lsc = cs;
      lid = cid;
    } else if (r < N && lane > r) {
      lsc = up_s;
      lid = up_id;
    }
    pend &= pend - 1;
    pend &= __ballot_sync(
        kFull, better(s, id, __shfl_sync(kFull, lsc, N - 1),
                      __shfl_sync(kFull, lid, N - 1)));
  }
}

// Merges L sorted lists of N entries (list l at sc / ids + l * stride) by
// N rounds of an L-lane shuffle arg-max over their heads by (score desc,
// id asc, list asc), each round popping the winner's head; lane 0 writes
// the merged list to out_sc / out_id. L is a power of two, at most 32.
// Every lane of the warp must call it.
template <int L>
__device__ __forceinline__ void merge_lists(const float* sc, const int* ids,
                                            int stride, int N, int lane,
                                            float* out_sc, int* out_id) {
  int head = 0;
  for (int r = 0; r < N; ++r) {
    const bool has = lane < L && head < N;
    float s = has ? sc[lane * stride + head] : -INFINITY;
    int id = has ? ids[lane * stride + head] : INT_MAX;
    int src = lane;
    for (int o = L / 2; o > 0; o >>= 1) {
      const float s2 = __shfl_xor_sync(kFull, s, o);
      const int id2 = __shfl_xor_sync(kFull, id, o);
      const int src2 = __shfl_xor_sync(kFull, src, o);
      if (better(s2, id2, s, id) || (s2 == s && id2 == id && src2 < src)) {
        s = s2;
        id = id2;
        src = src2;
      }
    }
    if (lane == src) ++head;
    if (lane == 0) {
      out_sc[r] = s;
      out_id[r] = id;
    }
  }
}

}  // namespace
