// The total order of the serving kernels' top-N lists, shared by
// fused_topn.cu and dics_topn.cu so both keep the order that
// src/repro_torch/kernels/ref.py::topn_select defines: score descending,
// then id ascending; unused entries are (-inf, INT_MAX), after every real
// entry. And fused_topn.cu's warp merge of per-lane lists.
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

// True when (s, id) comes before (s2, id2).
__device__ __forceinline__ bool better(float s, int id, float s2, int id2) {
  return s > s2 || (s == s2 && id < id2);
}

// N rounds of a warp arg-max over the heads of per-lane sorted lists
// (sc, ids, length len) by (score desc, id asc, lane asc); each round pops
// the winner's head. Lane 0 writes the merged list to out_sc / out_id.
// Every lane of the warp must call it.
__device__ __forceinline__ void warp_merge(const float* sc, const int* ids,
                                           int len, int N, int lane,
                                           float* out_sc, int* out_id) {
  constexpr unsigned kFull = 0xffffffffu;
  int head = 0;
  for (int r = 0; r < N; ++r) {
    float s = head < len ? sc[head] : -INFINITY;
    int id = head < len ? ids[head] : INT_MAX;
    int src = lane;
    for (int o = 16; o > 0; o >>= 1) {
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
