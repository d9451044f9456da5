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
// entries are (-inf, INT32_MAX), after every real entry. The [B, I] score
// matrix is never written.
//
// What bounds it: bytes, the mask (1 byte per (row, item)) read once; the
// item table is read once per CTA from L2. The selection work is a
// compare per item plus a rare insertion.
//
// Design: one CTA per (worker, 8-row tile), one warp per query row.
// Item tiles of 128 vectors are staged in shared memory. Each lane scores
// items lane, lane + 32, ... and keeps its own sorted top-N in local
// memory, inserting only what beats its current N-th entry; at the end
// the warp merges its 32 lists with N rounds of a shuffle arg-max over
// (score desc, id asc, lane asc), each round popping the winner's head
// (topn_merge.cuh).
#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topn_merge.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kTile = 128;
constexpr int kMaxK = 32;
constexpr int kMaxN = 32;

__global__ void __launch_bounds__(kWarps * 32) fused_topn_kernel(
    const float* __restrict__ u, const float* __restrict__ items,
    const uint8_t* __restrict__ mask, const int* __restrict__ ids,
    int* __restrict__ out_ids, float* __restrict__ out_sc, int B, int I, int K,
    int N) {
  __shared__ float u_s[kWarps][kMaxK];
  __shared__ float it_s[kTile][kMaxK + 1];
  __shared__ int id_s[kTile];
  const int64_t w = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  const bool row_ok = b < B;
  u += w * B * K;
  items += w * I * K;
  ids += w * I;
  mask += (w * B + b) * (int64_t)I;
  out_ids += (w * B + b) * N;
  out_sc += (w * B + b) * N;

  if (row_ok && lane < K) u_s[warp][lane] = u[(int64_t)b * K + lane];

  float lsc[kMaxN];
  int lid[kMaxN];
  for (int p = 0; p < kMaxN; ++p) {
    lsc[p] = -INFINITY;
    lid[p] = INT_MAX;
  }
  float worst_sc = -INFINITY;
  int worst_id = INT_MAX;

  for (int t0 = 0; t0 < I; t0 += kTile) {
    const int tn = min(kTile, I - t0);
    __syncthreads();
    for (int x = threadIdx.x; x < tn * K; x += kWarps * 32)
      it_s[x / K][x % K] = items[(int64_t)t0 * K + x];
    for (int x = threadIdx.x; x < tn; x += kWarps * 32) id_s[x] = ids[t0 + x];
    __syncthreads();
    if (!row_ok) continue;
    for (int j = lane; j < tn; j += 32) {
      float s = -INFINITY;
      if (mask[t0 + j]) {
        float acc = 0.f;
        for (int k = 0; k < K; ++k) acc = fmaf(u_s[warp][k], it_s[j][k], acc);
        s = acc;
      }
      const int id = id_s[j];
      if (better(s, id, worst_sc, worst_id)) {
        int p = N - 1;
        while (p > 0 && better(s, id, lsc[p - 1], lid[p - 1])) {
          lsc[p] = lsc[p - 1];
          lid[p] = lid[p - 1];
          --p;
        }
        lsc[p] = s;
        lid[p] = id;
        worst_sc = lsc[N - 1];
        worst_id = lid[N - 1];
      }
    }
  }
  if (!row_ok) return;  // after the last barrier; whole warps leave

  warp_merge(lsc, lid, N, N, lane, out_sc, out_ids);
}

}  // namespace

extern "C" int fused_topn_launch(const void* u, const void* items,
                                 const void* mask, const void* ids,
                                 void* out_ids, void* out_sc, int W, int B,
                                 int I, int K, int N, void* stream) {
  if (W == 0 || B == 0) return 0;
  dim3 grid((B + kWarps - 1) / kWarps, W);
  fused_topn_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)items, (const uint8_t*)mask,
      (const int*)ids, (int*)out_ids, (float*)out_sc, B, I, K, N);
  return (int)cudaGetLastError();
}
