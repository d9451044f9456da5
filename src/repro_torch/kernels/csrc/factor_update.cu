// factor_update: the complete streaming factor-model micro-batch update.
//
// Replaces the Pallas TPU kernel src/repro/kernels/factor_update.py::
// factor_update_kernel (wrapper factor_update_pallas, pl.pallas_call at
// :166). Plain version: src/repro_torch/kernels/ref.py::factor_apply.
//
// Per event, in order, on one worker: gather-or-init the user and item
// vectors, apply the ISGD step (err = 1 - u.i) or, with `pairwise`, the
// BPR step whose negative slot is checked against the live tables
// (neg_ok), clear the evicted item's column of `rated`, clear the user's
// row if the user is new, set rated[u, i], and update freq/id/ts/clock.
// Padding events (u_id < 0) touch nothing.
//
// What bounds it: latency. Events of one worker are a dependent chain
// (the same slot can be hit twice in one bucket), so the kernel is a
// sequence of short global-memory round trips; the bytes moved are a few
// hundred per event except for the column clear, which is a strided
// write of u_cap bytes.
//
// Design: workers are independent, so one launch runs one CTA per worker
// and keeps the events sequential inside the CTA. The k-wide vectors and
// the dot products live in warp 0 (one lane per feature, shuffle reduce);
// the column clear and the row clear are spread over the whole block.
// __syncthreads() separates the column clear, the row clear and the
// writes, and ends every event, so each write is visible to the next
// event; nothing is cached in registers across events.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads) factor_update_kernel(
    float* uv, float* iv, uint8_t* rated, int* uid, int* iid, int* ufq,
    int* ifq, int* uts, int* its, int* clk, const int* ev_u, const int* ev_i,
    const int* u_slots, const int* i_slots, const int* j_slots,
    const float* init_u, const float* init_i, int U, int I, int K, int E,
    float eta, float lam, int pairwise) {
  const int64_t w = blockIdx.x;
  const int tid = threadIdx.x;
  uv += w * U * K;
  iv += w * I * K;
  rated += w * (int64_t)U * I;
  uid += w * U;
  ufq += w * U;
  uts += w * U;
  iid += w * I;
  ifq += w * I;
  its += w * I;
  clk += w;
  ev_u += w * E;
  ev_i += w * E;
  u_slots += w * E;
  i_slots += w * E;
  j_slots += w * E;
  init_u += w * E * K;
  init_i += w * E * K;

  for (int e = 0; e < E; ++e) {
    const int u_id = ev_u[e];
    if (u_id < 0) continue;  // uniform over the block: no barrier skipped
    const int i_id = ev_i[e];
    const int us = u_slots[e];
    const int is = i_slots[e];
    // Both reads precede this event's writes (first barrier below).
    const bool new_u = uid[us] != u_id;
    const bool new_i = iid[is] != i_id;
    uint8_t* row = rated + (int64_t)us * I;

    if (new_i) {
      for (int r = tid; r < U; r += kThreads) rated[(int64_t)r * I + is] = 0;
    }
    __syncthreads();
    if (new_u) {
      for (int c = tid; c < I; c += kThreads) row[c] = 0;
    }
    __syncthreads();

    if (tid < 32) {
      const bool in_k = tid < K;
      float u = 0.f, it = 0.f;
      if (in_k) {
        u = new_u ? init_u[e * K + tid] : uv[us * K + tid];
        it = new_i ? init_i[e * K + tid] : iv[is * K + tid];
      }
      float u_new, i_new;
      if (pairwise) {
        const int js = j_slots[e];
        const int neg_id = iid[js];
        const bool neg_ok =
            neg_id >= 0 && neg_id != i_id && js != is && row[js] == 0;
        const float j = in_k ? iv[js * K + tid] : 0.f;
        const float x = warp_sum(u * it) - warp_sum(u * j);
        const float s = 1.f / (1.f + expf(x));
        if (neg_ok) {
          u_new = u + eta * (s * (it - j) - lam * u);
          i_new = it + eta * (s * u - lam * it);
          // j before i (never the same slot when neg_ok holds).
          if (in_k) iv[js * K + tid] = j + eta * (-s * u - lam * j);
        } else {
          u_new = u;
          i_new = it;
        }
      } else {
        const float err = 1.f - warp_sum(u * it);
        u_new = u + eta * (err * it - lam * u);
        i_new = it + eta * (err * u - lam * it);
      }
      if (in_k) {
        uv[us * K + tid] = u_new;
        iv[is * K + tid] = i_new;
      }
      if (tid == 0) {
        row[is] = 1;
        ufq[us] = new_u ? 1 : ufq[us] + 1;
        ifq[is] = new_i ? 1 : ifq[is] + 1;
        uid[us] = u_id;
        iid[is] = i_id;
        const int c = clk[0] + 1;
        uts[us] = c;
        its[is] = c;
        clk[0] = c;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int factor_update_launch(
    void* uv, void* iv, void* rated, void* uid, void* iid, void* ufq,
    void* ifq, void* uts, void* its, void* clk, const void* ev_u,
    const void* ev_i, const void* u_slots, const void* i_slots,
    const void* j_slots, const void* init_u, const void* init_i, int W, int U,
    int I, int K, int E, float eta, float lam, int pairwise, void* stream) {
  if (W == 0 || E == 0) return 0;
  factor_update_kernel<<<W, kThreads, 0, (cudaStream_t)stream>>>(
      (float*)uv, (float*)iv, (uint8_t*)rated, (int*)uid, (int*)iid,
      (int*)ufq, (int*)ifq, (int*)uts, (int*)its, (int*)clk,
      (const int*)ev_u, (const int*)ev_i, (const int*)u_slots,
      (const int*)i_slots, (const int*)j_slots, (const float*)init_u,
      (const float*)init_i, U, I, K, E, eta, lam, pairwise);
  return (int)cudaGetLastError();
}
