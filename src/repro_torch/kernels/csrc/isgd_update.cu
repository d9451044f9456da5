// isgd_update: the factors-only streaming ISGD micro-batch update.
//
// Replaces the Pallas TPU kernel src/repro/kernels/isgd.py::
// isgd_update_kernel (wrapper isgd_update_pallas, pl.pallas_call at :68).
// Plain version: src/repro_torch/kernels/ref.py::isgd_apply.
//
// Per event, in order, where valid[e] != 0: gather user row u_slots[e] and
// item row i_slots[e], err = 1 - u.i, write back u + eta (err i - lam u)
// and i + eta (err u - lam i). An invalid event changes nothing, nor does
// one whose slot lies outside its table (the wrapper's contract, which the
// plain version keeps too). The same slot may appear many times in one
// batch: each event reads the rows the previous one wrote (a chain), so
// the events cannot run in parallel.
//
// What bounds it: latency. Each event is a dependent round trip to global
// memory (slots, then rows, then the reduction, then the writes); the bytes
// moved are 2 * 2 * k * 4 per event plus the event arrays.
//
// Design: the K1 variant the TPU kernel is. One warp runs the events in
// order, lane f holding feature f (k <= 32), the ISGD step is
// csrc/sgd_step.cuh's (the same as factor_update.cu's ISGD mode). Each lane
// reads and writes only its own feature column, so its own program order
// makes every write visible to the next event: no barrier is needed. The
// TPU kernel's VMEM budget (12 MiB) and its 128-lane padding of k do not
// apply: the tables stay in global memory (and L2) at any size, k as given.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sgd_step.cuh"

namespace {

__global__ void __launch_bounds__(32) isgd_update_kernel(
    float* ut, float* it,
    const int* __restrict__ u_slots, const int* __restrict__ i_slots,
    const uint8_t* __restrict__ valid, int U, int I, int K, int E, float eta,
    float lam) {
  const int lane = threadIdx.x;
  const bool in_k = lane < K;
  for (int e = 0; e < E; ++e) {
    const unsigned us = u_slots[e], is = i_slots[e];
    if (!valid[e] || us >= (unsigned)U || is >= (unsigned)I)
      continue;  // uniform over the warp
    float* urow = ut + (int64_t)us * K;
    float* irow = it + (int64_t)is * K;
    const float u = in_k ? urow[lane] : 0.f;
    const float i = in_k ? irow[lane] : 0.f;
    float u_new, i_new;
    isgd_step(u, i, eta, lam, u_new, i_new);
    if (in_k) {
      urow[lane] = u_new;
      irow[lane] = i_new;
    }
  }
}

}  // namespace

extern "C" int isgd_update_launch(void* ut, void* it, const void* u_slots,
                                  const void* i_slots, const void* valid,
                                  int U, int I, int K, int E, float eta,
                                  float lam, void* stream) {
  if (E == 0) return 0;
  isgd_update_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (float*)ut, (float*)it, (const int*)u_slots, (const int*)i_slots,
      (const uint8_t*)valid, U, I, K, E, eta, lam);
  return (int)cudaGetLastError();
}
