// The SGD steps of the factor-model kernels. isgd_step is shared by
// factor_update.cu (its ISGD mode) and isgd_update.cu, so both apply paper
// Eqs. 3/4 with the same arithmetic: err = 1 - u.i, then the rank-1 update
// of u and i. bpr_step is factor_update.cu's pairwise (BPR) step. A warp
// holds one k-wide vector per operand, one feature per lane (lanes at or
// beyond k hold 0); each dot product is a shuffle reduction.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Every lane of the warp must call it.
__device__ __forceinline__ void isgd_step(float u, float it, float eta,
                                          float lam, float& u_new,
                                          float& i_new) {
  const float err = 1.f - warp_sum(u * it);
  u_new = u + eta * (err * it - lam * u);
  i_new = it + eta * (err * u - lam * it);
}

// The BPR step on (u, i, j): s = sigmoid(-(u.i - u.j)), then the three
// updates, in the arithmetic of the sequential pairwise body it replaced.
// Every lane of the warp must call it.
__device__ __forceinline__ void bpr_step(float u, float it, float j,
                                         float eta, float lam, float& u_new,
                                         float& i_new, float& j_new) {
  const float x = warp_sum(u * it) - warp_sum(u * j);
  const float s = 1.f / (1.f + expf(x));
  u_new = u + eta * (s * (it - j) - lam * u);
  i_new = it + eta * (s * u - lam * it);
  j_new = j + eta * (-s * u - lam * j);
}

}  // namespace
