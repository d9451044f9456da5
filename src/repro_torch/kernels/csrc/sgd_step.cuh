// The ISGD step of the factor-model kernels, shared by factor_update.cu
// (its ISGD mode) and isgd_update.cu, so both apply paper Eqs. 3/4 with
// the same arithmetic: err = 1 - u.i, then the rank-1 update of u and i.
// A warp holds one k-wide vector pair, one feature per lane (lanes at or
// beyond k hold 0); the dot product is a shuffle reduction.
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

}  // namespace
