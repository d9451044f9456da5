// masked_scores: batched masked recommendation scoring.
//
// Replaces the Pallas TPU kernel src/repro/kernels/scoring.py::
// masked_scores_kernel (wrapper masked_scores_pallas, pl.pallas_call at
// :57). Plain version: src/repro_torch/kernels/ref.py::masked_scores.
//
// out[w, b, i] = sum_k u[w, b, k] * items[w, i, k] in f32, or -inf where
// mask[w, b, i] == 0, for every worker w in one launch.
//
// What bounds it: bytes. At k = 10 it does 20 flops per output element
// against 5 bytes moved (1 mask byte in, 4 score bytes out), far below
// the card's f32 ridge, so it is a streaming pass over the mask and the
// output. The TPU kernel ran the product on the MXU; here it is an f32
// FMA loop over k (no TF32, no tensor cores at k = 10).
//
// Design: one CTA per (worker, 32-row tile, 128-item tile). The CTA
// stages its 32 query vectors and 128 item vectors in shared memory
// (item rows padded to kMaxK + 1 floats, so lanes on neighbouring items
// hit different banks); each warp then walks rows, its 32 lanes on 32
// neighbouring items, so mask reads and score writes are coalesced.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;
constexpr int kItems = 128;
constexpr int kMaxK = 32;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) masked_scores_kernel(
    const float* __restrict__ u, const float* __restrict__ items,
    const uint8_t* __restrict__ mask, float* __restrict__ out, int B, int I,
    int K) {
  __shared__ float u_s[kRows][kMaxK + 1];
  __shared__ float it_s[kItems][kMaxK + 1];
  const int64_t w = blockIdx.z;
  const int b0 = blockIdx.y * kRows;
  const int i0 = blockIdx.x * kItems;
  const int tid = threadIdx.x;
  u += w * B * K;
  items += w * I * K;
  mask += w * (int64_t)B * I;
  out += w * (int64_t)B * I;

  for (int x = tid; x < kRows * K; x += kThreads) {
    const int r = x / K, c = x % K;
    u_s[r][c] = b0 + r < B ? u[(int64_t)b0 * K + x] : 0.f;
  }
  for (int x = tid; x < kItems * K; x += kThreads) {
    const int r = x / K, c = x % K;
    it_s[r][c] = i0 + r < I ? items[(int64_t)i0 * K + x] : 0.f;
  }
  __syncthreads();

  const int lane = tid & 31;
  for (int r = tid >> 5; r < kRows && b0 + r < B; r += kThreads / 32) {
    const int64_t base = (int64_t)(b0 + r) * I;
    for (int c = lane; c < kItems && i0 + c < I; c += 32) {
      float acc = 0.f;
      for (int k = 0; k < K; ++k) acc = fmaf(u_s[r][k], it_s[c][k], acc);
      out[base + i0 + c] = mask[base + i0 + c] ? acc : -INFINITY;
    }
  }
}

}  // namespace

extern "C" int masked_scores_launch(const void* u, const void* items,
                                    const void* mask, void* out, int W, int B,
                                    int I, int K, void* stream) {
  if (W == 0 || B == 0 || I == 0) return 0;
  dim3 grid((I + kItems - 1) / kItems, (B + kRows - 1) / kRows, W);
  masked_scores_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)items, (const uint8_t*)mask,
      (float*)out, B, I, K);
  return (int)cudaGetLastError();
}
