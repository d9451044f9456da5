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
// Design: each thread owns kVec = 4 consecutive items and keeps their
// k-vectors in registers (KMAX in {4, 8, 10, 16, 32}, the least >= k); a
// CTA owns a strip of kThreads * kVec items and walks kRowsPerCta rows of
// one worker. It copies the strip's item vectors (contiguous in items)
// into shared memory with coalesced float4 loads, each thread's 4K floats
// one float apart from the next thread's so its reads hit distinct banks,
// and stages the rows' query vectors, read as broadcasts. Per row a
// thread reads its 4 mask bytes as one 4-byte load and writes its 4
// scores as one float4 streaming store, with the mask words of kBatch
// rows loaded ahead of their stores. Rows whose
// mask or scores are not aligned for that (I not a multiple of 4, a mask
// view at an odd address) and the strip's last partial group of items
// take a scalar path in the same kernel.
//
// Each score is the FMA chain acc = fmaf(u[k], it[k], acc) over k
// ascending from 0.f, the same as PR 11's kernel, so every score is
// bit-identical to it and the DISGD hit test's rank count of tied scores
// (core/disgd.py) cannot move.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "smem_limit.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                   // consecutive items per thread
constexpr int kStrip = kThreads * kVec;   // items per CTA
constexpr int kRowsPerCta = 16;
constexpr int kBatch = 8;                 // rows whose mask words load ahead

template <int KMAX>
__global__ void __launch_bounds__(kThreads) masked_scores_kernel(
    const float* __restrict__ u, const float* __restrict__ items,
    const uint8_t* __restrict__ mask, float* __restrict__ out, int B, int I,
    int K, int aligned) {
  extern __shared__ float it_s[];  // thread t's 4K floats at t * (4K + 1)
  __shared__ float u_s[kRowsPerCta][KMAX];
  const int64_t w = blockIdx.z;
  const int b0 = blockIdx.y * kRowsPerCta;
  const int s0 = blockIdx.x * kStrip;
  const int i0 = s0 + threadIdx.x * kVec;
  const int rows = min(kRowsPerCta, B - b0);
  u += (w * B + b0) * (int64_t)K;
  items += (w * I + s0) * (int64_t)K;
  mask += (w * B + b0) * (int64_t)I;
  out += (w * B + b0) * (int64_t)I;

  for (int x = threadIdx.x; x < kRowsPerCta * KMAX; x += kThreads) {
    const int r = x / KMAX, k = x % KMAX;
    u_s[r][k] = r < rows && k < K ? u[r * K + k] : 0.f;
  }
  // Element e of the strip belongs to thread e / 4K and goes to e + e / 4K;
  // a float4 never straddles two threads' blocks (4K is a multiple of 4).
  const int n = min(kStrip, I - s0) * K;
  const int n4 = (uintptr_t)items % 16 == 0 ? n / 4 : 0;
  for (int x = threadIdx.x; x < n4; x += kThreads) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(items) + x);
    const int d = 4 * x + 4 * x / (kVec * K);
    it_s[d] = v.x;
    it_s[d + 1] = v.y;
    it_s[d + 2] = v.z;
    it_s[d + 3] = v.w;
  }
  for (int e = 4 * n4 + threadIdx.x; e < n; e += kThreads) {
    it_s[e + e / (kVec * K)] = __ldg(items + e);
  }
  __syncthreads();
  if (i0 >= I) return;
  float it[kVec][KMAX];
  const float* mine = it_s + threadIdx.x * (kVec * K + 1);
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      it[v][k] = k < K && i0 + v < I ? mine[v * K + k] : 0.f;
    }
  }
  const bool vec = aligned && i0 + kVec <= I;

  for (int r0 = 0; r0 < rows; r0 += kBatch) {
    uint32_t m[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      m[j] = vec && r0 + j < rows
                 ? __ldcs(reinterpret_cast<const unsigned int*>(
                       mask + (int64_t)(r0 + j) * I + i0))
                 : 0u;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int r = r0 + j;
      if (r >= rows) break;
      float acc[kVec];
#pragma unroll
      for (int v = 0; v < kVec; ++v) acc[v] = 0.f;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k < K) {
          const float uk = u_s[r][k];
#pragma unroll
          for (int v = 0; v < kVec; ++v) acc[v] = fmaf(uk, it[v][k], acc[v]);
        }
      }
      const int64_t row = (int64_t)r * I + i0;
      if (vec) {
        float4 o;
        o.x = m[j] & 0xffu ? acc[0] : -INFINITY;
        o.y = m[j] & 0xff00u ? acc[1] : -INFINITY;
        o.z = m[j] & 0xff0000u ? acc[2] : -INFINITY;
        o.w = m[j] & 0xff000000u ? acc[3] : -INFINITY;
        __stcs(reinterpret_cast<float4*>(out + row), o);
      } else {
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          if (i0 + v < I) out[row + v] = mask[row + v] ? acc[v] : -INFINITY;
        }
      }
    }
  }
}

template <int KMAX>
int launch(const void* u, const void* items, const void* mask, void* out,
           int W, int B, int I, int K, cudaStream_t stream) {
  const int aligned = I % kVec == 0 && (uintptr_t)mask % kVec == 0 &&
                      (uintptr_t)out % 16 == 0;
  const size_t smem = (size_t)(kStrip * K + kThreads) * sizeof(float);
  // With the static query rows, past 48 KB from k = 12 on: the instance
  // may take what its largest k needs.
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err = allow_dynamic_smem(
      masked_scores_kernel<KMAX>,
      (int)((kStrip * KMAX + kThreads) * sizeof(float)), smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((I + kStrip - 1) / kStrip, (B + kRowsPerCta - 1) / kRowsPerCta,
            W);
  masked_scores_kernel<KMAX><<<grid, kThreads, smem, stream>>>(
      (const float*)u, (const float*)items, (const uint8_t*)mask,
      (float*)out, B, I, K, aligned);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int masked_scores_launch(const void* u, const void* items,
                                    const void* mask, void* out, int W, int B,
                                    int I, int K, void* stream) {
  if (W == 0 || B == 0 || I == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (K <= 4) return launch<4>(u, items, mask, out, W, B, I, K, s);
  if (K <= 8) return launch<8>(u, items, mask, out, W, B, I, K, s);
  if (K <= 10) return launch<10>(u, items, mask, out, W, B, I, K, s);
  if (K <= 16) return launch<16>(u, items, mask, out, W, B, I, K, s);
  return launch<32>(u, items, mask, out, W, B, I, K, s);
}
