// swa_attention: causal sliding-window flash attention with GQA.
//
// Replaces the Pallas TPU kernel src/repro/kernels/swa_attention.py::
// _swa_kernel (wrapper swa_attention_pallas, pl.pallas_call at :131). Plain
// version: src/repro_torch/kernels/ref.py::swa_attention.
//
// out[b, h, r] = sum_c softmax_c(q[b, h, r] . k[b, h / g, c] / sqrt(D))
// v[b, h / g, c] over the keys c visible from row r: c < S, c <= r when
// causal, c > r - window when windowed. A row with no visible key gives 0.
//
// What bounds it: at the serving shape (B 4, Hq 32, Hkv 8, S 8192, D 80,
// window 4096, bf16) operations: 1.03 TFLOP inside the window against
// 419 MB read or written once, ~2,500 flops a byte, far above the ~295 at
// which the H100's bf16 tensor cores outrun its memory.
//
// Design (simple and right first; speed is later work):
//  * one CTA per (batch * q head, block of 64 q rows), four warps of 16
//    rows; GQA by reading kv head bh / group, so no kv head is copied;
//  * K and V tiles of 64 keys through shared memory, V stored transposed so
//    that each P.V operand is one 32-bit read; pitches padded so that the
//    fragment reads of a warp hit 32 different banks;
//  * bf16: Q.K^T and P.V on the tensor cores (mma.sync m16n8k16, bf16 in,
//    f32 accumulate), Q held in registers as A fragments; the online
//    softmax (m, l, acc) in f32 registers; P rounded to bf16 for P.V, as
//    the TPU kernel rounds it, l summed from the unrounded P;
//  * f32: the same tiles on the FMA units (a warp per q row at a time,
//    lanes over D, one key at a time), for the f32 contract;
//  * only the kv tiles that meet (r - window, r] for some row r of the
//    block are visited (the TPU kernel's block skip: 25.2 M of the 33.6 M
//    causal pairs of a head at S 8192, window 4096); a ragged tail of S is
//    masked here (keys past S load as 0 and are masked, rows past S are
//    not stored), so the caller pads nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;  // a masked logit (the TPU kernel's NEG_INF)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool visible(int r, int c, int S, int window,
                                        int causal) {
  return c < S && (!causal || c <= r) && (window < 0 || c > r - window);
}

// The kv tiles of BK keys that rows [q0, q1] can see: lo..hi (empty when
// hi < lo).
template <int BK>
__device__ __forceinline__ void tile_range(int q0, int q1, int S, int window,
                                           int causal, int& lo, int& hi) {
  const int last = causal ? min(q1, S - 1) : S - 1;
  const int first = window < 0 ? 0 : max(0, q0 - window + 1);
  lo = first / BK;
  hi = last < first ? lo - 1 : last / BK;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 values as one 32-bit register, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layouts of mma.m16n8k16 (PTX ISA), with g = lane / 4 and
// t = lane % 4: A (16 x 16, row major) registers {row g | g+8} x {cols 2t,
// 2t+1 | 2t+8, 2t+9} in the order (g, 2t) (g+8, 2t) (g, 2t+8) (g+8, 2t+8);
// B (16 x 8) registers {k rows 2t, 2t+1 | 2t+8, 2t+9} of column g; C (16 x
// 8) c0 c1 at (g, 2t) (g, 2t+1) and c2 c3 at (g+8, 2t) (g+8, 2t+1).
template <int D>
__global__ void __launch_bounds__(128) swa_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    int S, int group, int window, int causal, float scale) {
  constexpr int BQ = 64, BK = 64;
  constexpr int KSTEPS = D / 16;   // k steps of Q.K^T over D
  constexpr int NT = BK / 8;       // n tiles of the logits over the keys
  constexpr int DT = D / 8;        // n tiles of the output over D
  constexpr int PSTEPS = BK / 16;  // k steps of P.V over the keys
  constexpr int KP = D + 8;        // K row pitch in shared memory
  constexpr int VP = BK + 8;       // V^T row pitch
  constexpr int VEC = D / 8;       // 16-byte vectors in a K or V row
  __shared__ __align__(16) __nv_bfloat16 ks[BK * KP];
  __shared__ __align__(16) __nv_bfloat16 vt[D * VP];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int64_t head = (int64_t)S * D;
  q += bh * head;
  o += bh * head;
  k += (bh / group) * head;
  v += (bh / group) * head;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + 2 * t4;
    qa[kk][0] = r0 < S ? ld32(q + (int64_t)r0 * D + c) : 0u;
    qa[kk][1] = r1 < S ? ld32(q + (int64_t)r1 * D + c) : 0u;
    qa[kk][2] = r0 < S ? ld32(q + (int64_t)r0 * D + c + 8) : 0u;
    qa[kk][3] = r1 < S ? ld32(q + (int64_t)r1 * D + c + 8) : 0u;
  }
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // rows g and g + 8
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  int t_lo, t_hi;
  tile_range<BK>(q0, min(q0 + BQ, S) - 1, S, window, causal, t_lo, t_hi);
  for (int kt = t_lo; kt <= t_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < BK * VEC; idx += 128) {
      const int row = idx / VEC, c8 = (idx % VEC) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + row < S) {
        kv = *reinterpret_cast<const uint4*>(k + (int64_t)(k0 + row) * D + c8);
        vv = *reinterpret_cast<const uint4*>(v + (int64_t)(k0 + row) * D + c8);
      }
      *reinterpret_cast<uint4*>(ks + row * KP + c8) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(c8 + j) * VP + row] = ve[j];
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const __nv_bfloat16* kr = ks + (n * 8 + g) * KP + kk * 16 + 2 * t4;
        mma_bf16(s[n], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? r0 : r1;
        const int c = k0 + n * 8 + 2 * t4 + (e & 1);
        s[n][e] = visible(r, c, S, window, causal) ? s[n][e] * scale : kNeg;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // a row lives in the 4 lanes of a quad
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = __expf(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];  // this lane's share of the row sum
    }
    uint32_t pa[PSTEPS][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        p[e] = s[n][e] > 0.5f * kNeg ? __expf(s[n][e] - m[h]) : 0.f;
        l[h] += p[e];
      }
      // Logit tile n is half (n & 1) of the A fragment of P.V step n / 2.
      pa[n >> 1][2 * (n & 1)] = pack_bf16(p[0], p[1]);      // row g
      pa[n >> 1][2 * (n & 1) + 1] = pack_bf16(p[2], p[3]);  // row g + 8
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
#pragma unroll
      for (int t = 0; t < PSTEPS; ++t) {
        const __nv_bfloat16* vr = vt + (dt * 8 + g) * VP + t * 16 + 2 * t4;
        mma_bf16(acc[dt], pa[t], ld32(vr), ld32(vr + 8));
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
    inv[h] = l[h] > 0.f ? 1.f / l[h] : 0.f;  // no visible key: 0
  }
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * t4;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(o + (int64_t)r0 * D + c) =
          pack_bf16(acc[dt][0] * inv[0], acc[dt][1] * inv[0]);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(o + (int64_t)r1 * D + c) =
          pack_bf16(acc[dt][2] * inv[1], acc[dt][3] * inv[1]);
  }
}

__device__ __forceinline__ float lane_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int D>
__global__ void __launch_bounds__(128) swa_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int S, int group,
    int window, int causal, float scale) {
  constexpr int BQ = 16, BK = 32, RPW = BQ / 4;  // q rows per warp
  constexpr int DJ = (D + 31) / 32;             // features per lane
  __shared__ float ks[BK * D], vs[BK * D];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t head = (int64_t)S * D;
  q += bh * head;
  o += bh * head;
  k += (bh / group) * head;
  v += (bh / group) * head;

  float qr[RPW][DJ], acc[RPW][DJ], m[RPW], l[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = q0 + warp * RPW + i;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = lane + 32 * j;
      qr[i][j] = r < S && d < D ? q[(int64_t)r * D + d] : 0.f;
      acc[i][j] = 0.f;
    }
  }

  int t_lo, t_hi;
  tile_range<BK>(q0, min(q0 + BQ, S) - 1, S, window, causal, t_lo, t_hi);
  for (int kt = t_lo; kt <= t_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    for (int idx = tid; idx < BK * D; idx += 128) {
      const int key = k0 + idx / D;
      const int64_t at = (int64_t)key * D + idx % D;
      ks[idx] = key < S ? k[at] : 0.f;
      vs[idx] = key < S ? v[at] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = q0 + warp * RPW + i;
      if (r >= S) continue;  // uniform over the warp
      for (int c = 0; c < BK; ++c) {
        if (!visible(r, k0 + c, S, window, causal)) continue;
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const int d = lane + 32 * j;
          if (d < D) part = fmaf(qr[i][j], ks[c * D + d], part);
        }
        const float s = lane_sum(part) * scale;
        const float m_new = fmaxf(m[i], s);
        const float alpha = expf(m[i] - m_new), p = expf(s - m_new);
        l[i] = l[i] * alpha + p;
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const int d = lane + 32 * j;
          if (d < D) acc[i][j] = acc[i][j] * alpha + p * vs[c * D + d];
        }
        m[i] = m_new;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = q0 + warp * RPW + i;
    if (r >= S) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = lane + 32 * j;
      if (d < D) o[(int64_t)r * D + d] = acc[i][j] * inv;
    }
  }
}

#define SWA_CASES(KERNEL, T)                                              \
  switch (D) {                                                            \
    case 32: KERNEL<32><<<grid, 128, 0, st>>>(ARGS(T)); break;            \
    case 64: KERNEL<64><<<grid, 128, 0, st>>>(ARGS(T)); break;            \
    case 80: KERNEL<80><<<grid, 128, 0, st>>>(ARGS(T)); break;            \
    case 128: KERNEL<128><<<grid, 128, 0, st>>>(ARGS(T)); break;          \
    default: return (int)cudaErrorInvalidValue;                           \
  }
#define ARGS(T)                                                           \
  (const T*)q, (const T*)k, (const T*)v, (T*)o, S, group, window, causal, \
      scale

}  // namespace

// window < 0: unbounded; bf16 != 0: bf16 tensors, else f32.
extern "C" int swa_attention_launch(const void* q, const void* k,
                                    const void* v, void* o, int B, int Hq,
                                    int Hkv, int S, int D, int window,
                                    int causal, int bf16, void* stream) {
  if (B == 0 || Hq == 0 || S == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)D);
  const int group = Hq / Hkv;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    const dim3 grid(B * Hq, (S + 63) / 64);
    SWA_CASES(swa_bf16_kernel, __nv_bfloat16)
  } else {
    const dim3 grid(B * Hq, (S + 15) / 16);
    SWA_CASES(swa_f32_kernel, float)
  }
  return (int)cudaGetLastError();
}
