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
// which the H100's bf16 tensor cores outrun its memory. On the card the
// softmax competes with the products: a 128 x 128 tile is 5.2 MFLOP of
// wgmma (~1,300 SM clocks at peak) and 16,384 exp2 on 16 special-function
// lanes an SM (~1,000 clocks). So the design keeps loads off the critical
// path, overlaps one warpgroup's softmax with the other's products, and
// does the per-logit mask only where it must.
//
// bf16 design (Hopper, sm_90a), one CTA per (batch * q head, block of 128
// q rows), 384 threads:
//  * a producer warp (warpgroup 2, setmaxnreg down to 24) loads Q once
//    and the block's K and V tiles of 128 keys by TMA into a ring of
//    kStages stages, each with a K-full, a V-full and an empty mbarrier.
//    The tensor maps are 3-D (D, S, heads), so a tile never crosses into
//    the next head: rows past S arrive as zeros. GQA: the kv head is
//    bh / group on the third coordinate; nothing is copied;
//  * two consumer warpgroups (setmaxnreg up to 240) own 64 q rows each.
//    S = Q.K^T is a wgmma with both operands in shared memory (K-major)
//    and f32 accumulators; the online softmax (m, l, acc) stays in f32
//    registers, exponentials on ex2.approx; P, rounded to bf16 as the TPU
//    kernel rounds it (l summed from the unrounded P), goes back into
//    wgmma as the A operand straight from the S accumulator's registers,
//    and O += P.V reads V as an MN-major B operand from its TMA tile: no
//    transpose. ptxas still allocates the consumers within the 168
//    registers the launch bound gives every thread, so the loop keeps one
//    S tile live: it issues P.V of tile i and S of tile i + 1 together,
//    waits for both, then runs the softmax of tile i + 1;
//  * ping-pong: the two consumer warpgroups take turns (named barriers 1
//    and 2) to issue their wgmma, so one's softmax runs while the other's
//    products do;
//  * a row of D bf16 is cut into panels that TMA swizzles and wgmma reads:
//    64 columns with the 128-byte swizzle, and the rest (D = 80: 16
//    columns, 32-byte swizzle; D = 96: 32 columns, 64-byte swizzle;
//    D = 128: another 64) in a second tensor map. Q.K^T takes its D / 16
//    k-steps across the panels, P.V is one wgmma per panel (D = 80: n64 +
//    n16; D = 96: n64 + n32). Zero-filling a second 64-wide panel instead
//    would spend 48 (D = 80) or 32 (D = 96) dead columns of shared memory
//    per row and leave a stage 60% or 33% larger. D = 96 and 128 keep 2
//    stages (24 or 32 KB of Q and 48 or 64 KB a stage: ~120 or ~160 KB of
//    shared memory), the narrower widths 4;
//  * tile classes: of the kv tiles a q block visits (those that hold a key
//    some row of the block can see), a tile whose every (row, key) pair is
//    visible is full and runs no mask; the rest are boundary tiles and run
//    the per-logit window / causal / ragged-tail mask and the "no visible
//    key" guard (m = -1e30, p = 0). At the serving shape that is 31 full
//    and 2 boundary tiles of 33 per interior q block.
//    ref.swa_tile_classes mirrors the rule for the CPU tests;
//  * f32: tiles of 16 q rows and 32 keys on the FMA units (a warp per q
//    row at a time, lanes over D, one key at a time), for the f32
//    contract.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "smem_limit.cuh"

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

// A visited tile [k0, k0 + BK) is full when every row of [q0, q1] sees
// every one of its keys; otherwise it is a boundary tile.
template <int BK>
__device__ __forceinline__ bool tile_full(int q0, int q1, int k0, int S,
                                          int window, int causal) {
  const int k1 = k0 + BK - 1;
  return k1 < S && (!causal || k1 <= q0) && (window < 0 || k0 > q1 - window);
}

// Two bf16 values as one 32-bit register, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// 2^x on the special-function unit (flushes subnormal results to 0; -1e30
// gives 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -- Hopper primitives: mbarriers, TMA, wgmma --------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` of TMA transactions.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Waits until the phase of parity `parity` has completed (the phase just
// before the first one counts as completed). A wait that never ends (a
// transaction count that does not match what TMA delivers) traps after
// 2^26 polls, seconds on the card, so that it fails the launch instead of
// hanging the device.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// A TMA load of the box at (x, y, z) of `map` into shared memory at `dst`,
// completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(x),
      "r"(y), "r"(z)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Named barriers 1 and 2 order the two consumer warpgroups' wgmma issue
// (0 is __syncthreads'): warpgroup w waits at 1 + w for its turn and
// arrives at 1 + (1 - w) to hand the turn over.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets, swizzle (1: 128 B, 2: 64 B, 3: 32 B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t swz) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (swz << 62);
}

// A panel of W bf16 columns as TMA lays it out: rows of 2W bytes, swizzled
// over 2W bytes; wgmma's swizzle code for it.
template <int W>
struct Panel {
  static constexpr uint32_t kRow = 2 * W;
  static constexpr uint64_t kSwizzle = W == 64 ? 1 : W == 32 ? 2 : 3;
  static_assert(W == 64 || W == 32 || W == 16, "panel width");
  // K-major operand (rows = M or N, columns = K): 8-row groups kRow * 8
  // apart; k-step kk of 16 columns starts 32 bytes further on.
  static __device__ __forceinline__ uint64_t k_major(uint32_t base, int kk) {
    return smem_desc(base + 32 * kk, 16, 8 * kRow, kSwizzle);
  }
  // MN-major B operand (rows = K, columns = N, one swizzle atom wide):
  // k-step kk of 16 rows starts 16 rows further on; groups of 8 rows
  // kRow * 8 apart.
  static __device__ __forceinline__ uint64_t mn_major(uint32_t base, int kk) {
    return smem_desc(base + 16 * kRow * kk, 8 * kRow * 16, 8 * kRow,
                     kSwizzle);
  }
};

// wgmma m64nNk16, f32 += bf16 x bf16. _ss: A and B from shared memory,
// both K-major; scale_d == 0 overwrites d. _rs: A from registers (the
// mma.m16n8k16 A fragment of each warp's 16 rows), B MN-major (trans-b).
// Accumulator d[4j + e]: row 16 * warp + lane / 4 + 8 * (e / 2), column
// 8j + 2 * (lane % 4) + e % 2.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d);
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// The bf16 kernel's tiles and shared memory, all regions 1024-byte aligned
// (the 128-byte swizzle's atom): Q (two panels, 128 rows), then kStages
// stages of K and V (two panels each), then the mbarriers.
template <int D>
struct SwaTiles {
  static constexpr int kBQ = 128, kBK = 128, kThreads = 384;
  static constexpr int kW0 = D < 64 ? D : 64, kW1 = D - kW0;
  static constexpr int kStages = D > 80 ? 2 : 4;
  static constexpr uint32_t kQBytes = kBQ * D * 2;
  static constexpr uint32_t kTileBytes = kBK * D * 2;  // one K or V tile
  static constexpr uint32_t kPanel1 = kBK * kW0 * 2;   // panel 1 in a tile
  static constexpr uint32_t kBars = kQBytes + 2 * kStages * kTileBytes;
  // Q full, then K full, V full and empty per stage; 1024 bytes of slack
  // to align the base.
  static constexpr uint32_t kSmem = kBars + 8 * (1 + 3 * kStages) + 1024;
  static_assert(kQBytes % 1024 == 0 && kPanel1 % 1024 == 0, "alignment");
  static_assert(kW1 == 0 || kW1 == 16 || kW1 == 32 || kW1 == 64,
                "head dim");
  static __device__ __forceinline__ uint32_t k_tile(int s) {
    return kQBytes + 2 * s * kTileBytes;
  }
  static __device__ __forceinline__ uint32_t v_tile(int s) {
    return k_tile(s) + kTileBytes;
  }
};

struct SwaBars {
  uint64_t* q;
  uint64_t* k;      // [kStages]
  uint64_t* v;      // [kStages]
  uint64_t* empty;  // [kStages], one arrival per consumer warp
};

template <int N0, int N1>
__device__ __forceinline__ void rescale(float (&o0)[N0], float (&o1)[N1],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N0; ++i) o0[i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int i = 0; i < N1; ++i) o1[i] *= alpha[(i >> 1) & 1];
}

// S = Q.K^T of one kv tile for one warpgroup's 64 rows, issued and
// committed (the caller waits): D / 16 k-steps across the panels.
template <int D>
__device__ __forceinline__ void qk_issue(float (&sc)[SwaTiles<D>::kBK / 2],
                                         uint32_t q_base0, uint32_t q_base1,
                                         uint32_t k_base) {
  using T = SwaTiles<D>;
  constexpr int kW0 = T::kW0, kW1 = T::kW1;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    if (kk * 16 < kW0) {
      wgmma_ss<T::kBK>(sc, Panel<kW0>::k_major(q_base0, kk),
                       Panel<kW0>::k_major(k_base, kk), kk > 0);
    } else if constexpr (kW1 > 0) {
      const int k1 = kk - kW0 / 16;
      wgmma_ss<T::kBK>(sc, Panel<kW1>::k_major(q_base1, k1),
                       Panel<kW1>::k_major(k_base + T::kPanel1, k1), 1);
    }
  }
  wgmma_commit();
}

// O += P.V over the tile's kBK / 16 k-steps, one wgmma per panel of V,
// issued and committed.
template <int D, int N0, int N1, int KS>
__device__ __forceinline__ void pv_issue(float (&o0)[N0], float (&o1)[N1],
                                         const uint32_t (&pa)[KS][4],
                                         uint32_t v_base) {
  using T = SwaTiles<D>;
  fence_regs(o0);
  fence_regs(o1);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    wgmma_rs<T::kW0>(o0, pa[kk], Panel<T::kW0>::mn_major(v_base, kk));
    if constexpr (T::kW1 > 0)
      wgmma_rs<T::kW1>(o1, pa[kk],
                       Panel<T::kW1>::mn_major(v_base + T::kPanel1, kk));
  }
  wgmma_commit();
}

// The online softmax of one tile's logits `sc` (masked only when MASK),
// in place: updates the running max m (log2 units) and this lane's share
// of the row sum l, returns the rescale factor of O in alpha and leaves P
// in sc. `row` is this thread's first row (the second is row + 8), k0 the
// tile's first key.
template <bool MASK, int NS>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[NS], int row, int k0, int t4, int S, int window, int causal,
    float scale_log2, float (&m)[2], float (&l)[2], float (&alpha)[2]) {
  auto seen = [&](int i) {
    return !MASK || visible(row + 8 * ((i >> 1) & 1),
                            k0 + 8 * (i >> 2) + 2 * t4 + (i & 1), S, window,
                            causal);
  };
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int i = 0; i < NS; ++i)
    if (seen(i)) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // a row lives in the 4 lanes of a quad
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
    const float m_new =
        fmaxf(m[h], mx[h] > 0.5f * kNeg ? mx[h] * scale_log2 : kNeg);
    alpha[h] = fast_exp2(m[h] - m_new);
    m[h] = m_new;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int h = (i >> 1) & 1;
    sc[i] = seen(i) ? fast_exp2(fmaf(sc[i], scale_log2, -m[h])) : 0.f;
    l[h] += sc[i];
  }
}

// P, rounded to bf16, as the A fragments of P.V's k-steps: logits
// 8kk..8kk+7 are keys 16kk..16kk+15 of this thread's two rows.
template <int NS, int KS>
__device__ __forceinline__ void pack_p(const float (&p)[NS],
                                       uint32_t (&pa)[KS][4]) {
#pragma unroll
  for (int i = 0; i < NS; i += 2)
    pa[i >> 3][(i >> 1) & 3] = pack_bf16(p[i], p[i + 1]);
}

// The softmax of visited tile i, masked when it is a boundary tile.
template <int BK, int NS>
__device__ __forceinline__ void softmax_step(
    float (&sc)[NS], int i, int lo, int q0, int q_last, int row, int t4,
    int S, int window, int causal, float scale_log2, float (&m)[2],
    float (&l)[2], float (&alpha)[2]) {
  const int k0 = (lo + i) * BK;
  if (tile_full<BK>(q0, q_last, k0, S, window, causal))
    softmax_tile<false>(sc, row, k0, t4, S, window, causal, scale_log2, m, l,
                        alpha);
  else
    softmax_tile<true>(sc, row, k0, t4, S, window, causal, scale_log2, m, l,
                       alpha);
}

template <int D>
__global__ void __launch_bounds__(384, 1) swa_bf16_kernel(
    const __grid_constant__ CUtensorMap tq0,
    const __grid_constant__ CUtensorMap tq1,
    const __grid_constant__ CUtensorMap tk0,
    const __grid_constant__ CUtensorMap tk1,
    const __grid_constant__ CUtensorMap tv0,
    const __grid_constant__ CUtensorMap tv1, __nv_bfloat16* __restrict__ o,
    int S, int group, int window, int causal, float scale_log2) {
  using T = SwaTiles<D>;
  constexpr int kW0 = T::kW0, kW1 = T::kW1, kBQ = T::kBQ, kBK = T::kBK;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + T::kBars);
  const SwaBars bar{bars, bars + 1, bars + 1 + T::kStages,
                    bars + 1 + 2 * T::kStages};

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int lo, hi;
  tile_range<kBK>(q0, min(q0 + kBQ, S) - 1, S, window, causal, lo, hi);
  const int n_tiles = hi - lo + 1;

  if (tid == 0) {
    mbar_init(bar.q, 1);
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&bar.k[s], 1);
      mbar_init(&bar.v[s], 1);
      mbar_init(&bar.empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // Producer warpgroup: one thread issues every TMA load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == 8 && lane == 0 && n_tiles > 0) {
      tma_prefetch(&tq0);
      tma_prefetch(&tk0);
      tma_prefetch(&tv0);
      const int kvh = bh / group;
      mbar_expect_tx(bar.q, T::kQBytes);
      tma_load(smem, &tq0, bar.q, 0, q0, bh);
      if (kW1 > 0) tma_load(smem + kBQ * kW0 * 2, &tq1, bar.q, kW0, q0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % T::kStages;
        mbar_wait(&bar.empty[s], ((i / T::kStages) & 1) ^ 1);
        const int k0 = (lo + i) * kBK;
        uint8_t* kt = smem + T::k_tile(s);
        uint8_t* vt = smem + T::v_tile(s);
        mbar_expect_tx(&bar.k[s], T::kTileBytes);
        tma_load(kt, &tk0, &bar.k[s], 0, k0, kvh);
        if (kW1 > 0) tma_load(kt + T::kPanel1, &tk1, &bar.k[s], kW0, k0, kvh);
        mbar_expect_tx(&bar.v[s], T::kTileBytes);
        tma_load(vt, &tv0, &bar.v[s], 0, k0, kvh);
        if (kW1 > 0) tma_load(vt + T::kPanel1, &tv1, &bar.v[s], kW0, k0, kvh);
      }
    }
  } else {
    // Consumer warpgroups 0 and 1: 64 q rows each, 16 a warp.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3;
    const int row = q0 + 64 * wg + 16 * (warp & 3) + g;
    const uint32_t q_base0 = smem_addr(smem + wg * 64 * kW0 * 2);
    const uint32_t q_base1 =
        smem_addr(smem + kBQ * kW0 * 2 + wg * 64 * kW1 * 2);
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // rows row, row + 8
    float o0[kW0 / 2], o1[kW1 > 0 ? kW1 / 2 : 1];
#pragma unroll
    for (int i = 0; i < kW0 / 2; ++i) o0[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (kW1 > 0 ? kW1 / 2 : 1); ++i) o1[i] = 0.f;
    // A warpgroup issues P.V of tile i and S of tile i + 1 together,
    // waits for both, then runs the softmax of tile i + 1 while the other
    // warpgroup's products run: the two take turns to issue (warpgroup 0
    // first; turn t is S of tile t and P.V of tile t - 1, and warpgroup 1
    // passes no turn after its last), so softmaxes and products alternate.
    const int q_last = min(q0 + kBQ, S) - 1;
    float alpha[2];
    uint32_t pa[kBK / 16][4];
    if (n_tiles > 0) {
      float sc[kBK / 2];
      if (wg == 1) turn_pass(wg);
      mbar_wait(bar.q, 0);
      mbar_wait(&bar.k[0], 0);
      turn_wait(wg);
      qk_issue<D>(sc, q_base0, q_base1, smem_addr(smem + T::k_tile(0)));
      turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax_step<kBK>(sc, 0, lo, q0, q_last, row, t4, S, window, causal,
                        scale_log2, m, l, alpha);
      pack_p(sc, pa);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % T::kStages, ph = (i / T::kStages) & 1;
      const bool more = i + 1 < n_tiles;
      float sc[kBK / 2];
      rescale(o0, o1, alpha);
      mbar_wait(&bar.v[s], ph);
      if (more)
        mbar_wait(&bar.k[(i + 1) % T::kStages], ((i + 1) / T::kStages) & 1);
      turn_wait(wg);
      pv_issue<D>(o0, o1, pa, smem_addr(smem + T::v_tile(s)));
      if (more)
        qk_issue<D>(sc, q_base0, q_base1,
                    smem_addr(smem + T::k_tile((i + 1) % T::kStages)));
      if (wg == 0 || more) turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(o0);
      fence_regs(o1);
      if (lane == 0) mbar_arrive(&bar.empty[s]);
      if (more) {
        fence_regs(sc);
        softmax_step<kBK>(sc, i + 1, lo, q0, q_last, row, t4, S, window,
                          causal, scale_log2, m, l, alpha);
        pack_p(sc, pa);
      }
    }

    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(kFull, l[h], 1);
      l[h] += __shfl_xor_sync(kFull, l[h], 2);
      inv[h] = l[h] > 0.f ? 1.f / l[h] : 0.f;  // no visible key: 0
    }
    o += (int64_t)bh * S * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r >= S) continue;
      __nv_bfloat16* out = o + (int64_t)r * D + 2 * t4;
#pragma unroll
      for (int j = 0; j < kW0 / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + 8 * j) = pack_bf16(
            o0[4 * j + 2 * h] * inv[h], o0[4 * j + 2 * h + 1] * inv[h]);
      if constexpr (kW1 > 0) {
#pragma unroll
        for (int j = 0; j < kW1 / 8; ++j)
          *reinterpret_cast<uint32_t*>(out + kW0 + 8 * j) = pack_bf16(
              o1[4 * j + 2 * h] * inv[h], o1[4 * j + 2 * h + 1] * inv[h]);
      }
    }
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

// cuTensorMapEncodeTiled, a driver API call, fetched through the runtime
// so that the library links against nothing but cudart.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static std::atomic<EncodeTiled> cached{nullptr};
  EncodeTiled fn = cached.load(std::memory_order_acquire);
  if (fn != nullptr) return fn;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
    return nullptr;
  }
  fn = reinterpret_cast<EncodeTiled>(p);
  cached.store(fn, std::memory_order_release);
  return fn;
}

// A 3-D map (D, S, heads) of a contiguous bf16 [heads, S, D] tensor whose
// box is `width` columns from x = its TMA coordinate, `rows` rows and one
// head, swizzled over 2 * width bytes. Out-of-bounds rows load as zeros.
bool encode_panel(EncodeTiled fn, CUtensorMap* map, const void* base, int D,
                  int S, int heads, int width, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)width, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz = width == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : width == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int Hq, int Hkv, int S, int window, int causal,
                cudaStream_t st) {
  using T = SwaTiles<D>;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap maps[6];
  const void* bases[3] = {q, k, v};
  const int heads[3] = {B * Hq, B * Hkv, B * Hkv};
  const int rows[3] = {T::kBQ, T::kBK, T::kBK};
  for (int t = 0; t < 3; ++t) {
    // Panel 1 of D = 32 / 64 is never loaded: its map repeats panel 0.
    const int w1 = T::kW1 > 0 ? T::kW1 : T::kW0;
    if (!encode_panel(fn, &maps[2 * t], bases[t], D, S, heads[t], T::kW0,
                      rows[t]) ||
        !encode_panel(fn, &maps[2 * t + 1], bases[t], D, S, heads[t], w1,
                      rows[t]))
      return (int)cudaErrorInvalidValue;
  }
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err =
      allow_dynamic_smem(swa_bf16_kernel<D>, T::kSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  const dim3 grid(B * Hq, (S + T::kBQ - 1) / T::kBQ);
  swa_bf16_kernel<D><<<grid, T::kThreads, T::kSmem, st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], (__nv_bfloat16*)o,
      S, Hq / Hkv, window, causal, scale_log2);
  return (int)cudaGetLastError();
}

#define SWA_F32_ARGS                                                       \
  (const float*)q, (const float*)k, (const float*)v, (float*)o, S, group, \
      window, causal, 1.0f / sqrtf((float)D)

}  // namespace

// window < 0: unbounded; bf16 != 0: bf16 tensors, else f32.
extern "C" int swa_attention_launch(const void* q, const void* k,
                                    const void* v, void* o, int B, int Hq,
                                    int Hkv, int S, int D, int window,
                                    int causal, int bf16, void* stream) {
  if (B == 0 || Hq == 0 || S == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  const int group = Hq / Hkv;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    switch (D) {
      case 32:
        return launch_bf16<32>(q, k, v, o, B, Hq, Hkv, S, window, causal,
                            st);
      case 64:
        return launch_bf16<64>(q, k, v, o, B, Hq, Hkv, S, window, causal,
                            st);
      case 80:
        return launch_bf16<80>(q, k, v, o, B, Hq, Hkv, S, window, causal,
                            st);
      case 96:
        return launch_bf16<96>(q, k, v, o, B, Hq, Hkv, S, window, causal,
                            st);
      case 128:
        return launch_bf16<128>(q, k, v, o, B, Hq, Hkv, S, window, causal,
                            st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const dim3 grid(B * Hq, (S + 15) / 16);
  switch (D) {
    case 32: swa_f32_kernel<32><<<grid, 128, 0, st>>>(SWA_F32_ARGS); break;
    case 64: swa_f32_kernel<64><<<grid, 128, 0, st>>>(SWA_F32_ARGS); break;
    case 80: swa_f32_kernel<80><<<grid, 128, 0, st>>>(SWA_F32_ARGS); break;
    case 96: swa_f32_kernel<96><<<grid, 128, 0, st>>>(SWA_F32_ARGS); break;
    case 128: swa_f32_kernel<128><<<grid, 128, 0, st>>>(SWA_F32_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
