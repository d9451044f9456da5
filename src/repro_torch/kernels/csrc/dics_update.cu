// dics_update: the streaming DICS micro-batch update (Eq. 6 statistics).
//
// Replaces the Pallas TPU kernel src/repro/kernels/dics_update.py::
// dics_update_kernel (wrapper dics_update_pallas, pl.pallas_call at :130).
// Plain version: src/repro_torch/kernels/ref.py::dics_apply.
//
// Per event, in order, on one worker:
//   1. new_u / new_i from the raw slot compare (uid[us] != u_id, ...);
//   2. the eviction clears, NOT gated on the event's validity: a padding
//      event (id -1, slot cap - 1) clears a live last slot, as the JAX
//      reference does — the rated row if new_u; if new_i the rated column,
//      the co row and column and cnt;
//   3. valid events only: hist = rated[us, :] (after the clears) added to
//      the co row, then to the co column, which reads the row-updated
//      diagonal, so co[i, i] gains hist[i] twice; cnt[i] += 1; the
//      bookkeeping and clock; rated[us, is] = 1.
// `live` (a byte, may be null): when it is 0 the launch changes nothing,
// the device loop's counterpart of the JAX engine skipping a step with no
// events; it is read on the card, so the host never waits for it.
//
// Design (csrc/bucket_stage.cuh): one cluster of kBucketCtas CTAs per
// worker, one launch per step. Every CTA stages the bucket and works out
// the tenancy, clears and last writers in shared memory. CTA 0 also
// stages each touched user's rated row as a bit mask (I / 8 bytes a row)
// and replays the chain in one warp: per event the row clear, the column
// bit cleared in every staged row, and a snapshot of the history (the
// row after the clears), then the set; each lane owns a word of every
// row, so only a column clear needs the warp to synchronise. Its other
// warps meanwhile zero the co rows / columns and cnt of the cleared item
// slots; every other warp of the cluster clears `rated` in the rows its
// CTA owns. After a barrier CTA 0 adds the snapshots into co and cnt and
// writes the bookkeeping, and each CTA writes the surviving sets of its
// rows.
//
// Exactness. co and cnt hold integer counts in f32, so adds in any order
// are exact while every value stays below 2^24 (a stream would need 2^24
// co-ratings of one item pair). An add of event e to co[a, b] (a = its
// item slot, b in its history, and the mirrored cell) or to cnt[a]
// survives iff no event after e clears slot a or slot b; every cell a
// clear of the chunk touches is zeroed before any add. That is the chain's
// result: a clear at e' zeroes the cell whatever was added before e', and
// adds after e' accumulate from 0. The diagonal takes hist[a] twice, as
// the chain gives it. rated follows the rule in bucket_stage.cuh. So every
// array equals the plain version bit for bit.
//
// What bounds it: the chain is in shared memory (a few dozen cycles an
// event for the replay), so the bytes now bound it: the column clears
// read one byte in each of the U rows per evicted item slot, spread over
// the cluster, and the staged history rows; the bookkeeping is one write
// per touched entry.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bucket_stage.cuh"

namespace {

// The 16 bytes of v as 16 bits, byte 0 in bit 0: 1 where nonzero.
__device__ __forceinline__ uint32_t nonzero_bytes(uint4 v) {
  uint32_t bits = 0;
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 16; ++q)
    bits |= (uint32_t)(((words[q >> 2] >> (8 * (q & 3))) & 0xffu) != 0) << q;
  return bits;
}

__global__ void __cluster_dims__(kBucketCtas, 1, 1)
    __launch_bounds__(kBucketThreads) dics_update_kernel(
        float* co, float* cnt, uint8_t* rated, int* uid, int* iid, int* ufq,
        int* ifq, int* uts, int* its, int* clk, const int* ev_u,
        const int* ev_i, const int* u_slots, const int* i_slots,
        const uint8_t* live, int U, int I, int E, int ch) {
  if (live != nullptr && *live == 0) return;  // uniform over the grid
  const int rank = blockIdx.x % kBucketCtas;
  const int64_t w = blockIdx.x / kBucketCtas;
  const bool lead = rank == 0;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  co += w * I * (int64_t)I;
  cnt += w * I;
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

  extern __shared__ __align__(16) int smem[];
  Bucket b;
  const int words = (I + 31) / 32;
  uint32_t* mask = reinterpret_cast<uint32_t*>(carve(b, smem, ch));
  uint32_t* snap = mask + (int64_t)ch * words;
  int64_t lo, hi;
  owned_rows(U, rank, lo, hi);
  const bool vec = I % 16 == 0 && (uintptr_t)rated % 16 == 0;

  for (int e0 = 0; e0 < E; e0 += ch) {
    const int n = min(ch, E - e0);
    stage_bucket(b, n, true, ev_u + e0, ev_i + e0, u_slots + e0,
                 i_slots + e0, uid, iid, ufq, ifq, clk, lead);
    if (lead) {  // the touched users' rated rows, as bit masks
      const int nslots = b.counts[2];
      for (int x = tid; x < nslots * words; x += nt) {
        const int k = x / words, wd = x - k * words;
        const int e = b.slots[k];
        const uint8_t* p = rated + (int64_t)b.us[e] * I + wd * 32;
        const int m = min(32, I - wd * 32);
        uint32_t bits = 0;
        if (vec) {
          for (int h = 0; h < m / 16; ++h)
            bits |= nonzero_bytes(reinterpret_cast<const uint4*>(p)[h])
                    << (16 * h);
        } else {
          for (int j = 0; j < m; ++j) bits |= (uint32_t)(p[j] != 0) << j;
        }
        mask[e * words + wd] = bits;
      }
    }
    analyse_bucket(b, n, true);
    cluster_sync();

    if (lead && warp == 0) {  // the chain, on the staged rows
      // Lane l owns word l (mod 32) of every staged row, so the row clear,
      // the snapshot and the set stay in the lane's own program order; a
      // column clear (rare) spans the lanes between two __syncwarp()s.
      // Each batch of 32 events' metadata is loaded once, one event a
      // lane, and broadcast by shuffle.
      const int nslots = b.counts[2];
      for (int base = 0; base < n; base += 32) {
        int m_row = 0, m_col = 0, m_flag = 0;
        if (base + lane < n) {
          const int e = base + lane;
          m_row = b.lu[e] * words;
          m_col = b.is[e];
          m_flag = (b.uflag[e] & kClear ? 1 : 0) |
                   (b.iflag[e] & kClear ? 2 : 0) | (b.ev_u[e] >= 0 ? 4 : 0);
        }
        for (int j = 0; j < min(32, n - base); ++j) {
          const int e = base + j;
          uint32_t* row = mask + __shfl_sync(0xffffffffu, m_row, j);
          const int c = __shfl_sync(0xffffffffu, m_col, j);
          const int flag = __shfl_sync(0xffffffffu, m_flag, j);
          if (flag & 2) {
            __syncwarp();
            const uint32_t keep = ~(1u << (c & 31));
            for (int k = lane; k < nslots; k += 32)
              mask[b.slots[k] * words + (c >> 5)] &= keep;
            __syncwarp();
          }
          if (!(flag & 5)) continue;  // no row clear, not valid
          for (int wd = lane; wd < words; wd += 32) {
            uint32_t v = flag & 1 ? 0u : row[wd];
            if (flag & 4) {
              snap[e * words + wd] = v;
              if (wd == c >> 5) v |= 1u << (c & 31);
            }
            row[wd] = v;
          }
        }
      }
    } else {
      const int t = lead ? tid - 32 : tid, nth = lead ? nt - 32 : nt;
      if (lead) {  // zero what the chunk's clears touch in co and cnt
        for (int k = 0; k < b.counts[0]; ++k) {
          const int64_t s = b.cols[k];
          for (int j = t; j < I; j += nth) {
            co[s * I + j] = 0.f;
            co[(int64_t)j * I + s] = 0.f;
          }
          if (t == 0) cnt[s] = 0.f;
        }
      }
      clear_rated(rated, I, lo, hi, b, t, nth);
    }
    __syncthreads();

    if (lead) {  // the adds that survive the chunk's clears
      for (int x = tid; x < n * words; x += nt) {
        const int e = x / words, wd = x - e * words;
        if (b.ev_u[e] < 0 || b.cclr[b.li[e]] > e) continue;
        const int64_t s = b.is[e];
        for (uint32_t bits = snap[e * words + wd]; bits; bits &= bits - 1) {
          const int j = wd * 32 + __ffs(bits) - 1;
          if (column_last_clear(b, j) > e) continue;
          atomicAdd(co + s * I + j, 1.f);
          atomicAdd(co + (int64_t)j * I + s, 1.f);
        }
      }
      for (int e = tid; e < n; e += nt)
        if (b.ev_u[e] >= 0 && b.cclr[b.li[e]] <= e)
          atomicAdd(cnt + b.is[e], 1.f);
      write_tables(b, n, uid, iid, ufq, ifq, uts, its, clk);
    }
    set_rated(rated, I, lo, hi, b, n);
    if (e0 + ch < E) {
      __syncthreads();
      cluster_sync();
    }
  }
}

}  // namespace

// The staged launch's layout for a bucket of E events: CTAs per worker,
// events per staged chunk, dynamic shared memory bytes per CTA.
extern "C" void dics_update_layout(int E, int I, int* out) {
  const int extra = 8 * ((I + 31) / 32);
  out[0] = kBucketCtas;
  out[1] = bucket_chunk(E, extra);
  out[2] = bucket_smem(out[1], extra);
}

extern "C" int dics_update_launch(
    void* co, void* cnt, void* rated, void* uid, void* iid, void* ufq,
    void* ifq, void* uts, void* its, void* clk, const void* ev_u,
    const void* ev_i, const void* u_slots, const void* i_slots,
    const void* live, int W, int U, int I, int E, void* stream) {
  if (W == 0 || E == 0) return 0;
  const int extra = 8 * ((I + 31) / 32);  // mask and snapshot rows
  const int ch = bucket_chunk(E, extra);
  if (ch == 0) return (int)cudaErrorInvalidValue;
  const int smem = bucket_smem(ch, extra);
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err =
      allow_dynamic_smem(dics_update_kernel, kSmemBudget, smem_set);
  if (err != cudaSuccess) return (int)err;
  dics_update_kernel<<<W * kBucketCtas, kBucketThreads, smem,
                       (cudaStream_t)stream>>>(
      (float*)co, (float*)cnt, (uint8_t*)rated, (int*)uid, (int*)iid,
      (int*)ufq, (int*)ifq, (int*)uts, (int*)its, (int*)clk,
      (const int*)ev_u, (const int*)ev_i, (const int*)u_slots,
      (const int*)i_slots, (const uint8_t*)live, U, I, E, ch);
  return (int)cudaGetLastError();
}
