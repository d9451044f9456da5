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
// batch: each event reads the rows the previous one on them wrote.
//
// What bounds it: latency. The bytes are few (the event arrays, and each
// touched row read and written once); the chain is not. But an event
// depends only on the last valid earlier event on its user row and on its
// item row, so the chain is as long as its longest path of such links
// (tens of events for thousands of random events), not E.
//
// Design (tests/test_torch_kernels.py::isgd_schedule models it on the
// CPU): one CTA of 32 warps takes the events a chunk at a time (the
// largest power of two up to 2,048 whose rows fit in shared memory).
//   stage    load the chunk's slots; link each valid, in-range event to
//            its previous event on its user row and on its item row (pu
//            / pi, as bucket_stage.cuh's analyse step computes them for
//            K1): one warp per table walks the chunk 32 events at a time,
//            finds links inside the 32 by __match_any_sync and the rest in
//            a shared-memory hash map from slot to the last event seen,
//            so the chunk costs n / 32 short steps and no O(n^2)
//            compare; mark the last event on every row; gather, in one
//            parallel round trip (8 loads in flight a thread), the row of
//            every event that has no previous event into that event's
//            slot of the staged rows;
//   replay   each event belongs to the warp of its row (slot mod 32) in
//            the table with more links in the chunk, so that table's
//            chains run inside one warp (staging lists each warp's
//            events in order); a warp takes its events in order, waits
//            (done flags) only for a previous event of another warp,
//            reads the staged rows (from registers where its own last
//            event wrote them), applies csrc/sgd_step.cuh's isgd_step
//            unchanged, writes its own staged rows and raises its flag
//            if an event of another warp follows it; the next event's
//            rows load while the current one steps. A row's events thus
//            run in the order of the batch, every event reads exactly
//            the values the one-warp kernel read, and the result is that
//            kernel's bit for bit; independent events run at once. A
//            warp only waits for earlier events, and the earliest
//            unfinished one never waits, so the replay cannot deadlock;
//            when every event shares one row, one warp runs them all;
//   write    the last event on each row writes it back, once.
// The chunk's barriers order its writes before the next chunk's gathers.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "sgd_step.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 2048;       // events staged at once
constexpr int kSmemBudget = 224 * 1024;
constexpr int kChunkInts = 7;         // int arrays of a chunk (Chunk)
constexpr int kGather = 8;            // row loads in flight a thread
constexpr unsigned kFull = 0xffffffffu;

// Per-event flags: the last valid event on its user / item row; its
// previous event on the user / item row runs in another warp (wait for
// it); an event of another warp follows it (raise its done flag).
constexpr int kLastU = 1;
constexpr int kLastI = 2;
constexpr int kWaitU = 4;
constexpr int kWaitI = 8;
constexpr int kPublish = 16;

// The warp that replays an event: its row's slot mod kWarps.
__device__ __forceinline__ int warp_of(int slot) {
  return (int)((unsigned)slot % kWarps);
}

__host__ __device__ constexpr int row_bytes(int ch, int K) {
  // The staged rows (u then i, one of each per event); before the
  // gather, the two tables' hash maps (2 ch entries of key and value
  // each) in the same bytes.
  return 8 * ch * K > 32 * ch ? 8 * ch * K : 32 * ch;
}

// The chunk's shared memory, and 32 floats past it: a lane at or beyond K
// reads a row's neighbouring words (load_rows), never outside.
__host__ __device__ constexpr int chunk_smem(int ch, int K) {
  return row_bytes(ch, K) + kChunkInts * 4 * ch + 32 * 4;
}

// Largest power-of-two chunk within the budget (0: none fits).
inline int chunk_of(int K) {
  int ch = kMaxChunk;
  while (ch > 1 && chunk_smem(ch, K) > kSmemBudget) ch /= 2;
  return chunk_smem(ch, K) > kSmemBudget ? 0 : ch;
}

struct Chunk {
  float *urow, *irow;   // staged rows, K floats an event
  int* map;             // hash maps slot -> last event, aliasing the rows
  int *us, *is;         // slots; us < 0: the event changes nothing
  int *pu, *pi;         // previous valid event on the row (-1: none)
  int* flags;           // kLastU | kLastI | kWaitU | kWaitI | kPublish
  int* done;            // the event has run (read volatile); before the
                        // replay, each event's rank among its warp's
  int* order;           // the valid events, by warp, each warp's in order
};

__device__ __forceinline__ Chunk carve(unsigned char* smem, int ch, int K) {
  Chunk c;
  c.urow = reinterpret_cast<float*>(smem);
  c.irow = c.urow + ch * K;
  c.map = reinterpret_cast<int*>(smem);
  int* p = reinterpret_cast<int*>(smem + row_bytes(ch, K));
  c.us = p;
  c.is = p + ch;
  c.pu = p + 2 * ch;
  c.pi = p + 3 * ch;
  c.flags = p + 4 * ch;
  c.done = p + 5 * ch;
  c.order = p + 6 * ch;  // kChunkInts arrays
  return c;
}

// Links the valid events of one table (slots `slot`, validity us >= 0)
// to their previous valid event on the same row, in one warp: per block
// of 32 events, a lane's previous event is the highest lower lane with
// its slot (__match_any_sync) or, for the first lane of a slot, the map's
// entry; then the block's last lane of each slot records itself in the
// map. The map (2 ch buckets of key, value; linear probing; key -1 is
// free) holds at most ch slots. Returns the number of links.
__device__ __forceinline__ int link_table(const int* slot, const int* us,
                                          int n, int ch, int* prev, int* map,
                                          int lane) {
  const unsigned buckets = 2 * ch;
  const int shift = __clz(buckets) + 1;  // hash: the top log2(buckets) bits
  int* key = map;
  int* val = map + buckets;
  int count = 0;
  for (int base = 0; base < n; base += 32) {
    const int e = base + lane;
    const bool ok = e < n && us[e] >= 0;
    const int s = ok ? slot[e] : -1;
    const unsigned same = __match_any_sync(kFull, s);
    const unsigned below = same & ((1u << lane) - 1);
    const unsigned above = lane == 31 ? 0u : same >> (lane + 1);
    unsigned h = (unsigned)s * 2654435761u >> shift;
    int p = -1;
    if (ok && below) {
      p = base + 31 - __clz(below);
    } else if (ok) {
      for (;; h = (h + 1) & (buckets - 1)) {
        const int k = key[h];
        if (k == s) p = val[h];
        if (k == s || k == -1) break;
      }
    }
    if (e < n) prev[e] = p;
    count += __popc(__ballot_sync(kFull, p >= 0));
    if (ok && !above) {  // distinct slots: a free bucket is claimed by CAS
      for (;; h = (h + 1) & (buckets - 1)) {
        const int k = atomicCAS(&key[h], -1, s);
        if (k == -1 || k == s) break;
      }
      val[h] = e;
    }
    __syncwarp();  // the next block's lookups see this block's entries
  }
  return count;
}

// Stage: slots, links to the previous event on each row (counted per
// table in links[0] / links[1]), the last event on each row, the waits
// and flags of the replay, and the gathered rows of the events with no
// previous one.
__device__ __forceinline__ void stage_chunk(const Chunk& c, int n, int ch,
                                            int K, const float* ut,
                                            const float* it,
                                            const int* u_slots,
                                            const int* i_slots,
                                            const uint8_t* valid, int U,
                                            int I, int* links) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int e = tid; e < n; e += kThreads) {
    const unsigned us = u_slots[e], is = i_slots[e];
    const bool ok = valid[e] && us < (unsigned)U && is < (unsigned)I;
    c.us[e] = ok ? (int)us : -1;
    c.is[e] = (int)is;
    c.flags[e] = ok ? kLastU | kLastI : 0;
    c.done[e] = 0;
  }
  for (int x = tid; x < 8 * ch; x += kThreads) c.map[x] = -1;
  __syncthreads();
  if (warp < 2) {  // warp 0 the user table, warp 1 the item table
    int* map = c.map + warp * 4 * ch;
    const int count = link_table(warp ? c.is : c.us, c.us, n, ch,
                                 warp ? c.pi : c.pu, map, lane);
    if (lane == 0) links[warp] = count;
  }
  __syncthreads();
  // An event with a previous event ends that one's run on the row. An
  // event belongs to the warp of its row (warp_of: slot mod kWarps) in the
  // table with more links; a link to an event of another warp is waited
  // for, and that event raises its flag.
  const int* owner_slot = links[1] > links[0] ? c.is : c.us;
  for (int e = tid; e < n; e += kThreads) {
    if (c.us[e] < 0) continue;
    const int me = warp_of(owner_slot[e]);
    const int a = c.pu[e], b = c.pi[e];
    int f = 0;
    if (a >= 0) {
      atomicAnd(&c.flags[a], ~kLastU);
      if (warp_of(owner_slot[a]) != me) {
        f |= kWaitU;
        atomicOr(&c.flags[a], kPublish);
      }
    }
    if (b >= 0) {
      atomicAnd(&c.flags[b], ~kLastI);
      if (warp_of(owner_slot[b]) != me) {
        f |= kWaitI;
        atomicOr(&c.flags[b], kPublish);
      }
    }
    if (f) atomicOr(&c.flags[e], f);
  }
  // Each warp's events, in order: warp 0 walks the chunk 32 events at a
  // time, ranking each event among its warp's (__match_any_sync) after
  // the running count of that warp (links[2 + v]), then turns the counts
  // into where each warp's events start (links[2 + v], links[34] the end).
  if (warp == 0) {
    links[2 + lane] = 0;
    __syncwarp();
    for (int base = 0; base < n; base += 32) {
      const int e = base + lane;
      const int o = e < n && c.us[e] >= 0 ? warp_of(owner_slot[e]) : -1;
      const unsigned same = __match_any_sync(kFull, o);
      const int before = o >= 0 ? links[2 + o] : 0;
      if (o >= 0) c.done[e] = before + __popc(same & ((1u << lane) - 1));
      __syncwarp();
      const unsigned above = lane == 31 ? 0u : same >> (lane + 1);
      if (o >= 0 && !above) links[2 + o] = before + __popc(same);
      __syncwarp();
    }
    const int count = links[2 + lane];
    int end = count;  // inclusive scan over the warps
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, end, d);
      if (lane >= d) end += up;
    }
    links[2 + lane] = end - count;
    if (lane == 31) links[34] = end;
  }
  __syncthreads();
  for (int e = tid; e < n; e += kThreads) {
    if (c.us[e] < 0) continue;
    const int o = warp_of(owner_slot[e]);
    c.order[links[2 + o] + c.done[e]] = e;
  }
  __syncthreads();
  for (int e = tid; e < n; e += kThreads) c.done[e] = 0;
  // The maps are dead: gather the first row of every touched row,
  // kGather loads in flight a thread.
  for (int x0 = tid; x0 < 2 * n * K; x0 += kThreads * kGather) {
    float v[kGather];
    float* dst[kGather];
#pragma unroll
    for (int j = 0; j < kGather; ++j) {
      const int x = x0 + j * kThreads;
      dst[j] = nullptr;
      v[j] = 0.f;
      if (x < 2 * n * K) {
        const bool item = x >= n * K;
        const int y = item ? x - n * K : x;
        const int e = y / K, k = y - e * K;
        if (c.us[e] >= 0 && (item ? c.pi : c.pu)[e] < 0) {
          dst[j] = (item ? c.irow : c.urow) + y;
          v[j] = item ? it[(int64_t)c.is[e] * K + k]
                      : ut[(int64_t)c.us[e] * K + k];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kGather; ++j) {
      if (dst[j] != nullptr) *dst[j] = v[j];
    }
  }
  __syncthreads();
}

// Waits until event e has run. A flag that never rises traps after 2^26
// polls (about a second), so a fault fails the launch instead of hanging
// the card.
__device__ __forceinline__ void wait_done(volatile int* done, int e) {
  for (int polls = 0; !done[e]; ++polls) {
    if (polls == 1 << 26) __trap();
  }
}

// An event of a warp's slice: its index, pu / pi, flags.
struct Event {
  int e, a, b, f;
};

__device__ __forceinline__ Event event_of(const Chunk& c, int e) {
  return Event{e, c.pu[e], c.pi[e], c.flags[e]};
}

// The staged rows an event reads (its own gathered ones where it has no
// previous event), lane k feature k; lanes at or beyond K read a
// neighbouring word of shared memory and are masked by the caller.
__device__ __forceinline__ void load_rows(const Chunk& c, const Event& v,
                                          int K, int lane, float& u,
                                          float& i) {
  u = c.urow[(v.a >= 0 ? v.a : v.e) * K + lane];
  i = c.irow[(v.b >= 0 ? v.b : v.e) * K + lane];
}

// Replay: every valid event once both of its previous events have run,
// each warp taking its own events (its slice of `order`) in order. The
// table with more links has its chains inside one warp, in program
// order; only the other table's links between warps are waited for (and
// the fence after). A warp's chain is software-pipelined: while event x
// steps, the rows of event x + 1 are already loaded (unless it waits for
// another warp) and the links of event x + 2 are on their way; a row the
// warp's last event wrote comes from its registers (`last`), so a chain
// through one row never goes through memory.
__device__ __forceinline__ void replay_chunk(const Chunk& c, int K, float eta,
                                             float lam, const int* links) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool in_k = lane < K;
  volatile int* done = c.done;
  const int begin = links[2 + warp], end = links[3 + warp];
  if (begin >= end) return;
  constexpr int kWaits = kWaitU | kWaitI;
  Event cur = event_of(c, c.order[begin]);
  Event next = cur;
  if (begin + 1 < end) next = event_of(c, c.order[begin + 1]);
  int after = begin + 2 < end ? c.order[begin + 2] : 0;
  float u_row = 0.f, i_row = 0.f;
  if (!(cur.f & kWaits)) load_rows(c, cur, K, lane, u_row, i_row);
  int last = -1;
  float u_last = 0.f, i_last = 0.f;
  for (int x = begin; x < end; ++x) {
    if (cur.f & kWaits) {  // another warp's event first
      if (cur.f & kWaitU) wait_done(done, cur.a);
      if (cur.f & kWaitI) wait_done(done, cur.b);
      __threadfence_block();
      load_rows(c, cur, K, lane, u_row, i_row);
    }
    float u_next = 0.f, i_next = 0.f;
    if (x + 1 < end && !(next.f & kWaits))
      load_rows(c, next, K, lane, u_next, i_next);
    Event after_ev = next;
    if (x + 2 < end) after_ev = event_of(c, after);
    const int after2 = x + 3 < end ? c.order[x + 3] : 0;
    const float u = cur.a >= 0 && cur.a == last ? u_last : in_k ? u_row : 0.f;
    const float i = cur.b >= 0 && cur.b == last ? i_last : in_k ? i_row : 0.f;
    float u_new, i_new;
    isgd_step(u, i, eta, lam, u_new, i_new);
    if (in_k) {
      c.urow[cur.e * K + lane] = u_new;
      c.irow[cur.e * K + lane] = i_new;
    }
    if (cur.f & kPublish) {
      __threadfence_block();
      __syncwarp();
      if (lane == 0) done[cur.e] = 1;
    }
    last = cur.e;
    u_last = u_new;
    i_last = i_new;
    cur = next;
    u_row = u_next;
    i_row = i_next;
    next = after_ev;
    after = after2;
  }
}

// Write: each touched row by its last event, a warp an event, lane k
// feature k.
__device__ __forceinline__ void write_chunk(const Chunk& c, int n, int K,
                                            float* ut, float* it) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane >= K) return;
  for (int e = warp; e < n; e += kWarps) {
    const int f = c.us[e] >= 0 ? c.flags[e] : 0;
    if (f & kLastU) ut[(int64_t)c.us[e] * K + lane] = c.urow[e * K + lane];
    if (f & kLastI) it[(int64_t)c.is[e] * K + lane] = c.irow[e * K + lane];
  }
}

__global__ void __launch_bounds__(kThreads) isgd_update_kernel(
    float* ut, float* it, const int* __restrict__ u_slots,
    const int* __restrict__ i_slots, const uint8_t* __restrict__ valid, int U,
    int I, int K, int E, int ch, float eta, float lam) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int links[35];  // per table; where each warp's events start
  const Chunk c = carve(smem, ch, K);
  for (int e0 = 0; e0 < E; e0 += ch) {
    const int n = min(ch, E - e0);
    stage_chunk(c, n, ch, K, ut, it, u_slots + e0, i_slots + e0, valid + e0,
                U, I, links);
    replay_chunk(c, K, eta, lam, links);
    __syncthreads();
    write_chunk(c, n, K, ut, it);
    __syncthreads();
  }
}

}  // namespace

extern "C" int isgd_update_launch(void* ut, void* it, const void* u_slots,
                                  const void* i_slots, const void* valid,
                                  int U, int I, int K, int E, float eta,
                                  float lam, void* stream) {
  if (E == 0) return 0;
  int ch = chunk_of(K);
  if (ch == 0 || K > 32) return (int)cudaErrorInvalidValue;
  while (ch / 2 >= E) ch /= 2;  // a short batch stages less
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err =
      allow_dynamic_smem(isgd_update_kernel, kSmemBudget, smem_set);
  if (err != cudaSuccess) return (int)err;
  isgd_update_kernel<<<1, kThreads, chunk_smem(ch, K), (cudaStream_t)stream>>>(
      (float*)ut, (float*)it, (const int*)u_slots, (const int*)i_slots,
      (const uint8_t*)valid, U, I, K, E, ch, eta, lam);
  return (int)cudaGetLastError();
}
