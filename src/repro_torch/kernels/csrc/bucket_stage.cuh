// Stage, replay, write back: the bucket machinery shared by the two
// evicting micro-batch kernels, dics_update.cu and the ISGD mode of
// factor_update.cu.
//
// A worker's bucket is a chain of events that read and write a few table
// slots each. Instead of walking that chain through device memory, one
// cluster of kBucketCtas CTAs per worker takes the bucket a chunk of at
// most kMaxChunk events at a time and, for each chunk:
//
//   stage    every CTA loads the chunk's events into shared memory in one
//            coalesced pass, maps each slot to the chunk's first event on
//            it (an O(n^2) compare spread over the block), and gathers the
//            touched uid / iid entries in one parallel round trip;
//   analyse  from those alone, in parallel: each event's previous valid
//            event on its slots, hence new_u / new_i against the replayed
//            tenancy (an earlier event of the chunk that took the slot
//            counts), the last row clear and column clear of every slot,
//            and the last valid event of every slot (its last writer);
//   replay   CTA 0 runs what truly chains (the SGD steps, or the DICS
//            history rows) in one warp on its staged copy; the bulk clears
//            of `rated` run meanwhile on every other warp of the cluster;
//   write    every table entry is written once, by its last writer.
//
// `rated` is written by a rule, not by the chain: rated[r, c] ends at 1 if
// the chunk sets (r, c) at some event e and no event after e clears row r
// or column c; otherwise at 0 if any event of the chunk clears row r or
// column c; otherwise it keeps its value. Clears and sets are written by
// the CTA that owns row r (cluster rank r * kBucketCtas / U): first the
// clears (a column clear reads the byte and writes only a nonzero one, so
// a clear over the U rows is U one-byte loads and almost no stores), then,
// after a barrier, the sets that survive. Rows have one owner, so no two
// CTAs write a byte; no grid-wide sync is needed. The cluster barrier
// after staging keeps every uid / iid read, and CTA 0's staged history
// rows, ahead of any write of the chunk, and the one closing each chunk
// orders it before the next chunk's staging.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "smem_limit.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kBucketThreads = 512;
constexpr int kBucketCtas = 8;     // CTAs per worker: one cluster
constexpr int kMaxChunk = 256;     // events staged at once
constexpr int kSmemBudget = 200 * 1024;
constexpr int kBucketInts = 20;    // int arrays of kMaxChunk in Bucket

// Per side (user / item) flags of an event.
constexpr int kNew = 1;    // the slot's tenant differs from the event's id
constexpr int kClear = 2;  // the event clears the slot's rated row / column
constexpr int kLast = 4;   // valid, and no later valid event on the slot

// The chunk's shared-memory arrays, each `ch` long; u / i for the two
// sides. Per-slot values sit at the index of the chunk's first event on
// the slot (`lu` / `li`).
struct Bucket {
  int *ev_u, *ev_i, *us, *is;
  int *lu, *li;        // first event on the same slot (-1: not staged)
  int *pu, *pi;        // previous valid event on the same slot (-1: none)
  int *u0, *i0;        // uid / iid at chunk start, per slot
  int *fu0, *fi0;      // ufq / ifq at chunk start, per slot (CTA 0)
  int *uflag, *iflag;  // kNew | kClear | kLast
  int *rclr, *cclr;    // last row / column clear, per slot (-1: none)
  int *cols, *col_last;  // distinct cleared item slots, ascending
  int *rows;           // distinct cleared user slots
  int *slots;          // scratch: first events of touched user slots
  int* counts;         // [0] cols, [1] rows, [2] slots, [3] clock at start
};

// Carves the arrays out of dynamic shared memory; returns the first word
// after them (kernel-specific arrays follow).
__device__ __forceinline__ int* carve(Bucket& b, int* p, int ch) {
  int** arrays[kBucketInts] = {
      &b.ev_u, &b.ev_i, &b.us,  &b.is,    &b.lu,   &b.li,       &b.pu,
      &b.pi,   &b.u0,   &b.i0,  &b.fu0,   &b.fi0,  &b.uflag,    &b.iflag,
      &b.rclr, &b.cclr, &b.cols, &b.col_last, &b.rows, &b.slots};
  for (int k = 0; k < kBucketInts; ++k) {
    *arrays[k] = p;
    p += ch;
  }
  b.counts = p;
  return p + 4;
}

// Shared-memory bytes for a chunk of `ch` events plus `extra` bytes an
// event.
__host__ __device__ constexpr int bucket_smem(int ch, int extra) {
  return (kBucketInts * ch + 4) * 4 + extra * ch;
}

// Largest chunk within the budget for a bucket of E events.
inline int bucket_chunk(int E, int extra) {
  int ch = E < kMaxChunk ? E : kMaxChunk;
  while (ch > 1 && bucket_smem(ch, extra) > kSmemBudget) ch /= 2;
  return bucket_smem(ch, extra) > kSmemBudget ? 0 : ch;
}

__device__ __forceinline__ void cluster_sync() {
  __threadfence();
  cg::this_cluster().sync();
}

// Stage: the chunk's events, the slots' first events, and the tenants at
// chunk start (`all`: padding events take part, as DICS's unguarded
// clears need; otherwise only valid events touch anything). With
// `freq`, also ufq / ifq and the clock (CTA 0, which writes them).
__device__ void stage_bucket(const Bucket& b, int n, bool all,
                             const int* ev_u, const int* ev_i,
                             const int* u_slots, const int* i_slots,
                             const int* uid, const int* iid, const int* ufq,
                             const int* ifq, const int* clk, bool freq) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int e = tid; e < n; e += nt) {
    b.ev_u[e] = ev_u[e];
    b.ev_i[e] = ev_i[e];
    b.us[e] = u_slots[e];
    b.is[e] = i_slots[e];
    b.rclr[e] = -1;
    b.cclr[e] = -1;
  }
  if (tid < 4) b.counts[tid] = tid == 3 && freq ? clk[0] : 0;
  __syncthreads();
  for (int x = tid; x < 2 * n; x += nt) {
    const bool item = x >= n;
    const int e = item ? x - n : x;
    const int* slot = item ? b.is : b.us;
    int first = -1;
    if (all || b.ev_u[e] >= 0) {
      const int s = slot[e];
      first = e;
      for (int f = 0; f < e; ++f) {
        if ((all || b.ev_u[f] >= 0) && slot[f] == s) {
          first = f;
          break;
        }
      }
      if (first == e) {  // one gather per touched slot
        if (item) {
          b.i0[e] = iid[s];
          if (freq) b.fi0[e] = ifq[s];
        } else {
          b.u0[e] = uid[s];
          if (freq) b.fu0[e] = ufq[s];
          b.slots[atomicAdd(&b.counts[2], 1)] = e;
        }
      }
    }
    (item ? b.li : b.lu)[e] = first;
  }
  __syncthreads();
}

// Analyse: tenancy, clears and last writers of every touched slot.
__device__ void analyse_bucket(const Bucket& b, int n, bool all) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int x = tid; x < 2 * n; x += nt) {
    const bool item = x >= n;
    const int e = item ? x - n : x;
    const int* loc = item ? b.li : b.lu;
    const int* id = item ? b.ev_i : b.ev_u;
    const int l = loc[e];
    int prev = -1, flag = 0;
    if (l >= 0) {
      for (int f = e - 1; f >= l; --f) {
        if (loc[f] == l && b.ev_u[f] >= 0) {
          prev = f;
          break;
        }
      }
      const int tenant = prev >= 0 ? id[prev] : (item ? b.i0 : b.u0)[l];
      const bool valid = b.ev_u[e] >= 0;
      if (tenant != id[e]) flag |= kNew | (all || valid ? kClear : 0);
      if (valid) flag |= kLast;
      if (flag & kClear) atomicMax(&(item ? b.cclr : b.rclr)[l], e);
    }
    (item ? b.pi : b.pu)[e] = prev;
    (item ? b.iflag : b.uflag)[e] = flag;
  }
  __syncthreads();
  // An event with a previous valid event on its slot ends that one's run.
  for (int x = tid; x < 2 * n; x += nt) {
    const bool item = x >= n;
    const int e = item ? x - n : x;
    const int prev = (item ? b.pi : b.pu)[e];
    if (prev >= 0 && b.ev_u[e] >= 0)
      atomicAnd(&(item ? b.iflag : b.uflag)[prev], ~kLast);
  }
  // The distinct cleared slots (order settled below for the columns).
  for (int x = tid; x < 2 * n; x += nt) {
    const bool item = x >= n;
    const int e = item ? x - n : x;
    if ((item ? b.li : b.lu)[e] != e) continue;
    if (item && b.cclr[e] >= 0) {
      const int k = atomicAdd(&b.counts[0], 1);
      b.col_last[k] = e;  // the slot's first event, for now
    } else if (!item && b.rclr[e] >= 0) {
      b.rows[atomicAdd(&b.counts[1], 1)] = b.us[e];
    }
  }
  __syncthreads();
  // Cleared columns in ascending slot order, each beside its last clear.
  const int ncols = b.counts[0];
  int slot = 0, last = 0, rank = 0;
  if (tid < ncols) {
    const int f = b.col_last[tid];
    slot = b.is[f];
    last = b.cclr[f];
    for (int k = 0; k < ncols; ++k) rank += b.is[b.col_last[k]] < slot;
  }
  __syncthreads();
  if (tid < ncols) {
    b.cols[rank] = slot;
    b.col_last[rank] = last;
  }
  __syncthreads();
}

// The last clear of item slot c in the chunk, -1 if none.
__device__ __forceinline__ int column_last_clear(const Bucket& b, int c) {
  int lo = 0, hi = b.counts[0];
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (b.cols[mid] < c) lo = mid + 1; else hi = mid;
  }
  return lo < b.counts[0] && b.cols[lo] == c ? b.col_last[lo] : -1;
}

// A valid event's set of rated[us, is] survives the chunk.
__device__ __forceinline__ bool set_survives(const Bucket& b, int e) {
  return b.rclr[b.lu[e]] <= e && b.cclr[b.li[e]] <= e;
}

// Rows of `rated` that this cluster rank owns.
__device__ __forceinline__ void owned_rows(int U, int rank, int64_t& lo,
                                           int64_t& hi) {
  lo = (int64_t)U * rank / kBucketCtas;
  hi = (int64_t)U * (rank + 1) / kBucketCtas;
}

// The chunk's clears of `rated` in rows [lo, hi), by threads t of nt:
// whole cleared rows, then every cleared column, each byte read and
// written only if nonzero.
__device__ void clear_rated(uint8_t* rated, int I, int64_t lo, int64_t hi,
                            const Bucket& b, int t, int nt) {
  const int ncols = b.counts[0], nrows = b.counts[1];
  const bool vec = I % 16 == 0 && (uintptr_t)rated % 16 == 0;
  for (int k = 0; k < nrows; ++k) {
    const int64_t r = b.rows[k];
    if (r < lo || r >= hi) continue;
    uint8_t* row = rated + r * I;
    if (vec) {
      uint4* v = reinterpret_cast<uint4*>(row);
      for (int q = t; q < I / 16; q += nt) {
        const uint4 x = v[q];
        if (x.x | x.y | x.z | x.w) v[q] = make_uint4(0, 0, 0, 0);
      }
    } else {
      for (int c = t; c < I; c += nt)
        if (row[c]) row[c] = 0;
    }
  }
  if (ncols == 0) return;
  // The (row, column) pairs of this thread's rows, kBatch loads in flight
  // at a time whatever the number of columns.
  constexpr int kBatch = 16;
  const int64_t span = hi - lo;
  const int64_t total = (span > t ? (span - t + nt - 1) / nt : 0) * ncols;
  int64_t i = 0;
  int k = 0;
  for (int64_t x = 0; x < total; x += kBatch) {
    uint8_t* p[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      p[j] = nullptr;
      if (x + j < total) {
        p[j] = rated + (lo + t + i * nt) * I + b.cols[k];
        if (++k == ncols) {
          k = 0;
          ++i;
        }
      }
    }
    uint8_t v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) v[j] = p[j] != nullptr ? *p[j] : 0;
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (v[j]) *p[j] = 0;
  }
}

// The sets of `rated` that survive the chunk, in rows [lo, hi); after
// clear_rated and a barrier.
__device__ void set_rated(uint8_t* rated, int I, int64_t lo, int64_t hi,
                          const Bucket& b, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int64_t r = b.us[e];
    if (b.ev_u[e] < 0 || r < lo || r >= hi || !set_survives(b, e)) continue;
    rated[r * I + b.is[e]] = 1;
  }
}

// The bookkeeping, by each slot's last writer: id, freq (1 after the
// slot's last new tenant, else the chunk-start freq plus the events) and
// timestamp (the clock at the writer). CTA 0 only.
__device__ void write_tables(const Bucket& b, int n, int* uid, int* iid,
                             int* ufq, int* ifq, int* uts, int* its,
                             int* clk) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int clk0 = b.counts[3];
  for (int x = tid; x < 2 * n; x += nt) {
    const bool item = x >= n;
    const int e = item ? x - n : x;
    const int* flag = item ? b.iflag : b.uflag;
    if (!(flag[e] & kLast)) continue;
    const int* prev = item ? b.pi : b.pu;
    int count = 0, f = e, freq;
    while (true) {
      ++count;
      if (flag[f] & kNew) {
        freq = count;
        break;
      }
      f = prev[f];
      if (f < 0) {
        freq = (item ? b.fi0 : b.fu0)[(item ? b.li : b.lu)[e]] + count;
        break;
      }
    }
    int clock = clk0;
    for (int g = 0; g <= e; ++g) clock += b.ev_u[g] >= 0;
    const int s = item ? b.is[e] : b.us[e];
    (item ? iid : uid)[s] = item ? b.ev_i[e] : b.ev_u[e];
    (item ? ifq : ufq)[s] = freq;
    (item ? its : uts)[s] = clock;
  }
  if (tid == 0) {
    int clock = clk0;
    for (int g = 0; g < n; ++g) clock += b.ev_u[g] >= 0;
    clk[0] = clock;
  }
}

}  // namespace
