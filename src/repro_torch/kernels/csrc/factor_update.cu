// factor_update: the complete streaming factor-model micro-batch update.
//
// Replaces the Pallas TPU kernel src/repro/kernels/factor_update.py::
// factor_update_kernel (wrapper factor_update_pallas, pl.pallas_call at
// :166). Plain version: src/repro_torch/kernels/ref.py::factor_apply.
//
// Per event, in order, on one worker: gather-or-init the user and item
// vectors, apply the ISGD step (err = 1 - u.i) or, with `pairwise`, the
// BPR step whose negative slot is checked against the live tables
// (neg_ok), clear the evicted item's column of `rated`, clear the user's
// row if the user is new, set rated[u, i], and update freq/id/ts/clock.
// Padding events (u_id < 0) touch nothing.
//
// Both modes (the DISGD and the BPR-MF paths), csrc/bucket_stage.cuh's
// design: one cluster of kBucketCtas CTAs per worker, one launch per step.
// Every CTA stages the bucket and works out the tenancy, clears and last
// writers in shared memory; CTA 0 also stages the touched factor rows and
// the init vectors and replays the SGD chain in one warp (lane f holds
// feature f, the steps are csrc/sgd_step.cuh's, so the arithmetic is the
// sequential chain's own), while every other warp of the cluster clears
// `rated` in the rows its CTA owns. Then CTA 0 writes each touched row and
// table entry once, and each CTA writes the surviving sets of its rows.
// The chain reads no `rated`, so `rated` needs only the write-back rule of
// bucket_stage.cuh, and the tables and `rated` equal the plain version
// exactly.
//
// Pairwise mode reads two things the chain changes: the negative slot's
// tenant iid[js] and the byte rated[us, js]. Both are integers that the
// staged events determine, so CTA 0 works them out before the chain
// (stage_negatives, analyse_negatives): it gathers each valid event's
// iid[js] and rated[us, js] at chunk start, then replays them against the
// chunk's earlier events. The live tenant of js is the last earlier valid
// event's item on that slot, else the staged one. The live byte is 0 if
// the event's user is new (its row is cleared before it is read);
// otherwise the last of the earlier events' ops on the cell decides (a
// set of (us, js): 1; a clear of row us or column js: 0), else the staged
// byte. An event whose negative passes (neg_ok) links js to a staged row:
// the row of the slot's first i event where the chunk has one, so the i
// and j steps on a slot share it, else a j-only row after the i rows,
// written back at the end. The chain then steps u, i and j in order; an
// event whose negative fails writes u and i unchanged. j sets no byte and
// no table entry, so the write-back rules do not change.
//
// What bounds it: the replay is a few dozen cycles an event in shared
// memory, so the bytes do: a column clear reads one byte in each of the U
// rows per evicted item slot, spread over the cluster. The negatives'
// analysis compares each event with the chunk's earlier ones, a warp an
// event, 32 at a time by ballot, over CTA 0's 16 warps.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bucket_stage.cuh"
#include "sgd_step.cuh"

namespace {

// Pairwise mode's per-event arrays, each `ch` long, after the rows.
struct Negatives {
  int* js;    // the negative slot
  int* jt0;   // iid[js] at chunk start
  int* jb;    // rated[us, js] at chunk start
  int* jok;   // 1: the negative passes (neg_ok), the pairwise step runs
  int* jrep;  // the staged row of js where jok, else -1
  int* jw;    // 1: the j-only row at this event's index is written back
};
constexpr int kNegInts = 6;

// Shared-memory bytes an event takes beyond the Bucket arrays: the rows
// (user, item, pairwise also the j-only item rows) and the init vectors,
// then Negatives.
__host__ __device__ constexpr int factor_extra(int K, bool pairwise) {
  return pairwise ? 20 * K + 4 * kNegInts : 16 * K;
}

constexpr unsigned kFull = 0xffffffffu;

// Each valid event's negative tenant and rated byte at chunk start (CTA
// 0, after stage_bucket, before any write of the chunk).
__device__ void stage_negatives(const Bucket& b, const Negatives& g, int n,
                                const int* j_slots, const int* iid,
                                const uint8_t* rated, int I) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int js = j_slots[e];
    g.js[e] = js;
    g.jw[e] = 0;
    if (b.ev_u[e] >= 0) {
      g.jt0[e] = iid[js];
      g.jb[e] = rated[(int64_t)b.us[e] * I + js];
    }
  }
}

// neg_ok of every valid event against the live tables, the staged row of
// each passing negative, and the j-only rows gathered (CTA 0, after
// analyse_bucket). One warp an event: its lanes take 32 earlier events at
// a time, latest first, and a ballot finds the latest that matters, so
// an event costs e / 32 steps, not e.
__device__ void analyse_negatives(const Bucket& b, const Negatives& g, int n,
                                  const float* iv, float* irow, int K) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, warps = nt >> 5;
  for (int e = warp; e < n; e += warps) {
    if (b.ev_u[e] < 0) {  // uniform over the warp
      if (lane == 0) g.jok[e] = 0;
      continue;
    }
    const int js = g.js[e], r = b.us[e];
    // The latest earlier valid i event on js (its tenant) and the latest
    // earlier op on the cell (us, js): a set (1), or a clear of row us or
    // column js (0). The event's own new user clears the row first.
    const bool own_clear = (b.uflag[e] & kNew) != 0;
    int tenant_at = -1, op_at = -1;
    for (int top = e - 1; top >= 0 && (tenant_at < 0 || (!own_clear &&
                                                         op_at < 0));
         top -= 32) {
      const int f = top - lane;
      const bool valid = f >= 0 && b.ev_u[f] >= 0;
      const bool col = valid && b.is[f] == js;
      const bool row = valid && b.us[f] == r;
      const bool op = (row && col) || (row && (b.uflag[f] & kNew)) ||
                      (col && (b.iflag[f] & kNew));
      const unsigned tm = __ballot_sync(kFull, col);
      const unsigned om = __ballot_sync(kFull, op);
      if (tenant_at < 0 && tm) tenant_at = top - (__ffs(tm) - 1);
      if (op_at < 0 && om) op_at = top - (__ffs(om) - 1);
    }
    if (lane == 0) {
      const int tenant = tenant_at >= 0 ? b.ev_i[tenant_at] : g.jt0[e];
      int byte = g.jb[e];
      if (own_clear) {
        byte = 0;
      } else if (op_at >= 0) {  // an event's set comes after its clears
        byte = b.us[op_at] == r && b.is[op_at] == js;
      }
      g.jok[e] = js != b.is[e] && tenant >= 0 && tenant != b.ev_i[e] &&
                 byte == 0;
    }
  }
  __syncthreads();
  // The slot's first valid i event holds its row; else the first event
  // whose pairwise step runs on it takes a j-only row.
  for (int e = warp; e < n; e += warps) {
    if (!g.jok[e]) {  // uniform over the warp
      if (lane == 0) g.jrep[e] = -1;
      continue;
    }
    const int js = g.js[e];
    int rep = -1;
    for (int base = 0; base < n && rep < 0; base += 32) {
      const int f = base + lane;
      const unsigned m = __ballot_sync(
          kFull, f < n && b.ev_u[f] >= 0 && b.is[f] == js);
      if (m) rep = base + __ffs(m) - 1;
    }
    for (int base = 0; base <= e && rep < 0; base += 32) {
      const int f = base + lane;
      const unsigned m =
          __ballot_sync(kFull, f <= e && g.jok[f] && g.js[f] == js);
      if (m) rep = n + base + __ffs(m) - 1;
    }
    if (lane == 0) {
      g.jrep[e] = rep;
      if (rep >= n) g.jw[rep - n] = 1;
    }
  }
  __syncthreads();
  for (int x = tid; x < n * K; x += nt) {
    const int f = x / K, k = x - f * K;
    if (g.jw[f]) irow[n * K + x] = iv[(int64_t)g.js[f] * K + k];
  }
}

template <bool kPair>
__device__ __forceinline__ void factor_update_body(
    float* uv, float* iv, uint8_t* rated, int* uid, int* iid, int* ufq,
    int* ifq, int* uts, int* its, int* clk, const int* ev_u,
    const int* ev_i, const int* u_slots, const int* i_slots,
    const int* j_slots, const float* init_u, const float* init_i, int U,
    int I, int K, int E, int ch, float eta, float lam) {
  const int rank = blockIdx.x % kBucketCtas;
  const int64_t w = blockIdx.x / kBucketCtas;
  const bool lead = rank == 0;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  uv += w * U * K;
  iv += w * I * K;
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
  if (kPair) j_slots += w * E;
  init_u += w * E * K;
  init_i += w * E * K;

  extern __shared__ __align__(16) int smem[];
  Bucket b;
  float* urow = reinterpret_cast<float*>(carve(b, smem, ch));
  float* irow = urow + ch * K;  // rows at the slot's first event
  float* su = irow + (kPair ? 2 : 1) * ch * K;  // init vectors by event
  float* si = su + ch * K;
  Negatives g{};
  if (kPair) {
    int* p = reinterpret_cast<int*>(si + ch * K);
    g = Negatives{p,          p + ch,     p + 2 * ch,
                  p + 3 * ch, p + 4 * ch, p + 5 * ch};
  }
  int64_t lo, hi;
  owned_rows(U, rank, lo, hi);

  for (int e0 = 0; e0 < E; e0 += ch) {
    const int n = min(ch, E - e0);
    stage_bucket(b, n, false, ev_u + e0, ev_i + e0, u_slots + e0,
                 i_slots + e0, uid, iid, ufq, ifq, clk, lead);
    if (lead) {
      for (int x = tid; x < n * K; x += nt) {
        const int e = x / K, f = x - e * K;
        su[x] = init_u[e0 * K + x];
        si[x] = init_i[e0 * K + x];
        if (b.lu[e] == e) urow[x] = uv[(int64_t)b.us[e] * K + f];
        if (b.li[e] == e) irow[x] = iv[(int64_t)b.is[e] * K + f];
      }
      if (kPair) stage_negatives(b, g, n, j_slots + e0, iid, rated, I);
    }
    analyse_bucket(b, n, false);
    if (kPair && lead) analyse_negatives(b, g, n, iv, irow, K);
    cluster_sync();

    if (lead && warp == 0) {  // the SGD chain, on the staged rows
      for (int e = 0; e < n; ++e) {
        if (b.ev_u[e] < 0) continue;  // uniform over the warp
        float* ur = urow + b.lu[e] * K;
        float* ir = irow + b.li[e] * K;
        float u = 0.f, it = 0.f;
        if (lane < K) {
          u = (b.uflag[e] & kNew) ? su[e * K + lane] : ur[lane];
          it = (b.iflag[e] & kNew) ? si[e * K + lane] : ir[lane];
        }
        float u_new = u, i_new = it;
        if (!kPair) {
          isgd_step(u, it, eta, lam, u_new, i_new);
        } else if (g.jrep[e] >= 0) {  // uniform over the warp
          float* jr = irow + g.jrep[e] * K;
          const float j = lane < K ? jr[lane] : 0.f;
          float j_new;
          bpr_step(u, it, j, eta, lam, u_new, i_new, j_new);
          if (lane < K) jr[lane] = j_new;  // another slot than i's
        }
        if (lane < K) {
          ur[lane] = u_new;
          ir[lane] = i_new;
        }
      }
    } else {
      clear_rated(rated, I, lo, hi, b, lead ? tid - 32 : tid,
                  lead ? nt - 32 : nt);
    }
    __syncthreads();

    if (lead) {
      for (int x = tid; x < n * K; x += nt) {
        const int e = x / K, f = x - e * K;
        if (b.lu[e] == e) uv[(int64_t)b.us[e] * K + f] = urow[x];
        if (b.li[e] == e) iv[(int64_t)b.is[e] * K + f] = irow[x];
        if (kPair && g.jw[e]) iv[(int64_t)g.js[e] * K + f] = irow[n * K + x];
      }
      write_tables(b, n, uid, iid, ufq, ifq, uts, its, clk);
    }
    set_rated(rated, I, lo, hi, b, n);
    if (e0 + ch < E) {
      __syncthreads();
      cluster_sync();
    }
  }
}

#define FACTOR_UPDATE_PARAMS                                                 \
  float *uv, float *iv, uint8_t *rated, int *uid, int *iid, int *ufq,        \
      int *ifq, int *uts, int *its, int *clk, const int *ev_u,               \
      const int *ev_i, const int *u_slots, const int *i_slots,               \
      const int *j_slots, const float *init_u, const float *init_i, int U,   \
      int I, int K, int E, int ch, float eta, float lam
#define FACTOR_UPDATE_ARGS                                                   \
  uv, iv, rated, uid, iid, ufq, ifq, uts, its, clk, ev_u, ev_i, u_slots,     \
      i_slots, j_slots, init_u, init_i, U, I, K, E, ch, eta, lam

__global__ void __cluster_dims__(kBucketCtas, 1, 1)
    __launch_bounds__(kBucketThreads)
        factor_update_isgd_kernel(FACTOR_UPDATE_PARAMS) {
  factor_update_body<false>(FACTOR_UPDATE_ARGS);
}

__global__ void __cluster_dims__(kBucketCtas, 1, 1)
    __launch_bounds__(kBucketThreads)
        factor_update_pairwise_kernel(FACTOR_UPDATE_PARAMS) {
  factor_update_body<true>(FACTOR_UPDATE_ARGS);
}

}  // namespace

// The launch's layout for a bucket of E events: CTAs per worker, events
// per staged chunk, dynamic shared memory bytes per CTA.
static void layout(int E, int K, bool pairwise, int* out) {
  const int extra = factor_extra(K, pairwise);
  out[0] = kBucketCtas;
  out[1] = bucket_chunk(E, extra);
  out[2] = bucket_smem(out[1], extra);
}

extern "C" void factor_update_layout(int E, int K, int* out) {
  layout(E, K, false, out);
}

extern "C" void factor_update_pairwise_layout(int E, int K, int* out) {
  layout(E, K, true, out);
}

extern "C" int factor_update_launch(
    void* uv, void* iv, void* rated, void* uid, void* iid, void* ufq,
    void* ifq, void* uts, void* its, void* clk, const void* ev_u,
    const void* ev_i, const void* u_slots, const void* i_slots,
    const void* j_slots, const void* init_u, const void* init_i, int W, int U,
    int I, int K, int E, float eta, float lam, int pairwise, void* stream) {
  if (W == 0 || E == 0) return 0;
  int lay[3];
  layout(E, K, pairwise != 0, lay);
  const int ch = lay[1], smem = lay[2];
  if (ch == 0) return (int)cudaErrorInvalidValue;
  static std::atomic<uint64_t> isgd_set{0}, pairwise_set{0};
  const cudaError_t err =
      pairwise ? allow_dynamic_smem(factor_update_pairwise_kernel,
                                    kSmemBudget, pairwise_set)
               : allow_dynamic_smem(factor_update_isgd_kernel, kSmemBudget,
                                    isgd_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(W * kBucketCtas);
  cudaStream_t st = (cudaStream_t)stream;
  float *fuv = (float*)uv, *fiv = (float*)iv;
  uint8_t* r8 = (uint8_t*)rated;
  int *iuid = (int*)uid, *iiid = (int*)iid, *iufq = (int*)ufq,
      *iifq = (int*)ifq, *iuts = (int*)uts, *iits = (int*)its,
      *iclk = (int*)clk;
  const int *eu = (const int*)ev_u, *ei = (const int*)ev_i,
            *us = (const int*)u_slots, *is = (const int*)i_slots,
            *js = (const int*)j_slots;
  const float *fu = (const float*)init_u, *fi = (const float*)init_i;
  if (pairwise) {
    factor_update_pairwise_kernel<<<grid, kBucketThreads, smem, st>>>(
        fuv, fiv, r8, iuid, iiid, iufq, iifq, iuts, iits, iclk, eu, ei, us,
        is, js, fu, fi, U, I, K, E, ch, eta, lam);
  } else {
    factor_update_isgd_kernel<<<grid, kBucketThreads, smem, st>>>(
        fuv, fiv, r8, iuid, iiid, iufq, iifq, iuts, iits, iclk, eu, ei, us,
        is, js, fu, fi, U, I, K, E, ch, eta, lam);
  }
  return (int)cudaGetLastError();
}
