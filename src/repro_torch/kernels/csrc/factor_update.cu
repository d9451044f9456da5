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
// ISGD mode (the DISGD path), csrc/bucket_stage.cuh's design: one cluster
// of kBucketCtas CTAs per worker, one launch per step. Every CTA stages
// the bucket and works out the tenancy, clears and last writers in shared
// memory; CTA 0 also stages the touched factor rows and the init vectors
// and replays the SGD chain in one warp (lane f holds feature f, the step
// is csrc/sgd_step.cuh's, as in isgd_update.cu, so the arithmetic is the
// chain's own), while every other warp of the cluster clears `rated` in
// the rows its CTA owns. Then CTA 0 writes each touched row and table
// entry once, and each CTA writes the surviving sets of its rows. The
// chain reads no `rated`, so `rated` needs only the write-back rule of
// bucket_stage.cuh, and the tables and `rated` equal the plain version
// exactly. What bounds it: the replay is a few dozen cycles an event in
// shared memory, so the bytes do: a column clear reads one byte in each
// of the U rows per evicted item slot, spread over the cluster.
//
// Pairwise (BPR) mode reads the live rated[us, js] and iid[js] inside the
// chain, so it keeps the sequential design: one CTA per worker, events in
// order, every read and write in device memory, __syncthreads() between
// the column clear, the row clear and the writes and at the end of every
// event. BPR has no path yet; its redesign comes with its slice.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bucket_stage.cuh"
#include "sgd_step.cuh"

namespace {

__global__ void __cluster_dims__(kBucketCtas, 1, 1)
    __launch_bounds__(kBucketThreads) factor_update_isgd_kernel(
        float* uv, float* iv, uint8_t* rated, int* uid, int* iid, int* ufq,
        int* ifq, int* uts, int* its, int* clk, const int* ev_u,
        const int* ev_i, const int* u_slots, const int* i_slots,
        const float* init_u, const float* init_i, int U, int I, int K, int E,
        int ch, float eta, float lam) {
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
  init_u += w * E * K;
  init_i += w * E * K;

  extern __shared__ __align__(16) int smem[];
  Bucket b;
  float* urow = reinterpret_cast<float*>(carve(b, smem, ch));
  float* irow = urow + ch * K;  // rows at the slot's first event
  float* su = irow + ch * K;    // init vectors by event
  float* si = su + ch * K;
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
    }
    analyse_bucket(b, n, false);
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
        float u_new, i_new;
        isgd_step(u, it, eta, lam, u_new, i_new);
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

constexpr int kPairwiseThreads = 256;

__global__ void __launch_bounds__(kPairwiseThreads)
    factor_update_pairwise_kernel(
        float* uv, float* iv, uint8_t* rated, int* uid, int* iid, int* ufq,
        int* ifq, int* uts, int* its, int* clk, const int* ev_u,
        const int* ev_i, const int* u_slots, const int* i_slots,
        const int* j_slots, const float* init_u, const float* init_i, int U,
        int I, int K, int E, float eta, float lam) {
  const int64_t w = blockIdx.x;
  const int tid = threadIdx.x;
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
  j_slots += w * E;
  init_u += w * E * K;
  init_i += w * E * K;

  for (int e = 0; e < E; ++e) {
    const int u_id = ev_u[e];
    if (u_id < 0) continue;  // uniform over the block: no barrier skipped
    const int i_id = ev_i[e];
    const int us = u_slots[e];
    const int is = i_slots[e];
    // Both reads precede this event's writes (first barrier below).
    const bool new_u = uid[us] != u_id;
    const bool new_i = iid[is] != i_id;
    uint8_t* row = rated + (int64_t)us * I;

    if (new_i) {
      for (int r = tid; r < U; r += kPairwiseThreads)
        rated[(int64_t)r * I + is] = 0;
    }
    __syncthreads();
    if (new_u) {
      for (int c = tid; c < I; c += kPairwiseThreads) row[c] = 0;
    }
    __syncthreads();

    if (tid < 32) {
      const bool in_k = tid < K;
      float u = 0.f, it = 0.f;
      if (in_k) {
        u = new_u ? init_u[e * K + tid] : uv[us * K + tid];
        it = new_i ? init_i[e * K + tid] : iv[is * K + tid];
      }
      const int js = j_slots[e];
      const int neg_id = iid[js];
      const bool neg_ok =
          neg_id >= 0 && neg_id != i_id && js != is && row[js] == 0;
      const float j = in_k ? iv[js * K + tid] : 0.f;
      const float x = warp_sum(u * it) - warp_sum(u * j);
      const float s = 1.f / (1.f + expf(x));
      float u_new = u, i_new = it;
      if (neg_ok) {
        u_new = u + eta * (s * (it - j) - lam * u);
        i_new = it + eta * (s * u - lam * it);
        // j before i (never the same slot when neg_ok holds).
        if (in_k) iv[js * K + tid] = j + eta * (-s * u - lam * j);
      }
      if (in_k) {
        uv[us * K + tid] = u_new;
        iv[is * K + tid] = i_new;
      }
      if (tid == 0) {
        row[is] = 1;
        ufq[us] = new_u ? 1 : ufq[us] + 1;
        ifq[is] = new_i ? 1 : ifq[is] + 1;
        uid[us] = u_id;
        iid[is] = i_id;
        const int c = clk[0] + 1;
        uts[us] = c;
        its[is] = c;
        clk[0] = c;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// The staged launch's layout for a bucket of E events: CTAs per worker,
// events per staged chunk, dynamic shared memory bytes per CTA.
extern "C" void factor_update_layout(int E, int K, int* out) {
  const int extra = 16 * K;
  out[0] = kBucketCtas;
  out[1] = bucket_chunk(E, extra);
  out[2] = bucket_smem(out[1], extra);
}

extern "C" int factor_update_launch(
    void* uv, void* iv, void* rated, void* uid, void* iid, void* ufq,
    void* ifq, void* uts, void* its, void* clk, const void* ev_u,
    const void* ev_i, const void* u_slots, const void* i_slots,
    const void* j_slots, const void* init_u, const void* init_i, int W, int U,
    int I, int K, int E, float eta, float lam, int pairwise, void* stream) {
  if (W == 0 || E == 0) return 0;
  if (pairwise) {
    factor_update_pairwise_kernel<<<W, kPairwiseThreads, 0,
                                    (cudaStream_t)stream>>>(
        (float*)uv, (float*)iv, (uint8_t*)rated, (int*)uid, (int*)iid,
        (int*)ufq, (int*)ifq, (int*)uts, (int*)its, (int*)clk,
        (const int*)ev_u, (const int*)ev_i, (const int*)u_slots,
        (const int*)i_slots, (const int*)j_slots, (const float*)init_u,
        (const float*)init_i, U, I, K, E, eta, lam);
    return (int)cudaGetLastError();
  }
  const int extra = 16 * K;  // staged rows and init vectors
  const int ch = bucket_chunk(E, extra);
  if (ch == 0) return (int)cudaErrorInvalidValue;
  const int smem = bucket_smem(ch, extra);
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err =
      allow_dynamic_smem(factor_update_isgd_kernel, kSmemBudget, smem_set);
  if (err != cudaSuccess) return (int)err;
  factor_update_isgd_kernel<<<W * kBucketCtas, kBucketThreads, smem,
                              (cudaStream_t)stream>>>(
      (float*)uv, (float*)iv, (uint8_t*)rated, (int*)uid, (int*)iid,
      (int*)ufq, (int*)ifq, (int*)uts, (int*)its, (int*)clk,
      (const int*)ev_u, (const int*)ev_i, (const int*)u_slots,
      (const int*)i_slots, (const float*)init_u, (const float*)init_i, U, I,
      K, E, ch, eta, lam);
  return (int)cudaGetLastError();
}
