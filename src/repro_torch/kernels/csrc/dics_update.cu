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
//      reference does — the rated row if new_u; if new_i the rated column
//      (strided over U), the co row and column and cnt;
//   3. valid events only: hist = rated[us, :] (after the clears) added to
//      the co row, then to the co column, which reads the row-updated
//      diagonal, so co[i, i] gains hist[i] twice; cnt[i] += 1; the
//      bookkeeping and clock; rated[us, is] = 1.
// `live` (a byte, may be null): when it is 0 the launch changes nothing,
// the device loop's counterpart of the JAX engine skipping a step with no
// events; it is read on the card, so the host never waits for it.
//
// What bounds it: latency. Events of one worker are a dependent chain, and
// each moves about 10 I bytes (the history row, the co row and the co
// column, the column a stride of 4 I bytes per element); a new item adds a
// U-long strided clear of the rated column. co and cnt hold integer counts
// in f32: every add is exact, and the fixed order of the phases (no
// atomics) keeps them equal to the plain version bit for bit.
//
// Design: one CTA per worker, events in order inside the CTA, the row,
// column and clear loops spread over the block. Thread t owns history
// index j = t, t + T, ... for both the row and the column add, so the
// diagonal's two adds are ordered by the thread itself. __syncthreads()
// separates the clears from the adds and the adds from the bookkeeping,
// and ends every event.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads) dics_update_kernel(
    float* co, float* cnt, uint8_t* rated, int* uid, int* iid, int* ufq,
    int* ifq, int* uts, int* its, int* clk, const int* ev_u, const int* ev_i,
    const int* u_slots, const int* i_slots, const uint8_t* live, int U,
    int I, int E) {
  if (live != nullptr && *live == 0) return;  // uniform over the grid
  const int64_t w = blockIdx.x;
  const int tid = threadIdx.x;
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

  for (int e = 0; e < E; ++e) {
    const int u_id = ev_u[e];
    const int i_id = ev_i[e];
    const int us = u_slots[e];
    const int is = i_slots[e];
    const bool valid = u_id >= 0;
    const bool new_u = uid[us] != u_id;
    const bool new_i = iid[is] != i_id;
    uint8_t* row = rated + (int64_t)us * I;
    float* co_row = co + (int64_t)is * I;
    // uid / iid are written only after two of this event's barriers, so
    // every thread has read them by then.

    // 2. clears, unguarded.
    if (new_u) {
      for (int c = tid; c < I; c += kThreads) row[c] = 0;
    }
    if (new_i) {
      for (int r = tid; r < U; r += kThreads) rated[(int64_t)r * I + is] = 0;
      for (int c = tid; c < I; c += kThreads) {
        co_row[c] = 0.f;
        co[(int64_t)c * I + is] = 0.f;
      }
      if (tid == 0) cnt[is] = 0.f;
    }
    if (!valid) {  // uniform over the block
      __syncthreads();
      continue;
    }
    __syncthreads();

    // 3. history into the co row, then the co column.
    for (int j = tid; j < I; j += kThreads) {
      if (row[j]) {
        co_row[j] = co_row[j] + 1.f;
        co[(int64_t)j * I + is] = co[(int64_t)j * I + is] + 1.f;
      }
    }
    __syncthreads();  // all history reads done before rated[us, is] = 1

    if (tid == 0) {
      cnt[is] = cnt[is] + 1.f;
      ufq[us] = new_u ? 1 : ufq[us] + 1;
      ifq[is] = new_i ? 1 : ifq[is] + 1;
      uid[us] = u_id;
      iid[is] = i_id;
      const int c = clk[0] + 1;
      uts[us] = c;
      its[is] = c;
      clk[0] = c;
      row[is] = 1;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int dics_update_launch(
    void* co, void* cnt, void* rated, void* uid, void* iid, void* ufq,
    void* ifq, void* uts, void* its, void* clk, const void* ev_u,
    const void* ev_i, const void* u_slots, const void* i_slots,
    const void* live, int W, int U, int I, int E, void* stream) {
  if (W == 0 || E == 0) return 0;
  dics_update_kernel<<<W, kThreads, 0, (cudaStream_t)stream>>>(
      (float*)co, (float*)cnt, (uint8_t*)rated, (int*)uid, (int*)iid,
      (int*)ufq, (int*)ifq, (int*)uts, (int*)its, (int*)clk,
      (const int*)ev_u, (const int*)ev_i, (const int*)u_slots,
      (const int*)i_slots, (const uint8_t*)live, U, I, E);
  return (int)cudaGetLastError();
}
