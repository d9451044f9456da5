#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` (``PATH`` or ``/usr/local/cuda``) and the
repository checkout around this file; imports no jax and nothing of the
JAX package. Phases, each printing one JSON line:

  1. device and build: the card, ``nvidia-smi``'s name and power limit,
     and the three kernels built from ``src/repro_torch/kernels/csrc``
     into ``build/repro_torch_kernels/`` with ptxas's registers / smem;
  2. main path at deployment size: ``run_stream`` (backend ``"cuda"``)
     over ``synth_stream(MOVIELENS_25M)`` on a 4 x 4 grid with tables
     that hold each column's users and each split's items without
     collisions (the ``rated`` tables alone are 4.2 GB); launch counts
     are zeroed just before and read just after;
     then its first 64 micro-batches again under ``torch.profiler``
     for the device busy share and the kernel time by name;
  3. serving: ``grid_topn`` for 8,192 stream users in calls of 1,024,
     against the plain path (``use_kernel=False``);
  4. kernels against their plain versions on the main path's shapes: a
     real micro-batch from the middle of the stream on the trained
     state (one event in ten given an unseen id, so evictions run) for
     ``factor_update`` (both modes) and ``masked_scores``; the serving
     inputs for ``fused_topn``; each timed beside its plain version and
     a PyTorch library call, with its bound;
  5. the ``cuda`` and ``scan`` backends agree on the card on a smaller
     stream with slot collisions.

Then the kernels line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero before
the last line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 rate and f32 rate
# outside the tensor cores. The kernels here do f32 FMAs on CUDA cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# Main-path configuration: MovieLens-25M's Table 1 statistics, the
# README's 4 x 4 grid (16 workers), caps that fit each user column
# (155,002 / 4 users) and item split (27,133 / 4 items) without collisions.
N_I = 4
U_CAP, I_CAP = 38_912, 6_784
MICRO_BATCH = 2048
SERVE_USERS, SERVE_BATCH = 8192, 1024
DEVICE = "cuda"

# Tolerances. Kernels and plain versions sum the k = 10 products in other
# orders (nvcc contracts to FMAs): a few f32 ulp per score or update.
RTOL, ATOL = 1e-5, 1e-6
# Whole-stream backend comparison: the same rounding differences compound
# over every SGD step a vector takes.
STREAM_RTOL, STREAM_ATOL = 1e-4, 1e-5
# Ids are compared wherever neighbouring scores are further apart.
SCORE_GAP = 1e-4


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def main():
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi}

    # -- 1. device and build ------------------------------------------------
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    infos = build.build_all(force=True)
    build_s = time.perf_counter() - t0
    emit("build", **card, seconds=round(build_s, 3), kernels={
        n: {"nvcc_s": round(b.seconds, 3), **_ptxas(b.ptxas)}
        for n, b in infos.items()})

    # -- 2. main path at deployment size ------------------------------------
    import numpy as np
    import repro_torch as rt
    from repro_torch.data.stream import MOVIELENS_25M, synth_stream
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    users, items, _ = synth_stream(MOVIELENS_25M, seed=0)
    gen_s = time.perf_counter() - t0
    n = int(users.size)
    hyper = rt.DisgdHyper(k=10, u_cap=U_CAP, i_cap=I_CAP, top_n=10)
    grid = rt.GridSpec(n_i=N_I)
    cfg = rt.StreamConfig(grid=grid, micro_batch=MICRO_BATCH,
                          capacity_factor=2.0, hyper=hyper, backend="cuda",
                          device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = rt.run_stream(users, items, cfg)
    main_counts = ops.launch_counts()
    steps = math.ceil(n / MICRO_BATCH) + math.ceil(MICRO_BATCH / cfg.bucket_capacity)
    if res.events_processed + res.dropped != n:
        fail(f"events_processed {res.events_processed} + dropped "
             f"{res.dropped} != {n}")
    for name in ("factor_update", "masked_scores"):
        if main_counts[name] != steps:
            fail(f"{name} launched {main_counts[name]} times on the main "
                 f"path, expected one per step ({steps})")
    emit("main_path", stream="synth_stream(MOVIELENS_25M, seed=0)", events=n,
         cut=None, generate_s=round(gen_s, 3), grid=[grid.n_i, grid.g],
         u_cap=U_CAP, i_cap=I_CAP, micro_batch=MICRO_BATCH,
         bucket_capacity=cfg.bucket_capacity, steps=steps,
         wall_s=res.wall_seconds, events_per_s=res.throughput,
         recall_at_10=res.recall.mean(),
         events_processed=res.events_processed, dropped=res.dropped,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=main_counts)
    states = res.final_states
    _profile_steps(torch, rt, users, items, cfg, steps=64)

    # -- 3. serving ----------------------------------------------------------
    from repro_torch.serve.plane import query_capacity

    rng = np.random.default_rng(0)
    queries = rng.choice(np.unique(users), SERVE_USERS, replace=False)
    qcap = query_capacity(SERVE_BATCH, grid.g)
    kw = dict(algorithm="disgd", grid=grid, top_n=hyper.top_n, u_cap=U_CAP,
              qcap=qcap)
    batches = [torch.as_tensor(queries[s:s + SERVE_BATCH], dtype=torch.int32,
                               device=dev)
               for s in range(0, SERVE_USERS, SERVE_BATCH)]
    rt.grid_topn(states, batches[0], **kw)          # warm the allocator
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    lat, outs = [], []
    for q in batches:
        t0 = time.perf_counter()
        out = rt.grid_topn(states, q, **kw)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        outs.append(out)
    serve_counts = ops.launch_counts()
    if serve_counts["fused_topn"] != len(batches):
        fail(f"fused_topn launched {serve_counts['fused_topn']} times for "
             f"{len(batches)} serve calls")
    mismatched = 0
    for q, (ids, sc, known, served) in zip(batches, outs):
        p_ids, p_sc, p_known, p_served = rt.grid_topn(
            states, q, use_kernel=False, **kw)
        _close(sc, p_sc, "serve scores")
        mismatched += _ids_mismatch(ids, p_ids, p_sc)
        if not (torch.equal(known, p_known) and torch.equal(served, p_served)):
            fail("serve known/served differ from the plain path")
    if mismatched:
        fail(f"{mismatched} served ids differ from the plain path away "
             "from score ties")
    served = sum(int(o[3].sum()) for o in outs)
    emit("serve", queries=SERVE_USERS, batch=SERVE_BATCH, qcap=qcap,
         served=served, qps=served / sum(lat),
         p50_ms=1e3 * statistics.median(lat), max_ms=1e3 * max(lat),
         known=sum(int(o[2].sum()) for o in outs), launches=serve_counts)

    # -- 4. kernels against their plain versions -----------------------------
    kernels = _kernel_checks(torch, np, rt, users, items, states, cfg,
                             batches[0], qcap, main_counts, serve_counts)
    del states, res

    # -- 5. backends agree on the card ---------------------------------------
    _backends_agree(torch, np, rt)

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["kind"], "count": card["count"]}}))


def _profile_steps(torch, rt, users, items, cfg, steps: int):
    """Where the time goes: the first ``steps`` micro-batches of the main
    path again, under ``torch.profiler`` (device activity only, so the
    host loop is not slowed by CPU-side recording). Device busy share =
    summed kernel time / the loop's wall time."""
    from torch.profiler import ProfilerActivity, profile

    n = steps * cfg.micro_batch
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = rt.run_stream(users[:n], items[:n], cfg)
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    events = int(min(n, users.size))
    total_steps = (math.ceil(events / cfg.micro_batch)
                   + math.ceil(cfg.micro_batch / cfg.bucket_capacity))
    emit("profile", steps=total_steps, events=events,
         wall_ms=1e3 * res.wall_seconds,
         wall_ms_per_step=1e3 * res.wall_seconds / total_steps,
         device_busy_ms=busy_ms,
         device_busy_share=busy_ms / (1e3 * res.wall_seconds),
         top=[{"kernel": k[:90], "ms": us / 1e3, "count": c}
              for us, c, k in rows[:10]])


def _ptxas(log: str) -> dict:
    regs = re.search(r"Used (\d+) registers", log)
    smem = re.search(r"(\d+) bytes smem", log)
    stack = re.search(r"(\d+) bytes stack frame", log)
    return {"registers": int(regs.group(1)) if regs else None,
            "smem_bytes": int(smem.group(1)) if smem else 0,
            "stack_bytes": int(stack.group(1)) if stack else 0}


def _close(got, want, what):
    import torch

    g, w = got.float(), want.float()
    if not torch.equal(torch.isneginf(g), torch.isneginf(w)):
        fail(f"{what}: -inf pattern differs")
    fin = torch.isfinite(w)
    if not torch.allclose(g[fin], w[fin], rtol=RTOL, atol=ATOL):
        err = (g[fin] - w[fin]).abs().max().item()
        fail(f"{what}: max abs error {err} beyond rtol={RTOL} atol={ATOL}")
    return (g[fin] - w[fin]).abs().max().item() if fin.any() else 0.0


def _ids_mismatch(ids, want_ids, want_sc) -> int:
    """Count id mismatches where the plain list's neighbouring scores are
    more than SCORE_GAP apart (or exactly tied: then ids break the tie)."""
    import torch

    gap = (want_sc[..., 1:] - want_sc[..., :-1]).abs()
    tied = (want_sc[..., 1:] == want_sc[..., :-1])
    near = ~((gap > SCORE_GAP) | tied)
    sep = torch.ones_like(want_sc, dtype=torch.bool)
    sep[..., 1:] &= ~near
    sep[..., :-1] &= ~near
    return int((ids != want_ids)[sep].sum())


def _time_ms(torch, fn, reps=20, setup=None) -> float:
    """Median ms of ``fn`` by CUDA events, after one warm-up call;
    ``setup`` runs outside the timed region before every call."""
    times = []
    for r in range(reps + 1):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if r:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound_ms(n_bytes: float, flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _middle_batch(torch, np, users, items, cfg, rng):
    """One micro-batch from the middle of the stream, bucketed as the
    engine buckets it, with one event in ten given an unseen id."""
    from repro_torch.core import routing

    n = users.size
    lo = (n // 2) // cfg.micro_batch * cfg.micro_batch
    bu = users[lo:lo + cfg.micro_batch].copy()
    bi = items[lo:lo + cfg.micro_batch].copy()
    fresh = rng.random(bu.size) < 0.1
    # Unseen ids on the same worker and the same slot as the ids they
    # replace (the shift is a multiple of the grid and of slots * stride),
    # so the slots' tenants are evicted.
    hyper = cfg.resolved_hyper()
    bu[fresh] += cfg.grid.g * hyper.u_cap
    bi[fresh] += cfg.grid.n_i * hyper.i_cap
    dev = torch.device(cfg.device)
    bu_t = torch.as_tensor(bu, dtype=torch.int32, device=dev)
    bi_t = torch.as_tensor(bi, dtype=torch.int32, device=dev)
    g, n_i = cfg.grid.g, cfg.grid.n_i
    keys = (bi_t % n_i) * g + (bu_t % g)
    buckets, _, _ = routing.bucket_dispatch(keys, cfg.grid.n_c,
                                            cfg.bucket_capacity)
    src = buckets.clamp(min=0).long()
    ev_u = torch.where(buckets >= 0, bu_t[src], -1).contiguous()
    ev_i = torch.where(buckets >= 0, bi_t[src], -1).contiguous()
    return ev_u, ev_i


def _clone(state):
    from repro_torch.core.state import DisgdState, Tables

    return DisgdState(Tables(*(t.clone() for t in state.tables)),
                      state.user_vecs.clone(), state.item_vecs.clone(),
                      state.rated.clone())


def _touched_bytes(np, st_ids, ev_u, ev_i, u_slot, i_slot, u_cap, i_cap, k):
    """Bytes factor_update must move for this batch: its event inputs
    read once, and every table entry it touches read and written once
    (vectors, bookkeeping, the rated row / column cleared on a new
    tenant). Replays the slot tenancy event by event."""
    uid, iid = (x.cpu().numpy() for x in st_ids)
    ev_u, ev_i, u_slot, i_slot = (x.cpu().numpy() for x in
                                  (ev_u, ev_i, u_slot, i_slot))
    n_w, n_ev = ev_u.shape
    total = n_w * n_ev * (4 * 4 + 2 * k * 4)        # ids, slots, inits
    for w in range(n_w):
        u_ten, i_ten = {}, {}
        for e in range(n_ev):
            if ev_u[w, e] < 0:
                continue
            us, is_ = int(u_slot[w, e]), int(i_slot[w, e])
            new_u = u_ten.get(us, uid[w, us]) != ev_u[w, e]
            new_i = i_ten.get(is_, iid[w, is_]) != ev_i[w, e]
            u_ten[us], i_ten[is_] = ev_u[w, e], ev_i[w, e]
            total += 2 * (2 * k * 4 + 6 * 4) + 1      # vectors, tables, (u,i)
            total += u_cap * new_i + i_cap * new_u    # evictions
    return total


def _kernel_checks(torch, np, rt, users, items, states, cfg, serve_q, qcap,
                   main_counts, serve_counts):
    from repro_torch.core import disgd, prng, serve, state as state_lib
    from repro_torch.kernels import ops, ref

    hyper = cfg.resolved_hyper()
    k = hyper.k
    rng = np.random.default_rng(1)
    ev_u, ev_i = _middle_batch(torch, np, users, items, cfg, rng)
    n_w, cap = ev_u.shape
    t = states.tables
    u_slot = state_lib.slot_of(ev_u, hyper.g, hyper.u_cap)
    i_slot = state_lib.slot_of(ev_i, hyper.n_i, hyper.i_cap)
    key = prng.key(cfg.seed, device=ev_u.device)
    init = disgd.init_vector(key, torch.cat([ev_u, ev_i], 1), k,
                             hyper.init_scale)
    init_u, init_i = init[:, :cap].contiguous(), init[:, cap:].contiguous()
    rows = []

    # K1 factor_update, both modes, on clones of the trained state.
    n_bytes = _touched_bytes(np, (t.user_ids, t.item_ids), ev_u, ev_i, u_slot,
                             i_slot, hyper.u_cap, hyper.i_cap, k)
    n_valid = int((ev_u >= 0).sum())
    j_slot = torch.as_tensor(rng.integers(0, hyper.i_cap, (n_w, cap)),
                             dtype=torch.int32, device=ev_u.device)
    k1 = {}
    for pairwise in (False, True):
        events = (ev_u, ev_i, u_slot, i_slot, j_slot if pairwise else None,
                  init_u, init_i)
        work = {}

        def run(fn, name):
            s = work[name]
            fn(s.user_vecs, s.item_vecs, s.rated, tuple(s.tables), events,
               eta=hyper.eta, lam=hyper.lam)

        results = {}
        for name, fn in (("kernel", ops.factor_update),
                         ("plain", ref.factor_apply)):
            work[name] = _clone(states)
            run(fn, name)
            torch.cuda.synchronize()
            results[name] = work.pop(name)
        got, want = results["kernel"], results["plain"]
        for a, b, what in zip(got.tables, want.tables,
                              state_lib.Tables._fields):
            if not torch.equal(a, b):
                fail(f"factor_update (pairwise={pairwise}): {what} differs")
        if not torch.equal(got.rated, want.rated):
            fail(f"factor_update (pairwise={pairwise}): rated differs")
        err = max(_close(got.user_vecs, want.user_vecs, "factor_update u"),
                  _close(got.item_vecs, want.item_vecs, "factor_update i"))
        del got, want, results

        def fresh(name):
            def setup():
                work[name] = _clone(states)
            return setup

        ms = _time_ms(torch, lambda: run(ops.factor_update, "kernel"),
                      reps=5, setup=fresh("kernel"))
        plain_ms = _time_ms(torch, lambda: run(ref.factor_apply, "plain"),
                            reps=2, setup=fresh("plain"))
        work.clear()
        k1["pairwise" if pairwise else "isgd"] = (err, ms, plain_ms)
    bound, by = _bound_ms(n_bytes, 12 * k * n_valid)
    err, ms, plain_ms = k1["isgd"]
    p_err, p_ms, p_plain_ms = k1["pairwise"]
    rows.append(dict(
        name="factor_update", route="cuda", matched=True,
        source="src/repro_torch/kernels/csrc/factor_update.cu",
        replaces="src/repro/kernels/factor_update.py:41",
        launches=main_counts["factor_update"], max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
        pairwise={"max_abs_err": p_err, "ms": p_ms, "plain_ms": p_plain_ms},
        shape=f"W={n_w} E={cap} U={hyper.u_cap} I={hyper.i_cap} k={k}",
        valid_events=n_valid))

    # K2 masked_scores on the same micro-batch, as the cuda worker builds it.
    w = torch.arange(n_w, device=ev_u.device)[:, None]
    us = u_slot.long()
    known_u = t.user_ids.gather(1, us) == ev_u
    u_vecs = torch.where(known_u[..., None], states.user_vecs[w, us], init_u)
    cand = ((t.item_ids >= 0)[:, None, :] & ~(states.rated[w, us]
                                              & known_u[..., None])
            & (ev_u >= 0)[..., None])
    got = ops.masked_scores(u_vecs, states.item_vecs, cand)
    want = ref.masked_scores(u_vecs, states.item_vecs, cand)
    err = _close(got, want, "masked_scores")
    b, i = cand.shape[1], cand.shape[2]
    ms = _time_ms(torch, lambda: ops.masked_scores(u_vecs, states.item_vecs,
                                                   cand))
    plain_ms = _time_ms(torch, lambda: ref.masked_scores(
        u_vecs, states.item_vecs, cand))
    not_cand = ~cand
    it_t = states.item_vecs.transpose(1, 2)
    buf = torch.empty_like(got)
    lib_ms = _time_ms(torch, lambda: torch.baddbmm(
        buf, u_vecs, it_t, beta=0).masked_fill_(not_cand, float("-inf")))
    bound, by = _bound_ms(4 * n_w * (b * k + i * k) + 5 * n_w * b * i,
                          2 * n_w * b * i * k)
    rows.append(dict(
        name="masked_scores", route="cuda", matched=True,
        source="src/repro_torch/kernels/csrc/masked_scores.cu",
        replaces="src/repro/kernels/scoring.py:32",
        launches=main_counts["masked_scores"], max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=lib_ms,
        shape=f"W={n_w} B={b} I={i} k={k}"))
    del got, want, cand, not_cand, buf

    # K3 fused_topn on the serving inputs of one grid_topn call.
    from repro_torch.core import routing

    g, n_i = cfg.grid.g, cfg.grid.n_i
    col = torch.where(serve_q >= 0, serve_q % g, g)
    buckets, _, _ = routing.bucket_dispatch(col, g, qcap)
    qu = torch.where(buckets >= 0, serve_q[buckets.clamp(min=0).long()], -1)
    qu = qu.repeat(n_i, 1)
    sv, mask, _ = serve._gather_queries(states, qu, g, hyper.u_cap)
    ids = t.item_ids
    got_ids, got_sc = ops.fused_topn(sv, states.item_vecs, mask, ids,
                                     top_n=hyper.top_n)
    want_ids, want_sc = ref.fused_topn(sv, states.item_vecs, mask, ids,
                                       hyper.top_n)
    err = _close(got_sc, want_sc, "fused_topn scores")
    bad = _ids_mismatch(got_ids, want_ids, want_sc)
    if bad:
        fail(f"fused_topn: {bad} ids differ away from score ties")
    b = mask.shape[1]
    ms = _time_ms(torch, lambda: ops.fused_topn(
        sv, states.item_vecs, mask, ids, top_n=hyper.top_n))
    plain_ms = _time_ms(torch, lambda: ref.fused_topn(
        sv, states.item_vecs, mask, ids, hyper.top_n), reps=5)
    not_mask = ~mask
    buf = torch.empty(mask.shape, device=sv.device)
    lib_ms = _time_ms(torch, lambda: torch.topk(torch.baddbmm(
        buf, sv, states.item_vecs.transpose(1, 2), beta=0)
        .masked_fill_(not_mask, float("-inf")), hyper.top_n, dim=-1))
    bound, by = _bound_ms(
        4 * n_w * (b * k + i * k + i) + n_w * b * i + 8 * n_w * b * hyper.top_n,
        2 * n_w * b * i * k)
    rows.append(dict(
        name="fused_topn", route="cuda", matched=True,
        source="src/repro_torch/kernels/csrc/fused_topn.cu",
        replaces="src/repro/kernels/topn.py:73",
        launches=serve_counts["fused_topn"], max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=lib_ms,
        shape=f"W={n_w} B={b} I={i} k={k} N={hyper.top_n}"))
    emit("kernels_vs_plain", matched=[r["name"] for r in rows],
         rtol=RTOL, atol=ATOL, score_gap=SCORE_GAP)
    return rows


def _backends_agree(torch, np, rt):
    from repro_torch.core import convert
    from repro_torch.data.stream import MOVIELENS_25M, scaled, synth_stream

    users, items, _ = synth_stream(scaled(MOVIELENS_25M, 0.01), seed=0)
    # ~387 users per column and ~68 items per split: both tables collide.
    hyper = rt.DisgdHyper(u_cap=64, i_cap=16)
    cfg = rt.StreamConfig(grid=rt.GridSpec(n_i=N_I), micro_batch=MICRO_BATCH,
                          hyper=hyper, backend="cuda", device=DEVICE)
    a = rt.run_stream(users, items, cfg)
    b = rt.run_stream(users, items, dataclasses.replace(cfg, backend="scan"))
    if (a.events_processed, a.dropped) != (b.events_processed, b.dropped):
        fail("cuda and scan backends processed / dropped different counts")
    sa, sb = convert.states_to_numpy(a.final_states), \
        convert.states_to_numpy(b.final_states)
    err = 0.0
    for name in sa:
        if sa[name].dtype.kind == "f":
            if not np.allclose(sa[name], sb[name], rtol=STREAM_RTOL,
                               atol=STREAM_ATOL):
                fail(f"backends: {name} beyond rtol={STREAM_RTOL} "
                     f"atol={STREAM_ATOL}")
            err = max(err, float(np.abs(sa[name] - sb[name]).max()))
        elif not np.array_equal(sa[name], sb[name]):
            fail(f"backends: {name} differs")
    emit("backends_agree", stream="synth_stream(scaled(MOVIELENS_25M, 0.01))",
         events=int(users.size), u_cap=hyper.u_cap, i_cap=hyper.i_cap,
         max_abs_err=err, rtol=STREAM_RTOL, atol=STREAM_ATOL,
         cuda_wall_s=a.wall_seconds, scan_wall_s=b.wall_seconds,
         recall_cuda=a.recall.mean(), recall_scan=b.recall.mean())


if __name__ == "__main__":
    main()
