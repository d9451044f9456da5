"""Where a redesigned kernel's time goes: K1 ``factor_update`` (ISGD),
K2 ``masked_scores``, K3 ``fused_topn``, K4 ``dics_update``, K5
``dics_topn``, K6 ``isgd_update`` and K7 ``swa_attention`` of one or more
checkouts, timed on the card as built and with parts of their source cut
out.

    python3 tools/time_split.py [--root CHECKOUT ...] [--kernel NAME ...]

Each ``--root`` is a checkout of this repository (default: this one), so
two versions compare in one call on one card; ``--kernel`` picks the
kernels (default: all seven). A checkout's K1 and K4 follow one of two
designs, told apart by ``csrc/bucket_stage.cuh``: ``sequential`` (one CTA
per worker, events in order) or ``staged`` (that header's); its K7 one
of two, told apart by ``csrc/swa_attention.cu``: ``mma_sync`` (64-row
tiles loaded by the threads) or ``wgmma`` (a TMA-fed ring, wgmma, masks
on boundary tiles only); its K2 ``tiles`` (32 x 128 tiles staged in
shared memory) or ``strip`` (4 items a thread, a CTA walking rows); its
K5 ``per_query`` (one CTA per query) or ``query_group`` (one CTA per 8
queries, warp lists merged); its K3 ``row_warps`` (one warp per query
row, item tiles staged in shared memory) or ``lane_lists`` (one CTA per 8
queries, passes staged by cp.async, one lane-resident list a query in its
warp); its K6 ``one_warp`` (the events in order) or ``dataflow`` (a
staged chunk replayed by 32 warps as each event's previous ones finish).
Every cut variant of a picked kernel's design must find the text it
edits, or the run stops before anything is timed.
The variants are edited copies of the checkout's sources, built with
this checkout's ``build.nvcc_command`` into ``build/time_split/`` here; a
checkout's own kernels build where its package builds them.

Per checkout, in a process of its own. K1 / K4: ``chip_smoke.py``'s
DISGD and DICS paths trained at full size, then each kernel timed on
three batches made by ``chip_smoke._middle_batch``: ``fresh`` (one id in
ten unseen, the kernels line's batch), ``no_fresh`` (the stream's own
ids) and ``padding`` (every event padding); K1 also in pairwise mode on
``pairwise_fresh`` and ``pairwise_no_fresh`` (the same batches with the
kernels line's uniform random negative slots on the DISGD state, which a
checkout without BPR can run too). K1's design is ``staged_pairwise``
where both of its modes are staged (``factor_design``); its variants
then cut both modes, ``stage_only`` after the staging and analysis
(the negatives' included) and ``replay_only`` after the replay, without
the clears and write-back. K2 on the same trained DISGD
state and ``fresh`` batch, K5 on the trained DICS state and the first
serve call's queries: the kernels line's inputs
(``chip_smoke.kernel_batch`` / ``masked_scores_inputs`` /
``dics_topn_inputs``); with K5 also the checkout's DICS serve p50, the
median of SERVE_ROUNDS rounds of ``chip_smoke.serve_calls``. K3 on the
trained DISGD state and the first serve call's queries
(``chip_smoke.fused_topn_inputs``), with the checkout's DISGD serve p50
taken the same way; K6 on ``chip_smoke.isgd_cases`` (DISGD worker 0's
bucket; U 4,096, I 2,048, E 1,024 and 16,384, and 16,384 on one user
row), each beside its chain depth, on clones of the tables made once. K7:
h2o-danube-1.8b's layer 0 q / k / v for ``chip_smoke.py``'s four
8,192-token prompts (batch ``layer0``; the serving shape). Times are
``chip_smoke._time_ms(cover_enqueue=True)``, median of 7 (K1 / K4 on a
fresh clone of the state), the card's time without the host's enqueue,
and, as built, the profiler's device time. A variant's output is not
checked: its times are for the split only. One JSON line per kernel and
batch on stdout.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = Path("src/repro_torch/kernels/csrc")
OUT = ROOT / "build" / "time_split"

# Design -> [(variant, kernel, file under csrc/, [(text, replacement)])].
_SEQ_BOOK = """      cnt[is] = cnt[is] + 1.f;
      ufq[us] = new_u ? 1 : ufq[us] + 1;
      ifq[is] = new_i ? 1 : ifq[is] + 1;
      uid[us] = u_id;
      iid[is] = i_id;
      const int c = clk[0] + 1;
      uts[us] = c;
      its[is] = c;
      clk[0] = c;
      row[is] = 1;"""
_SEQ_COL = ("for (int r = tid; r < U; r += kThreads) "
            "rated[(int64_t)r * I + is] = 0;")
_STAGED_CLEAR = "                            const Bucket& b, int t, int nt) {"
_STAGED_START = "  const int rank = blockIdx.x % kBucketCtas;\n"
_STAGED_SYNC = "    analyse_bucket(b, n, {});\n    cluster_sync();\n"
_K1_SYNC = ("    if (kPair && lead) analyse_negatives(b, g, n, iv, irow, K);\n"
            "    cluster_sync();\n")
_K1_CLEARS = ("    } else {\n      clear_rated(rated, I, lo, hi, b, lead ? tid - 32 "
              ": tid,\n                  lead ? nt - 32 : nt);\n    }\n"
              "    __syncthreads();\n")
# K7, wgmma design: the consumers only wait for each tile and release it.
_K7_CONSUMER = "    asm volatile(\"setmaxnreg.inc.sync.aligned.u32 240;\\n\");\n"
_K7_LOADS_ONLY = """    if (n_tiles > 0) mbar_wait(bar.q, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % T::kStages, ph = (i / T::kStages) & 1;
      mbar_wait(&bar.k[s], ph);
      mbar_wait(&bar.v[s], ph);
      if (lane == 0) mbar_arrive(&bar.empty[s]);
    }
    if (n_tiles >= 0) return;
"""
# K2, strip design: the mask word of a row, its store, its FMAs.
_K2_VEC = "  const bool vec = aligned && i0 + kVec <= I;"
_K2_STORE = "        __stcs(reinterpret_cast<float4*>(out + row), o);"
_K2_NO_STORE = ("        if (o.x == 1234.5f && o.w == -1234.5f)\n"
                "          __stcs(reinterpret_cast<float4*>(out + row), o);")
_K2_FMA = ("          for (int v = 0; v < kVec; ++v) "
           "acc[v] = fmaf(uk, it[v][k], acc[v]);")
# K5, query_group design.
_K5_WORK = "  for (int x = 0; x < n_work; ++x) {"
_K5_MERGE = "  for (int x = warp; x < n_work; x += kWarps) {"
# K3, lane_lists design: the query offers, the mask test, the -inf list.
_K3_OFFER = ("      take_scores(lsc, lid, scores + warp * kSpan, pass_ids, N, "
             "lane);")
_K3_MASK = ("      if (__any_sync(kFull, mw[qb] != 0)) {  "
            "// the 4 chains side by side")
_K3_EMPTY = "      offer_items(e_sc, e_id, s, id, N, lane);"
_K3_ASYNC_MASK = ("  const bool async_mask =\n      I % 16 == 0 && "
                  "(reinterpret_cast<uintptr_t>(mask) & 15) == 0;",
                  "  const bool async_mask = false;")
VARIANTS = {
    "row_warps": [],
    "lane_lists": [
        ("no_offers", "fused_topn", "fused_topn.cu",
         [(_K3_OFFER, "      if (N < 0)\n  " + _K3_OFFER)]),
        # Scores never taken: the loads (items, ids, mask words), the
        # score tile and the -inf list alone.
        ("loads_only", "fused_topn", "fused_topn.cu",
         [(_K3_MASK, "      if (__any_sync(kFull, mw[qb] == 256u + N)) {")]),
        # The mask copied to shared memory by byte loads, not cp.async.
        ("byte_mask", "fused_topn", "fused_topn.cu", [_K3_ASYNC_MASK]),
        ("no_empty_list", "fused_topn", "fused_topn.cu",
         [(_K3_EMPTY, "      if (N < 0)\n  " + _K3_EMPTY)]),
        # Every pass staged by plain loads and stores, none ahead.
        ("sync_stage", "fused_topn", "fused_topn.cu",
         [("  const bool async_vec = (reinterpret_cast<uintptr_t>(items) & 15)"
           " == 0;", "  const bool async_vec = false;"),
          ("  const bool async_ids = (reinterpret_cast<uintptr_t>(ids) & 15) "
           "== 0;", "  const bool async_ids = false;"), _K3_ASYNC_MASK]),
        # 4 warps, 4 queries a CTA, 512 items a pass.
        ("group_4", "fused_topn", "fused_topn.cu",
         [("constexpr int kWarps = 8;", "constexpr int kWarps = 4;")]),
    ],
    "one_warp": [],
    "dataflow": [
        ("stage_only", "isgd_update", "isgd_update.cu",
         [("    replay_chunk(c, K, eta, lam, links);",
           "    if (E < 0) replay_chunk(c, K, eta, lam, links);")]),
        ("one_warp", "isgd_update", "isgd_update.cu",
         [("  return (int)((unsigned)slot % kWarps);", "  return 0;")]),
    ],
    "tiles": [],
    "strip": [
        ("scalar_mask", "masked_scores", "masked_scores.cu",
         [(_K2_VEC, "  const bool vec = false;")]),
        ("no_store", "masked_scores", "masked_scores.cu",
         [(_K2_STORE, _K2_NO_STORE)]),
        ("loads_only", "masked_scores", "masked_scores.cu",
         [(_K2_STORE, _K2_NO_STORE), (_K2_FMA, "")]),
        ("no_load_ahead", "masked_scores", "masked_scores.cu",
         [("constexpr int kBatch = 8;", "constexpr int kBatch = 1;")]),
        ("rows_8", "masked_scores", "masked_scores.cu",
         [("constexpr int kRowsPerCta = 16;",
           "constexpr int kRowsPerCta = 8;")]),
        ("rows_32", "masked_scores", "masked_scores.cu",
         [("constexpr int kRowsPerCta = 16;",
           "constexpr int kRowsPerCta = 32;")]),
    ],
    "per_query": [],
    "query_group": [
        ("no_merge", "dics_topn", "dics_topn.cu",
         [(_K5_MERGE, "  for (int x = warp; x < 0; x += kWarps) {")]),
        ("compaction_only", "dics_topn", "dics_topn.cu",
         [(_K5_WORK, "  for (int x = 0; x < 0; ++x) {"),
          (_K5_MERGE, "  for (int x = warp; x < 0; x += kWarps) {")]),
        ("runtime_lists", "dics_topn", "dics_topn.cu",
         [("#pragma unroll\n  for (int j = KCAP - 1; j > 0; --j) {",
           "#pragma unroll 1\n  for (int j = KCAP - 1; j > 0; --j) {")]),
        ("no_empty_item", "dics_topn", "dics_topn.cu",
         [("      if (n_hist[qb] > 0) {", "      if (true) {")]),
        ("no_load_batch", "dics_topn", "dics_topn.cu",
         [("constexpr int kLoads = 8; ", "constexpr int kLoads = 1; ")]),
        ("no_mass", "dics_topn", "dics_topn.cu",
         [("          s = neighbour_mass<KCAP>(", "          s = (float)id;\n"
           "          if (H < 0) s = neighbour_mass<KCAP>(")]),
        ("no_offers", "dics_topn", "dics_topn.cu",
         [("      offer(lsc, lid, s, id, N, lane);",
           "      if (s == 1.5f) offer(lsc, lid, s, id, N, lane);")]),
        ("group_2", "dics_topn", "dics_topn.cu",
         [("constexpr int kGroup = 8; ", "constexpr int kGroup = 2; ")]),
        ("group_4", "dics_topn", "dics_topn.cu",
         [("constexpr int kGroup = 8; ", "constexpr int kGroup = 4; ")]),
    ],
    "sequential": [
        ("no_column_clear", "factor_update", "factor_update.cu",
         [(_SEQ_COL, "")]),
        ("no_column_clear", "dics_update", "dics_update.cu",
         [(_SEQ_COL, "")]),
        ("no_rated_clears", "dics_update", "dics_update.cu", [
            (_SEQ_COL, ""),
            ("for (int c = tid; c < I; c += kThreads) row[c] = 0;", "")]),
        ("no_bookkeeping", "dics_update", "dics_update.cu",
         [(_SEQ_BOOK, "      row[is] = 1;")]),
    ],
    "staged": [
        *((variant, kernel, file, edits)
          for kernel, flag in (("factor_update", "false"),
                               ("dics_update", "true"))
          for variant, file, edits in (
              ("no_column_clear", "bucket_stage.cuh",
               [("  if (ncols == 0) return;", "  return;")]),
              ("no_rated_clears", "bucket_stage.cuh",
               [(_STAGED_CLEAR, _STAGED_CLEAR + "\n  if (I > 0) return;")]),
              ("empty", f"{kernel}.cu",
               [(_STAGED_START, "  if (E > 0) return;\n" + _STAGED_START)]),
              ("stage_only", f"{kernel}.cu",
               [(_STAGED_SYNC.format(flag),
                 _STAGED_SYNC.format(flag) + "    if (E > 0) return;\n")]))),
        ("no_replay", "factor_update", "factor_update.cu",
         [("        if (b.ev_u[e] < 0) continue;  // uniform over the warp",
           "        continue;")]),
        ("no_replay", "dics_update", "dics_update.cu",
         [("        for (int j = 0; j < min(32, n - base); ++j) {",
           "        for (int j = 0; j < 0; ++j) {")]),
        ("no_co_adds", "dics_update", "dics_update.cu",
         [("        if (b.ev_u[e] < 0 || b.cclr[b.li[e]] > e) continue;",
           "        continue;")]),
    ],
    # K1 with both modes staged: the staged design's K1 variants (the
    # staging and analysis of both modes, the negatives' included, end at
    # "stage_only"), and the chain without the clears and write-back.
    "staged_pairwise": [
        ("no_column_clear", "factor_update", "bucket_stage.cuh",
         [("  if (ncols == 0) return;", "  return;")]),
        ("no_rated_clears", "factor_update", "bucket_stage.cuh",
         [(_STAGED_CLEAR, _STAGED_CLEAR + "\n  if (I > 0) return;")]),
        ("empty", "factor_update", "factor_update.cu",
         [(_STAGED_START, "  if (E > 0) return;\n" + _STAGED_START)]),
        ("stage_only", "factor_update", "factor_update.cu",
         [(_K1_SYNC, _K1_SYNC + "    if (E > 0) return;\n")]),
        ("no_replay", "factor_update", "factor_update.cu",
         [("        if (b.ev_u[e] < 0) continue;  // uniform over the warp",
           "        continue;")]),
        ("replay_only", "factor_update", "factor_update.cu",
         [(_K1_CLEARS, "    }\n    __syncthreads();\n    if (E > 0) return;\n")]),
    ],
    "mma_sync": [
        ("no_mask", "swa_attention", "swa_attention.cu",
         [("s[n][e] = visible(r, c, S, window, causal) ? s[n][e] * scale "
           ": kNeg;", "s[n][e] = s[n][e] * scale;")]),
    ],
    "wgmma": [
        ("loads_only", "swa_attention", "swa_attention.cu",
         [(_K7_CONSUMER, _K7_CONSUMER + _K7_LOADS_ONLY)]),
        ("no_mask", "swa_attention", "swa_attention.cu",
         [("  return k1 < S && (!causal || k1 <= q0) && "
           "(window < 0 || k0 > q1 - window);", "  return true;")]),
        ("no_rescale", "swa_attention", "swa_attention.cu",
         [("      rescale(o0, o1, alpha);\n", "")]),
        ("no_softmax", "swa_attention", "swa_attention.cu",
         [("    float (&l)[2], float (&alpha)[2]) {\n  const int k0 = (lo + i) * BK;",
           "    float (&l)[2], float (&alpha)[2]) {\n  if (BK > 0) return;\n"
           "  const int k0 = (lo + i) * BK;")]),
        ("no_pv", "swa_attention", "swa_attention.cu",
         [("      pv_issue<D>(o0, o1, pa, smem_addr(smem + T::v_tile(s)));\n",
           "")]),
        # The design's two choices undone: exp2f for ex2.approx, and no
        # turns between the consumer warpgroups.
        ("exp2f", "swa_attention", "swa_attention.cu",
         [('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
           "  y = exp2f(x);")]),
        ("no_pingpong", "swa_attention", "swa_attention.cu",
         [("      if (wg == 1) turn_pass(wg);\n", ""),
          ("      turn_pass(wg);\n", ""),
          ("      if (wg == 0 || more) turn_pass(wg);\n", ""),
          ("      turn_wait(wg);\n      qk_issue", "      qk_issue"),
          ("      turn_wait(wg);\n      pv_issue", "      pv_issue")]),
    ],
}
KERNELS = ("factor_update", "masked_scores", "fused_topn", "dics_update",
           "dics_topn", "isgd_update", "swa_attention")
# Rounds of chip_smoke.py's 8 serve calls behind a checkout's serve p50.
SERVE_ROUNDS = 32
# The name the profiler gives each kernel's __global__ function.
PROFILE_KEY = {"factor_update": "factor_update_", "dics_update": "dics_update_",
               "masked_scores": "masked_scores_kernel",
               "fused_topn": "fused_topn_kernel",
               "dics_topn": "dics_topn_kernel",
               "isgd_update": "isgd_update_kernel",
               "swa_attention": "swa_bf16_kernel"}


def design(root: Path) -> str:
    """The design of the checkout's K1 (ISGD) and K4 kernels."""
    staged = (root / CSRC / "bucket_stage.cuh").exists()
    return "staged" if staged else "sequential"


def factor_design(root: Path) -> str:
    """The design of the checkout's K1: ``design``'s, or
    ``staged_pairwise`` where its pairwise mode is staged too."""
    src = root / CSRC / "factor_update.cu"
    if design(root) == "staged" and "analyse_negatives" in src.read_text():
        return "staged_pairwise"
    return design(root)


def swa_design(root: Path) -> str:
    """The design of the checkout's K7 bf16 kernel."""
    src = (root / CSRC / "swa_attention.cu").read_text()
    return "wgmma" if "wgmma.mma_async" in src else "mma_sync"


def scores_design(root: Path) -> str:
    """The design of the checkout's K2 kernel."""
    src = (root / CSRC / "masked_scores.cu").read_text()
    return "strip" if "kStrip" in src else "tiles"


def dics_topn_design(root: Path) -> str:
    """The design of the checkout's K5 kernel."""
    src = (root / CSRC / "dics_topn.cu").read_text()
    return "query_group" if "kGroup" in src else "per_query"


def fused_topn_design(root: Path) -> str:
    """The design of the checkout's K3 kernel."""
    src = (root / CSRC / "fused_topn.cu").read_text()
    return "lane_lists" if "kGroup" in src else "row_warps"


def isgd_design(root: Path) -> str:
    """The design of the checkout's K6 kernel."""
    src = (root / CSRC / "isgd_update.cu").read_text()
    return "dataflow" if "replay_chunk" in src else "one_warp"


def kernel_design(root: Path, kernel: str) -> str:
    return {"swa_attention": swa_design, "masked_scores": scores_design,
            "dics_topn": dics_topn_design, "fused_topn": fused_topn_design,
            "isgd_update": isgd_design,
            "factor_update": factor_design}.get(kernel, design)(root)


def variant_sources(root: Path, kernels=KERNELS
                    ) -> list[tuple[str, str, str, str]]:
    """(variant, kernel, file, edited text) for each cut variant of the
    designs of the checkout's ``kernels``; raises when a variant's text
    is not there."""
    out = []
    entries = [e for d in sorted({kernel_design(root, k) for k in kernels})
               for e in VARIANTS[d]
               if e[1] in kernels and kernel_design(root, e[1]) == d]
    for variant, kernel, file, edits in entries:
        src = (root / CSRC / file).read_text()
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"time_split: {kernel}.{variant}: "
                                 f"{root / CSRC / file} holds {old!r} "
                                 f"{src.count(old)} times, not once")
            src = src.replace(old, new)
        out.append((variant, kernel, file, src))
    return out


def build_variants(root: Path, tag: str, kernels=KERNELS
                   ) -> dict[str, dict[str, str]]:
    """Builds the checkout's variants, all nvcc processes at once;
    returns {kernel: {variant: library path}} (every picked kernel, with
    no variants where its design has none)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    libs = {k: {} for k in kernels}
    procs = []
    for variant, kernel, file, src in variant_sources(root, kernels):
        out = OUT / tag / f"{kernel}.{variant}"
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(root / CSRC, out)
        (out / file).write_text(src)
        lib = out / f"{kernel}.so"
        procs.append((lib, subprocess.Popen(
            build.nvcc_command(out / f"{kernel}.cu", lib),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        libs[kernel][variant] = str(lib)
    for lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"time_split: nvcc failed for {lib}:\n{log}")
    return libs


@contextlib.contextmanager
def _entry_of(ops, kernel: str, fn):
    """``ops`` launches ``fn`` for ``kernel`` inside the block."""
    real = ops._entry
    ops._entry = lambda name: fn if name == kernel else real(name)
    try:
        yield
    finally:
        ops._entry = real


def _run(root: Path, libs: dict[str, dict[str, str]]):
    sys.path[:0] = [str(root / "src"), str(ROOT)]
    import numpy as np
    import torch

    import chip_smoke as cs
    import repro_torch as rt
    from repro_torch.core import disgd, prng, state as state_lib
    from repro_torch.data.stream import MOVIELENS_25M, NETFLIX, synth_stream
    from repro_torch.kernels import build, ops

    if not torch.cuda.is_available():
        raise SystemExit("time_split: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    build.build_all(force=True)
    variants = {kernel: {} for kernel in libs}
    for kernel, paths in libs.items():
        for variant, path in paths.items():
            fn = getattr(ctypes.CDLL(path), f"{kernel}_launch")
            fn.argtypes = ops._ARGTYPES[kernel]
            fn.restype = ctypes.c_int
            variants[kernel][variant] = fn

    def time_ms(states, launch):
        if states is None:
            return cs._time_ms(torch, launch, reps=7, cover_enqueue=True)
        work = {}

        def setup():
            # A checkout older than state.clone_state: copy by hand.
            work["s"] = type(states)(
                type(states.tables)(*(t.clone() for t in states.tables)),
                *(None if t is None else t.clone() for t in states[1:]))

        return cs._time_ms(torch, lambda: launch(work["s"]), reps=7,
                           setup=setup, cover_enqueue=True)

    def device_ms(kernel, states, launch):
        """Mean device time of the kernel's launches, by the profiler."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time_ms(states, launch)
        rows = [e for e in prof.key_averages()
                if PROFILE_KEY[kernel] in e.key]
        us = sum(getattr(e, "self_device_time_total", 0) for e in rows)
        return us / 1e3 / max(1, sum(e.count for e in rows))

    def split(kernel, states, launch):
        ms = {"as_built": time_ms(states, launch),
              "as_built_device": device_ms(kernel, states, launch)}
        for variant, fn in variants[kernel].items():
            with _entry_of(ops, kernel, fn):
                ms[variant] = time_ms(states, launch)
        return {"root": str(root), "design": kernel_design(root, kernel),
                "card": card, "kernel": kernel, "ms": ms}

    def serve_p50_ms(states, cfg, batches, leaf):
        """``chip_smoke.py``'s phase ``serve`` or ``dics_serve`` (its
        calls and measure), SERVE_ROUNDS times over: the median wall ms
        of a ``grid_topn`` call, which launches ``leaf`` once."""
        lat, _, counts = cs.serve_calls(torch, rt, states, cs.serve_kw(cfg),
                                        batches, rounds=SERVE_ROUNDS)
        if counts[leaf] != len(lat):
            raise SystemExit(f"time_split: {leaf} launched {counts[leaf]} "
                             f"times in {len(lat)} serve calls")
        return 1e3 * statistics.median(lat)

    for kernel, leaves, cfg, profile in (
            ("factor_update", ("masked_scores", "fused_topn", "isgd_update"),
             cs.disgd_config(rt), MOVIELENS_25M),
            ("dics_update", ("dics_topn",), cs.dics_config(rt), NETFLIX)):
        if kernel not in libs and not set(leaves) & set(libs):
            continue
        users, items, _ = synth_stream(profile, seed=0)
        t0 = time.perf_counter()
        states = rt.run_stream(users, items, cfg).final_states
        train_s = time.perf_counter() - t0
        serve_q = cs.serve_batches(torch, np, users, torch.device("cuda"))
        if "fused_topn" in leaves and "fused_topn" in libs:
            args, kw = cs.fused_topn_inputs(torch, states, cfg, serve_q[0])
            n_cand = args[2].sum(-1)
            print(json.dumps({
                **split("fused_topn", None,
                        lambda: ops.fused_topn(*args, **kw)),
                "batch": "serve", "train_s": train_s,
                "serve_p50_ms": serve_p50_ms(states, cfg, serve_q,
                                             "fused_topn"),
                "shape": "W={} B={} I={} k={} N={top_n}".format(
                    *args[2].shape, args[0].shape[2], **kw),
                "rows_without_candidate": int((n_cand == 0).sum())}),
                flush=True)
        if "isgd_update" in leaves and "isgd_update" in libs:
            h = cfg.resolved_hyper()
            ev_u, _, u_slot, i_slot, _, _ = cs.kernel_batch(
                torch, np, users, items, cfg, np.random.default_rng(1))
            for case, (ut, it, us, is_, ok) in cs.isgd_cases(
                    torch, np, states, u_slot, i_slot, ev_u, h.k):
                ut, it = ut.clone(), it.clone()
                print(json.dumps({
                    **split("isgd_update", None,
                            lambda: ops.isgd_update(ut, it, us, is_, ok,
                                                    eta=h.eta, lam=h.lam)),
                    "batch": case, "train_s": train_s,
                    "shape": f"U={ut.shape[0]} I={it.shape[0]} "
                             f"E={us.numel()} k={ut.shape[1]}",
                    "valid": int(ok.sum()),
                    "chain_depth": cs.chain_depth(np, us, is_, ok,
                                                  ut.shape[0], it.shape[0])}),
                    flush=True)
        if "masked_scores" in leaves and "masked_scores" in libs:
            ev_u, _, u_slot, _, init_u, _ = cs.kernel_batch(
                torch, np, users, items, cfg, np.random.default_rng(1))
            args = cs.masked_scores_inputs(torch, states, ev_u, u_slot,
                                           init_u)
            print(json.dumps({
                **split("masked_scores", None,
                        lambda: ops.masked_scores(*args)),
                "batch": "fresh", "train_s": train_s,
                "shape": "W={} B={} I={} k={}".format(
                    *args[2].shape, args[0].shape[2])}), flush=True)
        if "dics_topn" in leaves and "dics_topn" in libs:
            args, kw = cs.dics_topn_inputs(torch, states, cfg, serve_q[0])
            hist = args[2]
            # The same call with its longest history cleared: that row's
            # share of the kernel.
            light = hist.clone()
            light.view(-1, hist.shape[-1])[hist.sum(-1).argmax()] = False
            print(json.dumps({
                **split("dics_topn", None,
                        lambda: ops.dics_topn(*args, **kw)),
                "ms_without_longest_history": time_ms(
                    None, lambda: ops.dics_topn(*args[:2], light, *args[3:],
                                                **kw)),
                "batch": "serve", "train_s": train_s,
                "serve_p50_ms": serve_p50_ms(states, cfg, serve_q,
                                             "dics_topn"),
                "shape": "W={} B={} I={} k_nn={k_nn} N={top_n}".format(
                    *hist.shape, **kw),
                "mean_history": float(hist.sum(-1).float().mean()),
                "max_history": int(hist.sum(-1).max())}), flush=True)
        if kernel not in libs:
            del states
            torch.cuda.empty_cache()
            continue
        h = cfg.resolved_hyper()
        batches = {name: cs._middle_batch(torch, np, users, items, cfg,
                                          np.random.default_rng(1), rate)
                   for name, rate in (("fresh", 0.1), ("no_fresh", 0.0))}
        batches["padding"] = tuple(torch.full_like(x, -1)
                                   for x in batches["fresh"])
        negatives = {}
        if kernel == "factor_update":
            # Pairwise mode on the same batches, with the kernels line's
            # random negative slots (rng seed 1 after the batch's draws).
            for name, rate in (("fresh", 0.1), ("no_fresh", 0.0)):
                rng = np.random.default_rng(1)
                ev = cs._middle_batch(torch, np, users, items, cfg, rng, rate)
                batches[f"pairwise_{name}"] = ev
                negatives[f"pairwise_{name}"] = torch.as_tensor(
                    rng.integers(0, h.i_cap, tuple(ev[0].shape)),
                    dtype=torch.int32, device="cuda")
        for name, (ev_u, ev_i) in batches.items():
            u_slot = state_lib.slot_of(ev_u, h.g, h.u_cap)
            i_slot = state_lib.slot_of(ev_i, h.n_i, h.i_cap)
            if kernel == "factor_update":
                cap = ev_u.shape[1]
                init = disgd.init_vector(prng.key(cfg.seed, device="cuda"),
                                         torch.cat([ev_u, ev_i], 1), h.k,
                                         h.init_scale)
                events = (ev_u, ev_i, u_slot, i_slot, negatives.get(name),
                          init[:, :cap].contiguous(),
                          init[:, cap:].contiguous())

                def launch(s, events=events):
                    ops.factor_update(s.user_vecs, s.item_vecs, s.rated,
                                      tuple(s.tables), events, eta=h.eta,
                                      lam=h.lam)
            else:
                events = (ev_u, ev_i, u_slot, i_slot)

                def launch(s, events=events):
                    ops.dics_update(s.co, s.item_cnt, s.rated,
                                    tuple(s.tables), events)
            iid = states.tables.item_ids.gather(1, i_slot.long())
            print(json.dumps({
                **split(kernel, states, launch), "batch": name,
                "train_s": train_s, "valid": int((ev_u >= 0).sum()),
                "item_evictions": int(((iid != ev_i) & (ev_u >= 0)).sum())}),
                flush=True)
        del states
        torch.cuda.empty_cache()

    if "swa_attention" in libs:
        from repro_torch.configs import get_config
        from repro_torch.data.tokens import TokenPipeline
        from repro_torch.models.factory import build as build_model

        cfg = get_config(cs.LLM_ARCH)
        params = build_model(cfg, device="cuda").init(
            torch.Generator(device="cuda").manual_seed(0))
        prompts = torch.as_tensor(TokenPipeline(cfg.vocab, seed=0).sample(
            cs.LLM_BATCH, cs.LLM_PROMPT), device="cuda")
        q, k, v = cs._layer0_qkv(torch, params, cfg, prompts)
        del params
        torch.cuda.empty_cache()
        kw = dict(window=cfg.window, causal=cfg.causal)
        print(json.dumps({
            **split("swa_attention", None,
                    lambda: ops.swa_attention(q, k, v, **kw)),
            "batch": "layer0", "shape": f"B={q.shape[0]} Hq={q.shape[1]} "
            f"Hkv={k.shape[1]} S={q.shape[2]} D={q.shape[3]} "
            f"window={cfg.window} bf16"}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, action="append",
                    help="a checkout to time (repeatable; default: this one)")
    ap.add_argument("--kernel", action="append", choices=KERNELS,
                    help="a kernel to time (repeatable; default: all)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    roots = [r.resolve() for r in (args.root or [ROOT])]
    if args.child is not None:
        _run(roots[0], json.loads(args.child))
        return
    kernels = tuple(args.kernel or KERNELS)
    libs = [build_variants(root, str(n), kernels)
            for n, root in enumerate(roots)]
    for root, root_libs in zip(roots, libs):
        subprocess.run([sys.executable, __file__, "--root", str(root),
                        "--child", json.dumps(root_libs)], check=True)


if __name__ == "__main__":
    main()
