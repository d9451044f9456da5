"""Dry-run: one rank's program of every (architecture x input shape) on
the production layouts, plus the paper's own grid step, counted.

Port of ``repro/launch/dryrun.py``: the same flags and report keys.
JAX lowers and compiles each step for 256 (512) host devices and reads
XLA's memory and cost analyses; the port describes rank 0 of the
production layout (``make_production_mesh``: 16 x 16, or 2 x 16 x 16)
running the port's sharded step (``sharding.fsdp``: parameter and AdamW
blocks by ``specs.param_specs``, each gathered where used, gradients
reduce-scattered, the batch split over the batch axes):

  1. the rank's blocks, AdamW state, batch rows and caches are fake
     tensors (``FakeTensorMode``: shapes and types, nothing allocated),
     on a fake card where PyTorch is built for CUDA (on a CPU-only build
     the trace runs on fake CPU tensors: the program is the same, K7 is
     a custom operator whose fake gives its output);
  2. the step runs once under ``torch.utils.flop_counter.FlopCounterMode``
     (``flops``; K7's FLOPs come from its registered formula), a count
     of every operator's operand and result bytes (``hbm_bytes``:
     unfused, so an upper bound on the HBM traffic; views move nothing
     and are not counted) and the live bytes of every storage over the
     step, rounded as the card's allocator rounds a block
     (``memory.peak_bytes``, as ``torch.cuda.max_memory_allocated``
     counts);
  3. its collectives are ``sharding.ctx``'s records (the mesh is a layout:
     a collective records its entry and returns an uninitialised
     result; ``core.distributed``'s, for ``lower_recsys``, its
     ``layout_collectives``), and the roofline terms take the H100's ``roofline.HW``.

``analysis_mode`` says what was counted. PyTorch runs every loop
iteration (layers, q chunks, the mamba and mLSTM chunks, each sLSTM
step) and the counters see each, so JAX's unroll-probe algebra
(``dryrun.py:210-263``, ``models/flags.py``) has no counterpart;
``_loop_structure`` is kept with JAX's values as a record of the loops
(the report's ``loop_structure``); ``_slstm_flop_correction`` keeps
JAX's closed form, which JAX adds to a count that sees the sLSTM scan
once: the port's count sees every step, so it is neither added nor
reported. Serve steps keep the port's f32 weights (JAX's
dry-run casts them to bf16). ``lower_s`` is the time to build the fake
state and inputs, ``compile_s`` the counted step's (nothing is
compiled ahead; the names are JAX's).

``lower_recsys`` runs rank 0's ``core.distributed`` grid step once, on
real CPU tensors (the plain versions), at ``RECSYS_HYPER_PRESETS`` and
micro-batch 65,536 on a layout: that step's work depends on its data
and is not faked.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm_3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out build/...json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --recsys [--multi-pod]

Needs no card and starts no process group.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
import weakref

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.shapes import microbatches_for, plan_for
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import module as mod
from repro_torch.models import transformer as tfm
from repro_torch.models.factory import build
from repro_torch.models.layers.attention import KVCache
from repro_torch.models.layers.mamba import MambaState
from repro_torch.models.layers.xlstm import MlstmState, SlstmState
from repro_torch.optim import adamw_init
from repro_torch.roofline.analysis import analyze
from repro_torch.sharding import ctx
from repro_torch.sharding import fsdp
from repro_torch.sharding import specs as specs_lib

__all__ = ["lower_combo", "report_step", "lower_recsys",
           "RECSYS_HYPER_PRESETS", "trace_device", "make_step", "run_step",
           "main"]

# Production-scale capacity presets per algorithm (data, not dispatch):
# factor models afford big tables; DICS carries an O(i_cap^2) co matrix.
RECSYS_HYPER_PRESETS = {
    "disgd": dict(k=32, u_cap=4096, i_cap=2048),
    "bpr": dict(k=32, u_cap=4096, i_cap=2048),
    "dics": dict(u_cap=1024, i_cap=512),
}


def trace_device() -> str:
    """The fake tensors' device: the card where PyTorch is built for
    CUDA, else the CPU."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def _needs_seq_shard(cfg, mesh) -> bool:
    return cfg.n_kv_heads % mesh.shape["model"] != 0


def _loop_structure(cfg, shape):
    """Static loop nesting: [(kind, trip_count, ancestor_multiplier)]
    (JAX's ``_loop_structure``)."""
    entries = []
    s = shape.seq_len
    decode = shape.kind == "decode"
    if cfg.family == "ssm":
        p = cfg.xlstm.slstm_period
        g = cfg.n_layers // p
        entries.append(("groups", g, 1))
        entries.append(("mlstm_inner", p - 1, g))
        if not decode:
            nc = s // min(cfg.xlstm.chunk, s)
            entries.append(("mlstm_chunk", nc, g * (p - 1)))
        return [(k, n, a) for k, n, a in entries if n > 1]
    n_scan = cfg.n_layers - (
        1 if (cfg.moe and cfg.moe.first_dense) else 0
    )
    entries.append(("layers", n_scan, 1))
    if not decode:
        n_chunks = s // min(cfg.q_chunk, s)
        entries.append(("qchunk", n_chunks, n_scan))
        if cfg.family == "hybrid":
            nm = s // min(cfg.ssm.chunk, s)
            entries.append(("mamba", nm, n_scan))
    return [(k, n, a) for k, n, a in entries if n > 1]


def _slstm_flop_correction(cfg, shape, n_data: int) -> float:
    """JAX's closed-form FLOPs of the sLSTM time scan (per chip), which
    its cost analysis counts once: 4 gates x (x W + h R) = 16 d^2 a token
    an sLSTM layer, x3 to train."""
    if cfg.family != "ssm":
        return 0.0
    n_slstm = cfg.n_layers // cfg.xlstm.slstm_period
    tokens = shape.global_batch * (
        shape.seq_len if shape.kind != "decode" else 1
    )
    shard = n_data if shape.global_batch % n_data == 0 else 1
    mult = 3.0 if shape.kind == "train" else 1.0
    return 16.0 * cfg.d_model ** 2 * (tokens / shard) * n_slstm * mult


# -- counting ----------------------------------------------------------------

_NO_BYTES = {torch.ops.aten.empty.memory_format,
             torch.ops.aten.empty_like.default,
             torch.ops.aten.new_empty.default,
             torch.ops.aten.empty_strided.default}


class _Counter(torch.utils._python_dispatch.TorchDispatchMode):
    """Two counts over the operators it sees: ``total``, the bytes of
    every operator's tensor operands and results (views, allocations
    without a write and metadata queries excluded), and the live bytes
    of the storages (those given to :meth:`track` and every result's),
    with their ``peak``. A storage is counted until it is freed (a weak
    reference's callback), rounded up to ``granule`` bytes as the card's
    caching allocator rounds a block."""

    def __init__(self, granule: int = 1, count_bytes: bool = True):
        super().__init__()
        self.total, self.live, self.peak = 0, 0, 0
        self.granule, self.count_bytes = granule, count_bytes
        self._sizes: dict = {}

    def _free(self, key):
        self.live -= self._sizes.pop(key)

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return
        n = -(-st.nbytes() // self.granule) * self.granule
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "prim":    # metadata queries (a fake's device)
            return out
        view = func.is_view
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                if not view:
                    self.track(t)
                    if self.count_bytes and func not in _NO_BYTES:
                        self.total += t.numel() * t.element_size()
        if self.count_bytes and not (view or func in _NO_BYTES):
            for t in torch.utils._pytree.tree_leaves((args, kwargs)):
                if isinstance(t, torch.Tensor):
                    self.total += t.numel() * t.element_size()
        return out


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size()
               for t in torch.utils._pytree.tree_leaves(tensors)
               if isinstance(t, torch.Tensor))


def _empty_caches(cfg, batch: int, context_len: int, device):
    """The port's decode cache for ``batch`` rows (uninitialised), laid
    out as ``factory._prefill`` returns it: every layer stacked."""
    def empty(d, layers=None):
        shape = d.shape if layers is None else (layers,) + d.shape[1:]
        return torch.empty(shape, dtype=mod.torch_dtype(d.dtype),
                           device=device)

    decls = tfm.cache_decls(cfg, batch, context_len)
    if cfg.family == "ssm":
        return tfm.XlstmCache(
            mlstm=MlstmState(*(empty(decls["mlstm"][f])
                               for f in MlstmState._fields)),
            slstm=SlstmState(*(empty(decls["slstm"][f])
                               for f in SlstmState._fields)))
    stacked, n = decls[1], cfg.n_layers
    kv = KVCache(*(empty(stacked[f], n) for f in KVCache._fields))
    if cfg.family != "hybrid":
        return kv
    return tfm.HybridCache(kv=kv, mamba=MambaState(
        *(empty(stacked["mamba"][f], n) for f in MambaState._fields)))


def _inputs(bundle, shape, mesh, overrides, device):
    """(whole batch on the host, this rank's rows on ``device``, batch
    axes): token ids 0, masks False, float features uninitialised."""
    whole = {}
    for k, (sh, dt) in bundle.input_specs(shape).items():
        fill = torch.empty if dt.is_floating_point else torch.zeros
        whole[k] = fill(sh, dtype=dt, device="cpu")
    local, axes = fsdp.local_batch(whole, mesh, device, overrides)
    return whole, local, axes


def make_step(cfg, shape, mesh, *, microbatches: int = 1, overrides=None,
              device=None):
    """Rank 0's state and inputs of ``shape`` on ``mesh`` (uninitialised:
    real tensors on ``device``, or fakes under ``FakeTensorMode``) and its
    step. Returns (step: a callable running it once and returning its
    outputs, the step's arguments)."""
    device = torch.device(device or trace_device())
    bundle = build(cfg, device="cpu")
    model = fsdp.shard_model(cfg, mesh, device=device, overrides=overrides)
    opt = adamw_init(model) if shape.kind == "train" else None
    whole, local, axes = _inputs(bundle, shape, mesh, overrides, device)
    caches = None
    if shape.kind == "decode":
        caches = _empty_caches(cfg, local["tokens"].shape[0], shape.seq_len,
                               device)
    args = [list(model.parameters()), local, caches]
    if opt is not None:
        args += [opt.m, opt.v, opt.count]

    def step():
        if shape.kind == "train":
            # The step takes the whole batch (host) and keeps its rows.
            return fsdp.train_step(model, opt, whole, 0, cfg,
                                   microbatches=microbatches)[2]
        if shape.kind == "prefill":
            return fsdp.prefill(model, local, cfg, axes)
        return fsdp.decode(model, caches, local["tokens"], cfg, axes)

    step.axes = axes
    return step, args


def run_step(cfg, shape, mesh, *, microbatches: int = 1, overrides=None,
             device=None, count: bool = True) -> dict:
    """``make_step``'s step run once, counted. Returns ``flops``,
    ``hbm_bytes`` (0 without ``count``), ``records``, ``memory``
    (argument / output / temp / peak bytes), ``lower_s`` (building the
    state), ``compile_s`` (the step), the step's outputs (``out``) and
    batch axes (``axes``)."""
    from torch.utils.flop_counter import FlopCounterMode

    device = torch.device(device or trace_device())
    t0 = time.perf_counter()
    step, args = make_step(cfg, shape, mesh, microbatches=microbatches,
                           overrides=overrides, device=device)
    arg_bytes = _nbytes(args)
    lower_s = time.perf_counter() - t0

    flop_mode = FlopCounterMode(display=False) if count else \
        contextlib.nullcontext()
    counter = _Counter(512 if device.type == "cuda" else 1, count)
    for t in torch.utils._pytree.tree_leaves(args):
        if isinstance(t, torch.Tensor):
            counter.track(t)
    ctx.reset_records()
    t0 = time.perf_counter()
    with flop_mode, counter:
        out = step()
    compile_s = time.perf_counter() - t0
    peak = counter.peak
    out_bytes = _nbytes([t for t in torch.utils._pytree.tree_leaves(out)
                         if isinstance(t, torch.Tensor)
                         and not _aliases(t, args)])
    return dict(
        flops=flop_mode.get_total_flops() if count else 0,
        hbm_bytes=counter.total,
        records=ctx.records(),
        memory={"argument_bytes": int(arg_bytes),
                "output_bytes": int(out_bytes),
                "temp_bytes": int(max(peak - arg_bytes, 0)),
                "peak_bytes": int(peak)},
        lower_s=lower_s, compile_s=compile_s, out=out, axes=step.axes)


def _aliases(t, args) -> bool:
    """Whether ``t`` is (a view of) one of the step's arguments (the
    in-place caches and state)."""
    st = t.untyped_storage()
    return any(st._cdata == a.untyped_storage()._cdata
               for a in torch.utils._pytree.tree_leaves(args)
               if isinstance(a, torch.Tensor))


@contextlib.contextmanager
def _fake():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        yield


def lower_combo(arch_id: str, shape_name: str, *, multi_pod: bool = False,
                overrides: dict | None = None, analysis: bool = True,
                optimized: bool = False) -> dict:
    """Count rank 0's step of one (arch, shape) on the production layout
    (JAX's report keys; ``analysis=False`` runs it without the FLOP and
    byte counters)."""
    cfg = get_config(arch_id)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if optimized:
        from repro_torch.configs.optimized import apply_optimized
        cfg = apply_optimized(cfg)
    return report_step(cfg, arch_id, SHAPES[shape_name],
                       make_production_mesh(multi_pod=multi_pod),
                       "pod2x16x16" if multi_pod else "16x16",
                       analysis=analysis,
                       variant="optimized" if optimized else "baseline")


def report_step(cfg, arch_id: str, shape, mesh, mesh_name: str, *,
                analysis: bool = True, variant: str = "baseline") -> dict:
    """``lower_combo``'s report of ``cfg`` at ``shape`` on any layout
    ``mesh`` (the tests' small configs and meshes)."""
    plan = plan_for(cfg, shape)
    report = {
        "arch": arch_id, "shape": shape.name, "mesh": mesh_name,
        "plan": plan, "variant": variant,
    }
    if plan != "run":
        return report

    n_dev = mesh.size
    n_data = math.prod(mesh.shape[a] for a in specs_lib.data_axes(mesh))
    tokens = shape.global_batch * (
        shape.seq_len if shape.kind != "decode" else 1
    )
    micro = (microbatches_for(cfg, shape, n_data)
             if shape.kind == "train" else 1)
    report["microbatches"] = micro
    ov = dict(cfg.sharding_overrides) or None
    with _fake():
        run = run_step(cfg, shape, mesh, microbatches=micro, overrides=ov,
                       count=analysis)
    n_active = cfg.active_param_count()
    model_flops = (6.0 if shape.kind == "train" else 2.0) * n_active * tokens
    report.update(
        lower_s=round(run["lower_s"], 2),
        compile_s=round(run["compile_s"], 2),
        n_devices=n_dev,
        params=cfg.param_count(),
        active_params=n_active,
        tokens_per_step=tokens,
        memory=run["memory"],
        trace_device=trace_device(),
        batch_axes=list(run["axes"]),
    )
    report["analysis_mode"] = (
        "counted: FlopCounterMode, operand + result bytes, ctx records; "
        "every loop iteration executed" if analysis
        else "records only (analysis disabled)")
    report["loop_structure"] = _loop_structure(cfg, shape)
    roof = analyze(run["flops"], run["hbm_bytes"], run["records"],
                   model_flops_per_chip=model_flops / n_dev)
    report["roofline"] = roof.row()
    report["collectives"] = roof.coll_detail
    return report


def lower_recsys(*, multi_pod: bool = False, algorithm: str = "disgd") -> dict:
    """Rank 0's S&R grid step on the production layout, counted."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core import distributed as dist
    from repro_torch.core import routing
    from repro_torch.core.algorithm import get_algorithm
    from repro_torch.core.pipeline import StreamConfig

    mesh = make_production_mesh(multi_pod=multi_pod)
    n_i = mesh.shape["model"]
    g = math.prod(mesh.shape[a] for a in ("pod", "data")
                  if a in mesh.shape)
    grid = routing.GridSpec(n_i, g - n_i)
    hyper = get_algorithm(algorithm).default_hyper()._replace(
        **RECSYS_HYPER_PRESETS.get(algorithm, {}))
    cfg = StreamConfig(algorithm=algorithm, grid=grid, micro_batch=65536,
                       hyper=hyper, device="cpu")
    cap = cfg.bucket_capacity

    step = dist.make_grid_step(cfg, mesh)
    states = dist.init_grid_states(cfg, mesh)
    rng = np.random.default_rng(0)
    ev_u = torch.as_tensor(rng.integers(0, 1 << 20, (n_i, g, cap)),
                           dtype=torch.int32)
    ev_i = torch.as_tensor(rng.integers(0, 1 << 16, (n_i, g, cap)),
                           dtype=torch.int32)
    args = [states, ev_u, ev_i]
    arg_bytes = _nbytes(args)
    flop_mode, counter = FlopCounterMode(display=False), _Counter()
    for t in torch.utils._pytree.tree_leaves(args):
        if isinstance(t, torch.Tensor):
            counter.track(t)
    dist.reset_collective_stats()
    t0 = time.perf_counter()
    with torch.no_grad(), flop_mode, counter:
        out = step(states, ev_u, ev_i)
    compile_s = time.perf_counter() - t0
    peak = counter.peak
    records = [ctx.Record(*r) for r in dist.layout_collectives()]
    roof = analyze(flop_mode.get_total_flops(), counter.total, records)
    return {
        "arch": f"recsys_{algorithm}", "shape": f"stream_mb{cfg.micro_batch}",
        "mesh": "pod2x16x16" if multi_pod else "16x16",
        "plan": "run",
        "grid": {"n_i": n_i, "g": g, "n_c": grid.n_c, "capacity": cap},
        "compile_s": round(compile_s, 2),
        "memory": {"argument_bytes": int(arg_bytes),
                   "output_bytes": int(_nbytes(out[1:])),
                   "temp_bytes": int(max(peak - arg_bytes, 0)),
                   "peak_bytes": int(peak)},
        "roofline": roof.row(),
        "collectives": roof.coll_detail,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--recsys", action="store_true")
    ap.add_argument("--recsys-algorithm", default="disgd")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-analysis", action="store_true",
                    help="no FLOP or byte counters (memory and collectives)")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the beyond-paper optimized presets")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    analysis = not args.no_analysis

    reports = []
    if args.recsys:
        r = lower_recsys(multi_pod=args.multi_pod,
                         algorithm=args.recsys_algorithm)
        print(json.dumps(r, indent=2))
        reports.append(r)
    elif args.all:
        for arch in ARCH_IDS:
            for shape in SHAPES:
                try:
                    r = lower_combo(arch, shape, multi_pod=args.multi_pod,
                                    analysis=analysis,
                                    optimized=args.optimized)
                except Exception as e:
                    r = {"arch": arch, "shape": shape, "plan": "ERROR",
                         "error": f"{type(e).__name__}: {e}",
                         "traceback": traceback.format_exc()[-2000:]}
                print(json.dumps({k: v for k, v in r.items()
                                  if k != "traceback"}), flush=True)
                reports.append(r)
                if args.out:
                    with open(args.out, "w") as f:
                        json.dump(reports, f, indent=2)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all or --recsys")
        r = lower_combo(args.arch, args.shape,
                        multi_pod=args.multi_pod, analysis=analysis,
                        optimized=args.optimized)
        print(json.dumps(r, indent=2))
        reports.append(r)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(reports, f, indent=2)
    failed = [r for r in reports if r.get("plan") == "ERROR"]
    print(f"\n{len(reports)} combos, {len(failed)} errors")
    raise SystemExit(1 if failed else 0)


if __name__ == "__main__":
    main()
