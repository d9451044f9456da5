"""Three-term roofline analysis of a rank's step on the H100.

Port of ``repro/roofline/analysis.py``:

  compute    = FLOPs / peak FLOP/s          [s]
  memory     = HBM bytes / HBM rate         [s]
  collective = collective bytes / link rate [s]

JAX reads FLOPs and bytes from a compiled program's ``cost_analysis`` and
the collectives from its HLO text; the port counts them while the step
runs (``launch.dryrun``: ``FlopCounterMode``, every operator's operand
and result bytes, and ``sharding.ctx``'s records), so :func:`analyze`
takes the counts. ``collective_bytes`` keeps JAX's conventions: a
collective's result-buffer bytes, a reduce-scatter's times its group
size, per kind, with ``counts`` and ``total``.

Hardware constants: NVIDIA's H100 SXM datasheet (the card these numbers
are for: NVIDIA H100 80GB HBM3, 700.00 W): 989.4 TFLOP/s dense bf16 on
the tensor cores, 67 TFLOP/s f32 outside them, 3.35 TB/s HBM3, and
NVLink 4 at 450 GB/s each way (900 GB/s both ways).
"""

from __future__ import annotations

import dataclasses

__all__ = ["HW", "RooflineReport", "collective_bytes", "analyze"]


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 989.4e12   # bf16 dense tensor-core FLOP/s
    f32_flops: float = 67e12       # f32 FLOP/s outside the tensor cores
    hbm_bw: float = 3.35e12        # HBM3 bytes/s
    link_bw: float = 450e9         # NVLink 4 bytes/s, one way


_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def collective_bytes(records) -> dict:
    """Per-kind result-buffer bytes of ``sharding.ctx`` records
    ``(kind, nbytes, group_size)``, a reduce-scatter's times its group
    size; ``counts`` per kind and ``total``."""
    out = {k: 0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for kind, nbytes, group_size in records:
        if kind == "reduce-scatter":
            nbytes *= group_size
        out[kind] += nbytes
        counts[kind] += 1
    out["counts"] = counts
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    return out


@dataclasses.dataclass
class RooflineReport:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    coll_detail: dict
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs (per-chip-normalized)."""
        return self.model_flops / self.flops if self.flops else 0.0

    def row(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
        }


def analyze(flops: float, hbm_bytes: float, records, *,
            model_flops_per_chip: float = 0.0,
            hw: HW = HW()) -> RooflineReport:
    """The report of one rank's counted step: ``flops`` and
    ``hbm_bytes`` as counted, ``records`` its collectives."""
    coll = collective_bytes(records)
    return RooflineReport(
        flops=float(flops),
        hbm_bytes=float(hbm_bytes),
        coll_bytes=float(coll["total"]),
        coll_detail=coll,
        compute_s=float(flops) / hw.peak_flops,
        memory_s=float(hbm_bytes) / hw.hbm_bw,
        collective_s=float(coll["total"]) / hw.link_bw,
        model_flops=model_flops_per_chip,
    )
