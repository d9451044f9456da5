"""Build the hand-written CUDA kernels with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` has a plain C entry point ``<name>_launch`` and
is compiled on its own, for Hopper only::

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch_kernels/<name>.so

into ``build/repro_torch_kernels/`` at the root of the checkout, then
loaded with ``ctypes``. All stale sources are compiled at once, one
``nvcc`` each, on first use. A library is rebuilt when its source or a
shared header (``csrc/*.cuh``) is newer. Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["KERNELS", "BUILD_DIR", "BuildInfo", "build_all", "load",
           "nvcc_command"]

KERNELS = ("factor_update", "masked_scores", "fused_topn", "dics_update",
           "dics_topn", "isgd_update", "swa_attention")
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class BuildInfo:
    """One kernel library: where it is, how long nvcc took (0.0 when it
    was up to date), and ptxas's register / shared-memory report."""

    name: str
    path: Path
    seconds: float
    ptxas: str


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def nvcc_command(src: Path, out: Path, nvcc: str | None = None) -> list[str]:
    """The command that compiles the kernel source ``src`` into the
    library ``out`` (the flags in this module's docstring)."""
    return [nvcc or _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(out), str(src)]


def _library(name: str) -> Path:
    return BUILD_DIR / f"{name}.so"


def _stale(name: str) -> bool:
    lib = _library(name)
    if not lib.exists():
        return True
    deps = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in deps)


def build_all(force: bool = False) -> dict[str, BuildInfo]:
    """Compile every stale kernel library, all nvcc processes at once."""
    with _lock:
        return _build_locked(force)


def _build_locked(force: bool) -> dict[str, BuildInfo]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in KERNELS if force or _stale(n)]
    infos = {n: BuildInfo(n, _library(n), 0.0, "") for n in KERNELS}
    if not todo:
        return infos
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = BUILD_DIR / f"{name}.{os.getpid()}.tmp.so"
        procs[name] = (tmp, subprocess.Popen(
            nvcc_command(CSRC / f"{name}.cu", tmp, nvcc),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}.cu:\n{out}")
            continue
        os.replace(tmp, _library(name))
        infos[name] = BuildInfo(name, _library(name), seconds, out.strip())
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return infos


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (building all stale ones)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            if _stale(name):
                _build_locked(force=False)
            _libs[name] = ctypes.CDLL(str(_library(name)))
        return _libs[name]
