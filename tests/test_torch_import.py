"""The PyTorch port stands alone: no jax, no JAX package, no name dispatch.

Importing ``repro_torch`` (and every module in it) in a fresh interpreter
must load neither ``jax`` nor ``repro``; ``chip_smoke.py`` imports
neither; and the CI registry-dispatch grep (``.github/workflows/ci.yml``)
finds no algorithm-name comparison in the port.
"""

import pytest

pytest.importorskip("torch")

import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402,F401
import torch  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

# The gate of .github/workflows/ci.yml, "Registry dispatch gate".
_DISPATCH = re.compile(r"""algorithm *(==|!=) *['"]|['"] *(==|!=) *[A-Za-z_.]*"""
                       r"""algorithm\b|\.algorithm +(not +)?in *\(""")


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_import_loads_neither_jax_nor_repro():
    mods = list(_modules())
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
              "m.startswith('repro.'))\n"
              "print(len(sys.modules))\n"
              "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 15


@pytest.mark.parametrize("path", ["chip_smoke.py", "src/repro_torch"])
def test_no_jax_or_repro_imports_in_source(path):
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                         re.M)
    target = ROOT / path
    files = [target] if target.is_file() else sorted(target.rglob("*.py"))
    for f in files:
        assert not pattern.search(f.read_text()), f


def test_registry_dispatch_gate_finds_nothing_in_the_port():
    for f in sorted(PORT.rglob("*.py")):
        for n, line in enumerate(f.read_text().splitlines(), 1):
            assert not _DISPATCH.search(line), f"{f}:{n}: {line}"


def test_chip_smoke_refuses_to_run_outside_a_checkout(tmp_path):
    """Alone in a directory, chip_smoke.py fails and prints no result."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
