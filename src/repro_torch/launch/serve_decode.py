"""Serve a small model with batched requests: prefill + streaming decode.

Port of ``examples/serve_decode.py``:

  PYTHONPATH=src python -m repro_torch.launch.serve_decode \\
      [--arch h2o_danube_1p8b] [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.launch import serve as serve_mod

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o_danube_1p8b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return serve_mod.main([
        "--arch", args.arch, "--smoke",
        "--batch", "4", "--prompt-len", "64", "--gen", "16",
        "--device", args.device,
    ])


if __name__ == "__main__":
    main()
