"""Train a small member of the zoo for a few hundred steps.

Port of ``examples/train_lm.py``: the training launcher's real code path
(AdamW, the cosine schedule, checkpointing) on a reduced stablelm-family
config; the loss must decrease.

  PYTHONPATH=src python -m repro_torch.launch.train_lm \\
      [--arch stablelm_3b] [--steps 200] [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.launch import train as train_mod

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_3b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    losses = train_mod.main([
        "--arch", args.arch, "--smoke",
        "--steps", str(args.steps),
        "--batch", "8", "--seq", "128",
        "--lr", "1e-3", "--log-every", "20",
        "--device", args.device,
    ])
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss did not decrease: {losses[0]:.4f} -> "
                           f"{losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
