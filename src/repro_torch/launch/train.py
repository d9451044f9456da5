"""Training driver for the architecture zoo.

Port of ``repro/launch/train.py``: the same flags and loop (random
weights from a ``torch.Generator`` seeded 0, batches from
``TokenPipeline(vocab, seed=0)`` and ``make_batch(seed=step)``, the
cosine schedule fed to ``train_step`` as its ``peak_lr``, a checkpoint
every ``--ckpt-every`` steps), plus ``--device`` (default ``cuda``).
Checkpoints hold ``{"params", "opt"}`` in the JAX layout
(``core.convert.params_to_numpy`` / ``opt_to_numpy``), so
``repro.checkpoint.restore_checkpoint`` reads them.

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch stablelm_3b --smoke --steps 100 --batch 8 --seq 128 \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch h2o_danube_1p8b --steps 4 --batch 2 --seq 8192 --warmup 0

``--data-shards D --model-shards M`` runs the loop on ``D * M`` ranks
(``launch.mesh.run_on_ranks``: NCCL with a card a rank, gloo when ranks
share a card or on the CPU) over the ``(data=D, model=M)`` layout, with
the sharded step of ``sharding.fsdp``: each rank holds its blocks of the
parameters and of AdamW's state (the whole tensors exist only while
drawn, gathered or checkpointed), builds the same whole batch from
``make_batch(seed=step)`` and takes its rows; the step's mathematics is
the one-process step's. Rank 0 prints the log and writes the same
``{"params", "opt"}`` checkpoint, gathered from every rank; ``main``
returns rank 0's losses. ``D = M = 1`` is the one-process loop. The host
reads each step's loss after the step (the JAX loop does too).

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe_1b_7b \
      --smoke --steps 4 --batch 4 --seq 64 --data-shards 2 \
      --model-shards 2 --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.convert import opt_to_numpy, params_to_numpy
from repro_torch.data.tokens import TokenPipeline, make_batch
from repro_torch.launch.mesh import run_on_ranks
from repro_torch.models.factory import build
from repro_torch.optim import adamw_init, cosine_schedule

__all__ = ["main", "train_on_rank"]


def _device_batch(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--data-shards", type=int, default=1)
    ap.add_argument("--model-shards", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.data_shards != 1 or args.model_shards != 1:
        return run_on_ranks(train_on_rank, args.data_shards *
                            args.model_shards, args.device, args,
                            timeout=24 * 3600.0).results[0]

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    bundle = build(cfg, device=args.device)
    params = bundle.init(torch.Generator(device=bundle.device).manual_seed(0))
    opt = adamw_init(params)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[train] {cfg.name}: {n_params/1e6:.2f}M params on "
          f"{bundle.device}")

    pipe = TokenPipeline(cfg.vocab, seed=0)
    losses = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        batch = _device_batch(make_batch(cfg, args.batch, args.seq,
                                         seed=step, pipeline=pipe),
                              bundle.device)
        lr = cosine_schedule(np.float32(step), peak=args.lr,
                             warmup=args.warmup, total=args.steps)
        params, opt, metrics = bundle.train_step(
            params, opt, batch, step, microbatches=args.microbatches,
            peak_lr=lr)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.perf_counter() - t0
            print(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                  f"lr {float(lr):.2e} ({dt:.1f}s)")
        if args.ckpt_dir and args.ckpt_every and \
                (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, step + 1,
                            {"params": params_to_numpy(params),
                             "opt": opt_to_numpy(opt, params)})

    _summary(losses)
    return losses


def _summary(losses) -> None:
    first = np.mean(losses[: max(1, len(losses) // 10)])
    last = np.mean(losses[-max(1, len(losses) // 10):])
    print(f"[train] loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")


def train_on_rank(info, args) -> list:
    """``run_on_ranks`` entry of ``main``'s sharded loop: this rank's
    part of every step; returns the losses (every rank's are the whole
    batch's)."""
    from repro_torch.launch.mesh import make_cpu_mesh
    from repro_torch.sharding import ctx, fsdp

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh = ctx.bind_mesh(make_cpu_mesh(args.data_shards, args.model_shards))
    device = torch.device(info.device)
    model = fsdp.shard_model(cfg, mesh, generator=torch.Generator(
        device=device).manual_seed(0), overrides=dict(
            cfg.sharding_overrides) or None)
    opt = adamw_init(model)
    lead = info.rank == 0
    if lead:
        n_params = sum(p.numel() for p in model.parameters())
        print(f"[train] {cfg.name}: {n_params/1e6:.2f}M parameters a rank "
              f"on {info.world} ranks ({info.backend}), "
              f"mesh={dict(mesh.shape)}")
    pipe = TokenPipeline(cfg.vocab, seed=0)
    losses = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        batch = make_batch(cfg, args.batch, args.seq, seed=step,
                           pipeline=pipe)
        lr = cosine_schedule(np.float32(step), peak=args.lr,
                             warmup=args.warmup, total=args.steps)
        model, opt, metrics = fsdp.train_step(
            model, opt, batch, step, cfg, microbatches=args.microbatches,
            peak_lr=lr)
        losses.append(float(metrics["loss"]))
        if lead and (step % args.log_every == 0 or step == args.steps - 1):
            dt = time.perf_counter() - t0
            print(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                  f"lr {float(lr):.2e} ({dt:.1f}s)", flush=True)
        if args.ckpt_dir and args.ckpt_every and \
                (step + 1) % args.ckpt_every == 0:
            tree = fsdp.gathered_state(model, opt)
            if lead:
                save_checkpoint(args.ckpt_dir, step + 1, tree)
            del tree
    if lead:
        _summary(losses)
    return losses


if __name__ == "__main__":
    main()
