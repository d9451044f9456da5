"""Rank functions of ``tests/test_torch_sharded_train.py``, apart so that
the ranks ``launch.mesh.run_on_ranks`` spawns import neither jax nor the
JAX package (a spawned rank imports the module of the function it runs).

``sharded_cases`` runs every case on one group of ranks: each case is
``(name, arch, (data, model), kind, steps, microbatches, batches,
params)``; ``kind`` "train" trains ``steps`` steps on ``batches`` (the
whole batches, every rank the same) from ``params`` (the JAX layout's
numpy tree), "serve" runs a sharded prefill and one decode step.
"""

from __future__ import annotations

import os

import numpy as np
import torch

LR = 3e-4


def sharded_cases(info, cases, ckpt_dir):
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_cpu_mesh
    from repro_torch.optim import adamw_init
    from repro_torch.sharding import ctx, fsdp

    torch.set_num_threads(1)
    out = {}
    for name, arch, (d, m), kind, steps, micro, batches, params in cases:
        cfg = get_smoke_config(arch)
        mesh = ctx.bind_mesh(make_cpu_mesh(d, m))
        model = fsdp.shard_model(cfg, mesh, params=params, device="cpu")
        res = {"param_bytes": fsdp.resident_bytes(model),
               "spec_bytes": fsdp.shard_bytes(cfg, mesh)}
        if kind == "serve":
            local, axes = fsdp.local_batch(batches[0], mesh, "cpu")
            logits, caches = fsdp.prefill(model, local, cfg, axes)
            nxt = torch.argmax(logits[..., :cfg.vocab], -1).to(torch.int32)
            tok, _ = fsdp.decode(model, caches, nxt, cfg, axes)
            res.update(logits=logits.float().numpy(), next=nxt.numpy(),
                       decoded=tok.numpy(), rows=fsdp.batch_layout(
                           mesh, batches[0]["tokens"].shape[0])[1])
            out[name] = res
            continue
        opt = adamw_init(model)
        res["resident_bytes"] = fsdp.resident_bytes(model, opt)
        metrics, states = [], []
        ctx.reset_records()
        ops.reset_launch_counts()
        for step in range(steps):
            model, opt, met = fsdp.train_step(model, opt, batches[step],
                                              step, cfg, microbatches=micro,
                                              peak_lr=LR)
            metrics.append({k: float(v) for k, v in met.items()})
            if step == 0:
                res["records"] = ctx.records()
                res["launches"] = ops.launch_counts()["swa_attention"]
            states.append(fsdp.gathered_state(model, opt))
        res.update(metrics=metrics, states=states)
        if info.rank == 0:
            save_checkpoint(os.path.join(ckpt_dir, name), steps, states[-1])
        out[name] = res if info.rank == 0 else {
            k: res[k] for k in ("param_bytes", "spec_bytes",
                                "resident_bytes", "metrics")}
    return out
