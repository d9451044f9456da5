"""LLM serving entry point: batched prefill + greedy decode.

Port of ``repro/launch/serve.py`` (:26). This drives the transformer model
zoo (``repro_torch.models``: every arch in ``ARCH_IDS``), not the
recommender's serving plane (``repro_torch.serve``). Weights are random,
from a ``torch.Generator`` seeded 0; prompts come from
``TokenPipeline(vocab, seed=0)``, and a VLM's patch embeddings from
``np.random.default_rng(0)`` (``--prompt-len`` counts patches and
tokens together, as in JAX).

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch h2o_danube_1p8b --batch 4 --prompt-len 8192 --gen 33
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch olmoe_1b_7b --batch 4 --prompt-len 4096 --gen 33
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch phi3_vision_4p2b --batch 2 --prompt-len 1600 --gen 9
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch olmoe_1b_7b --smoke --device cpu

``--arch dbrx_132b --smoke`` and ``--arch hymba_1p5b --smoke`` run on
the CPU only: their head dims of 16 and 25 are no width
``swa_attention`` is built for, and the kernel's wrapper refuses them on
the card at the first prefill (a ``ValueError``). hubert is an encoder:
``--arch hubert_xlarge`` exits with "encoder-only; nothing to decode",
as in JAX; its served path is ``bundle.prefill`` on a frames batch
(``data.tokens.make_batch``).

The greedy tokens stay on the device through the decode loop; the host
reads them once, at the end (the JAX version reads one per step).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models.factory import build

__all__ = ["generate", "serve_batch", "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _prompt_shape(batch: dict) -> tuple[int, int]:
    """(requests, prompt positions): a VLM's patches count as positions."""
    b, s = batch["tokens"].shape
    if "patches" in batch:
        s += batch["patches"].shape[1]
    return b, s


def generate(bundle, params, batch: dict, gen: int):
    """Prefill the prompts of ``batch`` (``tokens`` [B, S] on the
    bundle's device, and a VLM's ``patches``), then greedy decode until
    ``gen`` tokens per request (the first from the prefill, so ``gen - 1``
    decode steps). Returns (tokens [B, gen] i32 on the device, timings):
    prefill ms and prompt positions/s, decode ms per step and generated
    tokens/s (over the decode steps)."""
    cfg, device = bundle.cfg, bundle.device
    b, s = _prompt_shape(batch)
    out = torch.empty((b, gen), dtype=torch.int32, device=device)
    _sync(device)
    t0 = time.perf_counter()
    logits, caches = bundle.prefill(params, batch)
    tok = torch.argmax(logits[..., : cfg.vocab], dim=-1).to(torch.int32)
    out[:, :1] = tok
    _sync(device)
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    for t in range(1, gen):
        tok, caches = bundle.decode(params, caches, tok)
        out[:, t:t + 1] = tok
    _sync(device)
    t_decode = time.perf_counter() - t0
    steps = gen - 1
    return out, {
        "prefill_ms": 1e3 * t_prefill,
        "prefill_tokens_per_s": b * s / t_prefill,
        "decode_steps": steps,
        "decode_ms_per_step": 1e3 * t_decode / steps if steps else None,
        "decode_tokens_per_s": b * steps / t_decode if steps else None,
    }


def serve_batch(cfg, batch: int, prompt_len: int, device) -> dict:
    """``repro/launch/serve.py:43-50``'s prompts on ``device``: tokens
    from ``TokenPipeline(vocab, seed=0)``; a VLM's ``prompt_len -
    vlm_patches`` tokens and ``np.random.default_rng(0)`` patches."""
    pipe = TokenPipeline(cfg.vocab, seed=0)
    rng = np.random.default_rng(0)
    if not cfg.vlm_patches:
        return {"tokens": torch.as_tensor(pipe.sample(batch, prompt_len),
                                          device=device)}
    return {
        "tokens": torch.as_tensor(
            pipe.sample(batch, prompt_len - cfg.vlm_patches), device=device),
        "patches": torch.as_tensor(rng.normal(size=(
            batch, cfg.vlm_patches, cfg.vlm_d_vision)).astype(np.float32),
            device=device),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if not cfg.decoder:
        raise SystemExit(f"{cfg.name} is encoder-only; nothing to decode")
    bundle = build(cfg, device=args.device)
    gen = torch.Generator(device=bundle.device).manual_seed(0)
    params = bundle.init(gen)
    batch = serve_batch(cfg, args.batch, args.prompt_len, bundle.device)

    tokens, t = generate(bundle, params, batch, args.gen)
    tokens = tokens.cpu().numpy()
    decode = ("" if t["decode_ms_per_step"] is None else
              f"; decode {t['decode_steps']} steps "
              f"{t['decode_ms_per_step']:.2f} ms/step "
              f"({t['decode_tokens_per_s']:.1f} tok/s)")
    print(f"[serve] {cfg.name} on {bundle.device}: prefill "
          f"({args.batch}x{args.prompt_len}) {t['prefill_ms']:.1f} ms "
          f"({t['prefill_tokens_per_s']:.1f} tok/s){decode}")
    print(f"[serve] sample generation (batch 0): {tokens[0][:16]}...")
    return tokens


if __name__ == "__main__":
    main()
