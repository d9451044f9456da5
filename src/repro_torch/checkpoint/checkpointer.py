"""Msgpack pytree checkpointer (no dependency beyond msgpack).

Port of ``repro/checkpoint/checkpointer.py``, writing and reading the
same bytes: an array is ``{"__arr__": [dtype.str, shape, raw bytes]}``
(bf16 as ``"bfloat16"`` over its uint16 bits), a tuple — NamedTuples
included — ``{"__tuple__": [...]}``, dicts (keys sorted at every level,
as ``jax.tree.map`` leaves them in the JAX writer), lists and ``None``
as themselves. Files are ``step_%08d.msgpack`` in the directory, written
to a temporary file and renamed into place, so a killed run never leaves
a torn checkpoint.

Tensors are copied to host numpy on the way out. On the way in, arrays
come back as numpy arrays, and a bf16 array, which numpy has no type
for, as a CPU ``torch.bfloat16`` tensor. msgpack is imported when a
checkpoint is written or read, not with the package.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_ARR = "__arr__"
_TUP = "__tuple__"


def _encode(obj):
    if torch.is_tensor(obj):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            return {_ARR: ["bfloat16", list(t.shape),
                           t.contiguous().view(torch.uint16).numpy()
                           .tobytes()]}
        obj = t.numpy()
    if isinstance(obj, np.ndarray):
        if obj.dtype.name == "bfloat16":
            return {_ARR: ["bfloat16", list(obj.shape),
                           obj.view(np.uint16).tobytes()]}
        return {_ARR: [obj.dtype.str, list(obj.shape), obj.tobytes()]}
    if isinstance(obj, tuple):
        return {_TUP: [_encode(x) for x in obj]}
    if isinstance(obj, dict):
        return {str(k): _encode(obj[k]) for k in sorted(obj)}
    if isinstance(obj, list):
        return [_encode(x) for x in obj]
    return obj


def _decode(obj):
    if isinstance(obj, dict):
        if _ARR in obj:
            dtype, shape, buf = obj[_ARR]
            if dtype == "bfloat16":
                bits = np.frombuffer(buf, np.uint16).reshape(shape)
                return torch.from_numpy(bits.copy()).view(torch.bfloat16)
            return np.frombuffer(buf, np.dtype(dtype)).reshape(shape)
        if _TUP in obj:
            return tuple(_decode(x) for x in obj[_TUP])
        return {k: _decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(x) for x in obj]
    return obj


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}.msgpack")


def save_checkpoint(directory: str, step: int, tree) -> str:
    """Write ``tree`` as ``step_<step>.msgpack`` in ``directory`` (made if
    missing), atomically; returns the file's path."""
    import msgpack

    os.makedirs(directory, exist_ok=True)
    payload = msgpack.packb(_encode(tree), use_bin_type=True)
    final = _path(directory, step)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        f.write(payload)
    os.replace(tmp, final)
    return final


def latest_step(directory: str) -> int | None:
    """The highest step checkpointed in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [
        int(f[len("step_"):-len(".msgpack")])
        for f in os.listdir(directory)
        if f.startswith("step_") and f.endswith(".msgpack")
    ]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int | None = None):
    """``(step, tree)`` of ``step`` (default: the latest) in ``directory``."""
    import msgpack

    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    with open(_path(directory, step), "rb") as f:
        return step, _decode(msgpack.unpackb(f.read(), raw=False))
