"""Architecture configuration schema + registry.

A copy of ``repro/configs/base.py`` (``ArchConfig`` :55): the JAX
package's configs import no jax, but importing them loads ``repro``,
which does, so this package keeps its own. Same fields, same
``head_dim`` / ``padded_vocab`` / ``subquadratic`` / ``param_count`` /
``active_param_count``.

Every architecture of ``ARCH_IDS`` is ported: the dense family
(h2o-danube-1.8b with a sliding window, stablelm-3b and granite-34b with
full attention), the MoE family (olmoe-1b-7b, moonshot-v1-16b-a3b,
dbrx-132b), the hybrid (hymba-1.5b), xLSTM (xlstm-350m), VLM
(phi-3-vision-4.2b) and audio (hubert-xlarge) families.
"""

from __future__ import annotations

import dataclasses
import importlib

__all__ = [
    "MoeConfig",
    "SsmConfig",
    "XlstmConfig",
    "ArchConfig",
    "ARCH_IDS",
    "PORTED_ARCH_IDS",
    "get_config",
    "get_smoke_config",
]


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    first_dense: bool = False
    capacity_factor: float = 1.25
    group_size: int = 256


@dataclasses.dataclass(frozen=True)
class SsmConfig:
    state_dim: int = 16
    conv_width: int = 4
    expand: int = 2
    chunk: int = 256
    scan_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class XlstmConfig:
    slstm_period: int = 6
    proj_factor: float = 2.0
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    source: str                  # citation for the configuration
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0              # 0 -> d_model // n_heads
    moe: MoeConfig | None = None
    ssm: SsmConfig | None = None
    xlstm: XlstmConfig | None = None
    window: int | None = None    # sliding-window attention width
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0        # partial rotary (stablelm)
    causal: bool = True          # False => bidirectional encoder
    decoder: bool = True         # False => no decode shapes (hubert)
    vlm_patches: int = 0
    vlm_d_vision: int = 0
    audio_frontend: bool = False
    d_frame: int = 0
    norm_eps: float = 1e-5
    q_chunk: int = 1024          # the JAX chunked-attention q block
    remat: bool = True
    sharding_overrides: tuple = ()

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab + 127) // 128) * 128

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k: bounded attention state per token
        (``repro/configs/base.py:94``)."""
        if self.family in ("ssm",):
            return True
        if self.family == "hybrid":
            return True  # SSM heads + SWA rolling buffer
        return self.window is not None

    def param_count(self) -> int:
        """Analytic parameter count (``repro/configs/base.py:101``; the
        final norm is not counted there either, and a ``first_dense``
        layer 0 counts as an MoE layer)."""
        d, L, v = self.d_model, self.n_layers, self.padded_vocab
        dh = self.head_dim
        total = 2 * v * d  # in+out embeddings
        att = d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh \
            + self.n_heads * dh * d
        per_layer = att + 2 * d  # norms
        if self.moe is not None:
            e = self.moe
            per_layer += d * e.n_experts
            per_layer += (e.n_experts + e.n_shared) * 3 * d * e.d_expert
        elif self.d_ff:
            per_layer += 3 * d * self.d_ff
        if self.family == "ssm":
            per_layer = 2 * d + 4 * d * int(d * (self.xlstm.proj_factor
                                                 if self.xlstm else 2.0))
        if self.family == "hybrid" and self.ssm is not None:
            di = self.ssm.expand * d
            per_layer += 2 * d * di + di * (2 * self.ssm.state_dim + 2) + di * d
        return total + L * per_layer

    def active_param_count(self) -> int:
        """Active params per token, MoE: top_k + shared experts only
        (``repro/configs/base.py:123``)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        full = self.param_count()
        expert_p = 3 * self.d_model * e.d_expert
        inactive = (e.n_experts - e.top_k) * expert_p * self.n_layers
        return full - inactive


ARCH_IDS = (
    "hymba_1p5b",
    "phi3_vision_4p2b",
    "dbrx_132b",
    "moonshot_v1_16b_a3b",
    "xlstm_350m",
    "hubert_xlarge",
    "h2o_danube_1p8b",
    "olmoe_1b_7b",
    "granite_34b",
    "stablelm_3b",
)
PORTED_ARCH_IDS = ARCH_IDS

_ALIASES = {
    "hymba-1.5b": "hymba_1p5b",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "dbrx-132b": "dbrx_132b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "xlstm-350m": "xlstm_350m",
    "hubert-xlarge": "hubert_xlarge",
    "h2o-danube-1.8b": "h2o_danube_1p8b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "granite-34b": "granite_34b",
    "stablelm-3b": "stablelm_3b",
}


def _module(arch_id: str):
    arch_id = _ALIASES.get(arch_id, arch_id)
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).config()


def get_smoke_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).smoke_config()
