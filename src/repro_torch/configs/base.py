"""Architecture config schema + registry (a copy of the JAX package's
framework-free ``repro.configs.base``; the port never imports ``repro``).

One ``<arch>.py`` per architecture defines ``CONFIG``; ``get_config``
resolves an id, ``all_configs`` the reference's ten, in its order.
``SHAPES`` holds the reference's four shape cells (``ShapeCell``) and
``cell_applicable`` its verdict on a config and a cell.  ``reduced()``
derives the smoke-test configuration (same family, tiny dims) the CPU
tests use.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    activation: str = "silu"    # silu (SwiGLU) | gelu (GeGLU) | gelu_mlp
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "einsum"    # "einsum" (GShard baseline) | "sort" (opt)
    moe_ep: str = "model"       # "model" (EP over TP axis) | "replicate"
    # SSM (Mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    d_inner: int = 0            # 0 -> 2 * d_model
    ssm_chunk: int = 64
    conv_width: int = 4
    # hybrid (Zamba2): shared attention block applied every N layers
    attn_every: int = 0
    # modality frontends (stub inputs per task spec)
    frontend: str = "none"      # none | audio | vision
    frontend_dim: int = 0       # audio: conv-stem feature dim
    n_vision_tokens: int = 0    # vlm: image token count
    # misc
    causal: bool = True
    rope_theta: float = 1e6
    max_seq: int = 524288
    norm_eps: float = 1e-6
    # capability flags (derived from family; see DESIGN.md §Arch-applicability)
    supports_decode: bool = True
    supports_long_context: bool = False  # sub-quadratic decode at 500k

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to 256 so the TP axis divides it (MaxText-style).
        Padded logit columns are masked to -inf inside the model."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def resolved_d_inner(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.resolved_d_inner // self.ssm_head_dim

    def reduced(self, **overrides) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 2 if self.attn_every == 0 else 4),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=32,
            d_ff=64 if self.n_experts else 256,
            vocab_size=512,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            d_inner=256 if self.ssm_state else 0,
            ssm_chunk=16,
            attn_every=2 if self.attn_every else 0,
            frontend_dim=32 if self.frontend == "audio" else 0,
            n_vision_tokens=8 if self.frontend == "vision" else 0,
            max_seq=256,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
ARCH_IDS = [
    "zamba2-1.2b", "internvl2-26b", "deepseek-67b", "mistral-nemo-12b",
    "llama3.2-3b", "gemma-7b", "hubert-xlarge", "mamba2-370m",
    "granite-moe-1b-a400m", "granite-moe-3b-a800m",
]

_MODULE_OF = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULE_OF:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_OF[arch_id]}")
    return mod.CONFIG


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


# ---------------------------------------------------------------------------
# assigned input shapes (the 4 LM shape cells)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ArchConfig, shape: ShapeCell) -> tuple[bool, str]:
    """(runnable?, reason-if-skipped) per DESIGN.md §Arch-applicability."""
    if shape.kind == "decode" and not cfg.supports_decode:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "pure full-attention arch: 500k decode needs sub-quadratic attention"
    return True, ""
