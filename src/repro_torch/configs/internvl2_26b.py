"""InternVL2-26B language backbone (InternLM2-20B) [arXiv:2404.16821; hf].

The InternViT-6B vision tower is a STUB: the batch carries precomputed
patch embeddings (``launch.steps.batch_specs``'s ``vision_embeds``),
which replace the leading token embeddings.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92553,
    activation="silu", norm="rmsnorm",
    frontend="vision", n_vision_tokens=256,
)
