"""Zamba2-1.2B: Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf] (copied from the JAX package)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, d_inner=4096,
    attn_every=6,                      # shared attn block applied every 6 layers
    activation="gelu", norm="rmsnorm",
    supports_long_context=True,        # hybrid: SSM backbone, periodic attention
)
