"""Gemma-7B: GeGLU, head_dim=256 [arXiv:2403.08295; hf].

The tanh-GELU gate is an *expensive element-wise op mid-chain* -- the
exact pattern class the paper's warp/block composition unlocks (§4.1).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab_size=256000,
    activation="gelu", norm="rmsnorm",
)
