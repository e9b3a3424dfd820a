"""Mamba2-370m: attention-free SSD [arXiv:2405.21060; unverified]
(copied from the JAX package)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, d_inner=2048,
    norm="rmsnorm",
    supports_long_context=True,        # O(1)-state decode
)
