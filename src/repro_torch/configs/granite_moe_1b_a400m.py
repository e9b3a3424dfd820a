"""Granite-3.0-1B-A400M MoE: 32 experts top-8 [hf:ibm-granite]
(copied from the JAX package)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    n_experts=32, top_k=8,
    # sort/scatter dispatch; moe_ep is the JAX package's expert layout
    # over its mesh, which the port (one card, no mesh) does not read
    moe_impl="sort", moe_ep="replicate",
    activation="silu", norm="rmsnorm",
)
