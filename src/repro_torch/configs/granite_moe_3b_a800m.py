"""Granite-3.0-3B-A800M MoE: 40 experts top-8 [hf:ibm-granite]
(copied from the JAX package)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    n_experts=40, top_k=8,
    # sort/scatter dispatch; moe_ep is the JAX package's expert layout
    # over its mesh, which the port (one card, no mesh) does not read
    moe_impl="sort", moe_ep="replicate",
    activation="silu", norm="rmsnorm",
)
