"""Mistral-Nemo-Base-2407 (12B), 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072,
    activation="silu", norm="rmsnorm",
)
