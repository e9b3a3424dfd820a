"""HuBERT-XLarge encoder (w2v2 arch) [arXiv:2106.07447; unverified].

Encoder-only: no decode shapes.  The 7-layer conv feature extractor is a
STUB: the inputs are frame features of dim ``frontend_dim`` (the data
pipeline's ``frames``), which ``feat_proj`` maps to d_model.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="encoder",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab_size=504,
    activation="gelu_mlp", norm="layernorm",
    frontend="audio", frontend_dim=512,
    causal=False, supports_decode=False,
)
