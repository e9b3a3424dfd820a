"""The models in PyTorch, compiled by ``stitched_jit``."""
from .model import Model, build_model

__all__ = ["Model", "build_model"]
