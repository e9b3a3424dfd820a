"""Architecture configs (copied from the JAX package, not imported)."""
from .base import ARCH_IDS, ArchConfig, get_config

__all__ = ["ARCH_IDS", "ArchConfig", "get_config"]
