"""Architecture configs (copied from the JAX package, not imported)."""
from .base import (ARCH_IDS, SHAPES, ArchConfig, ShapeCell, all_configs,
                   cell_applicable, get_config)

__all__ = ["ARCH_IDS", "SHAPES", "ArchConfig", "ShapeCell", "all_configs",
           "cell_applicable", "get_config"]
