"""Optimizers in plain PyTorch (the counterpart of ``repro.optim``)."""
from .adamw import AdamWConfig, apply, compress_grads, global_norm, init, schedule

__all__ = ["AdamWConfig", "apply", "compress_grads", "global_norm", "init",
           "schedule"]
