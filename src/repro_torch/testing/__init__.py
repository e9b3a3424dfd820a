"""Test support: deterministic fault injection for the plan cache and the
measured tuner (``repro_torch.testing.faults``)."""
from . import faults

__all__ = ["faults"]
