"""Deterministic synthetic data pipeline (a numpy copy of ``repro.data``)."""
from .pipeline import DataConfig, DataState, SyntheticTokens

__all__ = ["DataConfig", "DataState", "SyntheticTokens"]
