"""Serving substrate: bucketed shape canonicalization."""
from .buckets import Buckets, pad_tokens

__all__ = ["Buckets", "pad_tokens"]
