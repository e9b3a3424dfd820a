"""Serving substrate: bucketed shape canonicalization and the
continuous-batching scheduler."""
from .buckets import Buckets, pad_tokens
from .scheduler import ContinuousBatcher, Request, ServeStats

__all__ = ["Buckets", "ContinuousBatcher", "Request", "ServeStats",
           "pad_tokens"]
