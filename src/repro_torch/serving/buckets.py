"""Bucketed shape canonicalization for serving (a copy of the JAX
package's framework-free ``repro.serving.buckets``; the port never imports
``repro``).

Live traffic is Zipfian over request shapes: thousands of distinct
prompt lengths, each of which would otherwise be a fresh trace -> plan
-> emit cycle (and a fresh plan-cache signature).  Padding batch /
prompt / KV lengths up to a small ladder of buckets collapses that mix
onto a handful of canonical shapes, so after a short warmup every
request hits an already-compiled stitched plan -- the paper's §7
tune-once-run-many regime, where plan cost amortizes across the fleet.

Padding is functionally inert for causal-attention prefill:

* logits are read at the *true* last prompt position, which (causal
  mask) never attends to the padded tail;
* KV rows written for pad positions sit beyond the decode frontier --
  decode at position ``p`` masks with ``kv_len = p + 1`` and *writes*
  row ``p`` before any later step can read it, so a padded row is
  always overwritten before it is ever attended to.

Recurrent caches (ssm / hybrid prefill) fold every token into the
state, so right-padding is NOT inert there; the scheduler keeps exact
prompt lengths for those families (their decode shapes are fixed-size
state, so only prefill retraces).

The ladder defaults to powers of two from ``min_bucket`` and can be
pinned with ``REPRO_SERVE_BUCKETS="16,48,128"`` (lengths beyond the
last edge fall back to powers of two so arbitrary requests still
canonicalize).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

ENV_BUCKETS = "REPRO_SERVE_BUCKETS"


@dataclass(frozen=True)
class Buckets:
    """A padding ladder for sequence-like dimensions."""
    edges: tuple[int, ...] = ()   # explicit ascending ladder; () = pow2 only
    min_bucket: int = 8           # floor: tiny prompts share one bucket

    @classmethod
    def from_env(cls) -> "Buckets":
        """Ladder from ``$REPRO_SERVE_BUCKETS`` (comma-separated ints),
        or the default power-of-two ladder when unset/empty."""
        spec = os.environ.get(ENV_BUCKETS, "").strip()
        if not spec:
            return cls()
        edges = sorted({int(tok) for tok in spec.split(",") if tok.strip()})
        if not edges or edges[0] <= 0:
            raise ValueError(
                f"{ENV_BUCKETS} must be positive ints, got {spec!r}")
        return cls(edges=tuple(edges))

    def bucket(self, n: int) -> int:
        """Smallest bucket >= ``n``: the explicit ladder first, then
        powers of two, so any length maps to a canonical one."""
        n = max(1, int(n))
        for e in self.edges:
            if n <= e:
                return e
        floor = max(self.min_bucket, self.edges[-1] if self.edges else 1)
        return max(1 << (n - 1).bit_length(), floor)

    def pad_len(self, n: int, cap: int | None = None) -> int:
        """``bucket(n)`` clamped to ``cap`` (a slot's ``max_len``): a
        bucket may not overrun the allocated cache.  ``n`` itself must
        fit ``cap``."""
        b = self.bucket(n)
        if cap is not None:
            b = min(b, int(cap))
        return b


def pad_tokens(tokens: np.ndarray, length: int,
               pad_id: int = 0) -> np.ndarray:
    """Right-pad int token ids ([S] or [B, S]) to ``length``."""
    tokens = np.asarray(tokens)
    cur = tokens.shape[-1]
    if cur > length:
        raise ValueError(f"tokens of length {cur} exceed bucket {length}")
    if cur == length:
        return tokens
    width = [(0, 0)] * (tokens.ndim - 1) + [(0, length - cur)]
    return np.pad(tokens, width, constant_values=pad_id)
