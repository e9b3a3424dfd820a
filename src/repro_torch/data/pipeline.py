"""Deterministic synthetic data pipeline, sharded per host.

The port's own copy of ``repro.data.pipeline`` (numpy only; the port
never imports ``repro``): the same seed gives the same batches, bit for
bit.  Batches are numpy arrays; the trainer moves them to the device.

Production shape: an infinite, seedable, *restartable* token stream.
``state`` is just ``(seed, step)`` — a checkpoint stores it and a
restarted job resumes mid-epoch with zero drift (the generator is a
counter-based RNG, so batch ``t`` is reproducible from scratch).  For
multi-host runs each host materializes only its shard of the global
batch (``_host_batch_size``).

The synthetic distribution is a Zipf-ish unigram mix with Markov
bigram structure, so cross-entropy has signal (models can overfit it,
which the convergence tests exploit).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..configs.base import ArchConfig


@dataclass
class DataConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    n_hosts: int = 1
    host_id: int = 0


@dataclass
class DataState:
    seed: int
    step: int

    def as_dict(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_dict(cls, d) -> "DataState":
        return cls(int(d["seed"]), int(d["step"]))


class SyntheticTokens:
    """Counter-based deterministic token batches."""

    def __init__(self, cfg: DataConfig, arch: ArchConfig):
        self.cfg = cfg
        self.arch = arch
        self.state = DataState(cfg.seed, 0)
        V = arch.vocab_size
        # fixed Zipf unigram (the reference also draws an embedding table
        # here that no batch uses)
        self._unigram = 1.0 / np.arange(1, V + 1) ** 1.1
        self._unigram /= self._unigram.sum()

    def _host_batch_size(self) -> int:
        gb, n = self.cfg.global_batch, self.cfg.n_hosts
        base = gb // n
        return base + (1 if self.cfg.host_id < gb % n else 0)

    def batch_at(self, step: int) -> dict:
        """Reproducible batch for global step ``step`` (host shard)."""
        cfg, arch = self.cfg, self.arch
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 17 + cfg.host_id)
        B = self._host_batch_size()
        S = cfg.seq_len
        if arch.frontend == "audio":
            frames = rng.standard_normal((B, S, arch.frontend_dim)).astype(np.float32)
            labels = rng.integers(0, arch.vocab_size, (B, S)).astype(np.int32)
            return {"frames": frames, "labels": labels}
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.choice(arch.vocab_size, size=B, p=self._unigram)
        # cheap Markov structure: next token correlated with embedding sim
        for t in range(1, S + 1):
            jump = rng.random(B) < 0.75
            nxt = rng.choice(arch.vocab_size, size=B, p=self._unigram)
            toks[:, t] = np.where(jump, (toks[:, t - 1] * 31 + 7)
                                  % arch.vocab_size, nxt)
        out = {"tokens": toks}
        if arch.frontend == "vision":
            out["vision_embeds"] = rng.standard_normal(
                (B, arch.n_vision_tokens, arch.d_model)).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> dict:
        b = self.batch_at(self.state.step)
        self.state = DataState(self.state.seed, self.state.step + 1)
        return b

    def restore(self, state: DataState) -> None:
        self.state = state
