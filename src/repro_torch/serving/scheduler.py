"""Continuous-batching serving scheduler of the port: the counterpart of
``repro.serving.scheduler``.

A fixed pool of ``n_slots`` decode slots advances in lock-step, one
decode wave a step over all slots, each slot at its own position with
``kv_len = pos + 1``; a finished slot is refilled from the queue
mid-flight by a one-slot prefill written into the stacked cache, while
the other slots keep their state.  Greedy decoding; an idle slot still
runs its lane of the wave (its outputs are ignored); prompts are padded
up the bucket ladder (``serving.buckets``), except for the recurrent
families (``ssm``, ``hybrid``), whose state would fold the pad in.

Where the reference differs, and why:

* The reference stacks a batch-1 cache per slot and runs
  ``jax.vmap(decode_one)`` over the slots as one jitted, stitched call.
  The port's stacked cache is one ``Model.init_cache(n_slots, max_len)``
  and a wave is one ``Model.decode_step`` with a [n_slots] position
  tensor (each row writes and attends its own rows).  The MoE layer
  routes each slot's token in its own group (``moe_impl="sort"``, the
  Granite configs'), as the vmap does.
* The reference donates the cache leaves to each wave so XLA updates
  them in place; the port's cache is written in place (``slot_cache``
  views for a slot's prefill, ``cache_write`` and the Mamba states'
  copies in a wave).
* On the card a wave -- the layer loop and the argmax -- is one
  captured CUDA graph, replayed at each wave (``core/capture.py``), the
  counterpart of the reference's one dispatch a wave.  The host writes
  the wave's tokens and positions and reads back [n_slots] token ids,
  nothing else.  ``capture=False`` runs the wave eagerly (to measure
  the difference); a capture that fails raises.
* ``plan_cache`` and ``autotune`` select the model's set of compiled
  functions (``Model.with_plan``): the reference passes them to its
  stitched prefill and wave; the port stitches inside ``Model``, one
  compiled function a layer half, so the model keeps one set a
  (``plan_cache``, ``autotune``).  ``ServeStats.plan_cache_hits`` and
  ``plan_cache_misses`` are summed from the set's compiled reports, as
  in the reference.  A compile that measures (``autotune``) on the card
  runs in the wave's warm-up, before its capture.  The reference's
  ``background`` and ``canary`` options and the stats they fill have no
  counterpart: their modules are not ported.
* The reference dispatches each prefill as one jitted call a bucket
  shape.  On the card a bucketed prefill (the dense and ``moe``
  families) is one captured CUDA graph a bucket, replayed at each
  prefill of that bucket (``_prefill_staged``): it prefills into a
  batch-1 cache of the bucket's rows in the graph's memory, zeroes the
  slot's rows past them and copies them into the slot, the slot and the
  true last position passed as device ints, and returns the greedy
  token at that position -- one int read by the host, never the [1, S,
  padded_vocab] logits.  The bucket graphs share one memory pool: each
  replay's token is read before the next replay.  Its compiles and
  measured tuning run in the graph's warm-up.  The recurrent families
  keep exact prompt lengths (a pad token would fold into the state), so
  a graph a length would hardly be replayed: their prefill runs eagerly
  through the model's compiled functions, as it does with
  ``capture=False`` (and on the CPU, where ``capture=True`` runs the
  graph's function eagerly).
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core.capture import CapturedStep, graphed
from ..models.model import RECURRENT, Model
from .buckets import Buckets, pad_tokens


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] int
    max_new: int
    out: list[int] = field(default_factory=list)
    pos: int = 0                  # next cache position
    done: bool = False
    t_submit: float = 0.0         # perf_counter at submit (TTFT anchor)


def _pct(xs: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


@dataclass
class ServeStats:
    prefills: int = 0
    decode_waves: int = 0
    tokens_out: int = 0
    wall_s: float = 0.0
    # -- shape canonicalization / replans ------------------------------------
    shape_hits: int = 0        # calls on an already-compiled shape
    shape_misses: int = 0      # ...that traced and planned fresh (replans)
    compile_s: float = 0.0     # wall spent inside cold (first-shape) calls
    # -- persistent plan cache (from StitchReport) ---------------------------
    plan_cache_hits: int = 0   # compiled signatures loaded from disk
    plan_cache_misses: int = 0  # ...planned from scratch
    tune_s: float = 0.0        # seconds the compiles spent measuring
    # -- latency samples ------------------------------------------------------
    ttft_s: list = field(default_factory=list)   # submit -> first token
    wave_s: list = field(default_factory=list)   # per decode wave
    prefill_s: list = field(default_factory=list)  # (length, s) a prefill
    # -- captured prefill (one CUDA graph a bucket) ---------------------------
    prefill_captures: int = 0   # bucket graphs captured
    prefill_replays: int = 0    # prefills answered by a replay
    prefill_pool_bytes: int = 0  # device memory the graphs' pool reserved
    steady_wall_s: float = 0.0  # wall in warm (already-compiled) calls
    steady_tokens: int = 0      # tokens produced by warm calls

    @property
    def tok_per_s(self) -> float:
        return self.tokens_out / self.wall_s if self.wall_s else 0.0

    @property
    def tok_per_s_steady(self) -> float:
        """Throughput excluding compile time: tokens from warm calls
        over warm-call wall."""
        return (self.steady_tokens / self.steady_wall_s
                if self.steady_wall_s else 0.0)

    @property
    def hit_rate(self) -> float:
        n = self.shape_hits + self.shape_misses
        return self.shape_hits / n if n else 0.0

    @property
    def replans(self) -> int:
        return self.shape_misses

    @property
    def p50_ttft_s(self) -> float:
        return _pct(self.ttft_s, 50)

    @property
    def p99_ttft_s(self) -> float:
        return _pct(self.ttft_s, 99)

    @property
    def p50_tok_s(self) -> float:
        return _pct(self.wave_s, 50)

    @property
    def p99_tok_s(self) -> float:
        return _pct(self.wave_s, 99)

    def summary(self) -> str:
        return (f"{self.prefills} prefills, {self.decode_waves} decode "
                f"waves, {self.tokens_out} tokens | shape hit rate "
                f"{self.hit_rate:.1%} ({self.replans} replans) | "
                f"plan-cache {self.plan_cache_hits}h/"
                f"{self.plan_cache_misses}m | ttft "
                f"p50/p99 {self.p50_ttft_s * 1e3:.1f}/"
                f"{self.p99_ttft_s * 1e3:.1f}ms | tok p50/p99 "
                f"{self.p50_tok_s * 1e3:.1f}/{self.p99_tok_s * 1e3:.1f}ms"
                f" | {self.tok_per_s:.1f} tok/s "
                f"({self.tok_per_s_steady:.1f} steady) | prefill graphs "
                f"{self.prefill_captures} ({self.prefill_replays} replays, "
                f"pool {self.prefill_pool_bytes / 2 ** 20:.1f} MiB)")


class ContinuousBatcher:
    """``submit`` prompts, then ``run`` until every request is served.

    ``mdl`` is the port's ``Model`` (its device is where the slots live);
    ``params`` its weights, read in place at every wave.  ``plan_cache``
    (a directory) and ``autotune`` select the model's compiled functions
    (``Model.with_plan``; by default the model's own)."""

    def __init__(self, mdl: Model, params: dict, *, n_slots: int = 4,
                 max_len: int = 256, eos_id: int | None = None,
                 buckets: Buckets | None = None, pad_id: int = 0,
                 capture: bool = True, plan_cache: str | None = None,
                 autotune: bool = False):
        mdl = mdl.with_plan(
            plan_cache if plan_cache is not None else mdl.plan_cache,
            autotune or mdl.autotune)
        self.mdl = mdl
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * n_slots
        self._ids = itertools.count()
        self.stats = ServeStats()
        self.buckets = buckets if buckets is not None else Buckets.from_env()
        # right-padding is masked for attention caches but folds into a
        # recurrent state -- exact lengths for ssm/hybrid prefill.
        self._pad_prompts = mdl.cfg.family not in RECURRENT
        self._seen_shapes: set[tuple] = set()
        self._compiles = {"prefill": 0, "decode": 0}
        self.cache = mdl.init_cache(n_slots, max_len)

        V = mdl.cfg.vocab_size

        def wave(toks, poss):
            logits, _ = mdl.decode_step(params, self.cache, toks, poss,
                                        kv_len=poss + 1)
            logits = logits[:, -1, :V]
            return logits, logits.argmax(-1)

        self._wave = (graphed(wave, mdl.device,
                              restore=mdl.recurrent_state(self.cache))
                      if capture else wave)
        #: {bucket length: the bucket's prefill (a ``CapturedStep`` on the
        #: card)}; None where prefills run eagerly (``capture=False``, the
        #: recurrent families)
        self._prefills: dict | None = (
            {} if capture and self._pad_prompts else None)
        self._pool = (torch.cuda.graph_pool_handle()
                      if self._prefills is not None
                      and mdl.device.type == "cuda" else None)

    # -- client API -----------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int = 16) -> int:
        if len(prompt) + max_new > self.max_len:
            raise ValueError(f"request of {len(prompt)} prompt tokens and "
                             f"{max_new} new ones exceeds a slot of "
                             f"{self.max_len} rows")
        req = Request(next(self._ids), np.asarray(prompt, np.int64), max_new,
                      t_submit=time.perf_counter())
        self.queue.append(req)
        return req.rid

    def run(self) -> dict[int, list[int]]:
        """Drive until queue + slots drain.  Returns rid -> generated ids."""
        t0 = time.perf_counter()
        results: dict[int, list[int]] = {}
        self._fill_slots()
        while any(s is not None for s in self.slots):
            self._decode_step()
            for i, req in enumerate(self.slots):
                if req is not None and req.done:
                    results[req.rid] = req.out
                    self.slots[i] = None
            self._fill_slots()
        self.stats.wall_s += time.perf_counter() - t0
        self._refresh_plan_stats()
        return results

    def _refresh_plan_stats(self) -> None:
        """Plan-cache hits and misses and the seconds spent measuring,
        summed over the compiled signatures' reports."""
        reports = self.mdl.reports()
        self.stats.plan_cache_hits = sum(r.plan_cache_hit for r in reports)
        self.stats.plan_cache_misses = sum(not r.plan_cache_hit
                                           for r in reports)
        self.stats.tune_s = sum(r.tune_s for r in reports)

    def compile_counts(self) -> dict[str, int]:
        """Prefill and decode calls that compiled new signatures of the
        model's functions (a 7-length prompt mix compiles once per
        bucket, the wave once), and the prefill graphs captured (one a
        bucket on the card)."""
        return dict(self._compiles, prefill_graphs=sum(
            isinstance(s, CapturedStep) and s.graph is not None
            for s in (self._prefills or {}).values()))

    # -- internals ---------------------------------------------------------------
    def _note_call(self, shape_key: tuple, dt: float, tokens: int) -> None:
        if shape_key in self._seen_shapes:
            self.stats.shape_hits += 1
            self.stats.steady_wall_s += dt
            self.stats.steady_tokens += tokens
        else:
            self._seen_shapes.add(shape_key)
            self.stats.shape_misses += 1
            self.stats.compile_s += dt

    def _fill_slots(self) -> None:
        for i in range(self.n_slots):
            if self.slots[i] is None and self.queue:
                req = self.queue.popleft()
                self._prefill_slot(i, req)
                self.slots[i] = req

    def _prefill_into(self, i: int, toks: np.ndarray) -> torch.Tensor:
        """Zero slot ``i``'s rows of the stacked cache and prefill ``toks``
        [S] into them, in place (the reference's ``st.at[i].set(c)`` of
        a fresh one-slot cache) -> logits [1, S, padded_vocab]."""
        view = self.mdl.slot_cache(self.cache, i)
        for t in pytree.tree_leaves(view):
            t.zero_()
        before = self.mdl.n_compiled
        tokens = torch.from_numpy(np.asarray(toks, np.int64)[None, :]).to(
            self.mdl.device)
        logits, _ = self.mdl.prefill(self.params, tokens, view)
        self._compiles["prefill"] += self.mdl.n_compiled > before
        return logits

    def _prefill_staged(self, tokens: torch.Tensor, slot, last):
        """The captured prefill's function: ``tokens`` [1, S] into a
        batch-1 cache of S rows, then into slot ``slot``'s rows (those
        past S zeroed, as a fresh cache has them) -> the greedy token at
        position ``last``, a 0-d device tensor.  ``slot`` and ``last`` are
        ints or 0-d device tensors (the graph's inputs)."""
        dev = self.mdl.device
        slot = torch.as_tensor(slot, device=dev).reshape(1)
        last = torch.as_tensor(last, device=dev).reshape(1)
        S = tokens.shape[1]
        stage = {}
        for name, t in self.cache.items():
            L, _, H, _, D = t.shape
            stage[name] = t.new_empty((L, 1, H, S, D))
        logits, _ = self.mdl.prefill(self.params, tokens, stage)
        for name, t in self.cache.items():
            t[:, :, :, S:].index_fill_(1, slot, 0.0)
            t[:, :, :, :S].index_copy_(1, slot, stage[name])
        row = logits[0].index_select(0, last)[0, : self.mdl.cfg.vocab_size]
        return row.argmax()

    def _prefill_token(self, i: int, toks: np.ndarray, true_len: int) -> int:
        """Prefill ``toks`` into slot ``i`` -> the greedy token at the
        *true* last prompt position (the causal mask makes the padded
        tail invisible to it): through the bucket's graph where there is
        one, else eagerly (``_prefill_into``)."""
        if self._prefills is None:
            logits = self._prefill_into(i, toks)
            return int(logits[0, true_len - 1,
                              : self.mdl.cfg.vocab_size].argmax())
        S = int(toks.shape[-1])
        step = self._prefills.get(S)
        if step is None:
            step = graphed(self._prefill_staged, self.mdl.device,
                           pool=self._pool)
            self._prefills[S] = step
        before = self.mdl.n_compiled
        tokens = torch.from_numpy(np.asarray(toks, np.int64)[None, :]).to(
            self.mdl.device)
        fresh = isinstance(step, CapturedStep) and step.graph is None
        tok = int(step(tokens, i, true_len - 1))  # the prefill's one read
        self._compiles["prefill"] += self.mdl.n_compiled > before
        if isinstance(step, CapturedStep):
            self.stats.prefill_replays += 1
            if fresh:
                self.stats.prefill_captures += 1
                self.stats.prefill_pool_bytes += step.pool_bytes
        return tok

    def _prefill_slot(self, i: int, req: Request) -> None:
        t0 = time.perf_counter()
        true_len = len(req.prompt)
        if self._pad_prompts:
            plen = self.buckets.pad_len(true_len, cap=self.max_len)
            toks = pad_tokens(req.prompt, plen, pad_id=self.pad_id)
        else:
            toks = req.prompt
        first = self._prefill_token(i, toks, true_len)
        dt = time.perf_counter() - t0
        self.stats.prefill_s.append((int(toks.shape[-1]), dt))
        self._note_call(("prefill", int(toks.shape[-1])), dt, tokens=1)
        req.out.append(first)
        req.pos = true_len
        self.stats.prefills += 1
        self.stats.tokens_out += 1
        self.stats.ttft_s.append(time.perf_counter() - req.t_submit)
        self._check_done(req)

    def _decode_step(self) -> None:
        toks = np.zeros((self.n_slots, 1), np.int64)
        poss = np.zeros((self.n_slots,), np.int64)
        active = []
        for i, req in enumerate(self.slots):
            if req is None or req.done:
                continue
            toks[i, 0] = req.out[-1]
            poss[i] = req.pos
            active.append(i)
        if not active:
            return
        t0 = time.perf_counter()
        dev = self.mdl.device
        before = self.mdl.n_compiled
        _, nxt = self._wave(torch.from_numpy(toks).to(dev),
                            torch.from_numpy(poss).to(dev))
        self._compiles["decode"] += self.mdl.n_compiled > before
        nxt = nxt.cpu().numpy()  # the wave's one read: [n_slots] token ids
        dt = time.perf_counter() - t0
        self.stats.decode_waves += 1
        self.stats.wave_s.append(dt)
        self._note_call(("decode",), dt, tokens=len(active))
        for i in active:
            req = self.slots[i]
            req.out.append(int(nxt[i]))
            req.pos += 1
            self.stats.tokens_out += 1
            self._check_done(req)

    def _check_done(self, req: Request) -> None:
        if len(req.out) >= req.max_new or \
                (self.eos_id is not None and req.out[-1] == self.eos_id) or \
                req.pos + 1 >= self.max_len:
            req.done = True
