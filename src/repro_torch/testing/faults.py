"""Deterministic fault injection (the counterpart of
``repro.testing.faults``, the same points, grammar and environment name).

The plan cache and the measured tuner promise that a torn cache entry or
a wedged or crashing race never breaks a compile: a torn entry is
quarantined and re-planned, a wedged race times out and the cost model's
partition is served, a crashed branch is disqualified and the race
commits a winner from the others.  Proving that requires *causing* each
failure on demand, reproducibly.  This module provides the named
injection points the reference's pipeline consults at its fault-prone
seams; the port fires ``cache_corrupt`` (``core/plan_cache.py``),
``race_crash`` and ``tuner_hang`` (``core/autotune.py``).  The others are
parsed and armed alike, for the guard's fallback ladder still to come:

  ``emit_fail``         group emission raises (Pallas lowering error)
  ``anchor_emit_fail``  an *anchored* group's emission raises, dropping
                        that group one rung (anchored -> stitched)
  ``cache_corrupt``     a plan-cache store writes a torn/garbage entry
  ``race_crash``        one autotune race branch crashes when executed
  ``numeric_mismatch``  shadow verification sees a silently-wrong kernel
  ``tuner_hang``        a measured race wedges (sleeps) until a watchdog
  ``shard_spec_fail``   a stitch group fails the sharded-emission spec
                        check (bad / non-divisible PartitionSpec), so
                        that group degrades to the per-pattern rung
                        while sibling groups stay stitched
  ``verify_flake``      the canary's shadow verification reports a
                        mismatch (intermittent with ``times=N``); the
                        site passes ``seam=serve`` / ``seam=burn_in``
                        so a spec can target live traffic or the
                        hot-swap burn-in specifically
  ``swap_crash``        a background rerace crashes at the hot-swap
                        commit seam (after the race, before the swap)
  ``health_corrupt``    a ``PlanHealth`` save writes a torn/garbage
                        ``health.json`` (recovered on next load)

Faults are armed either via the ``REPRO_FAULTS`` environment variable
or programmatically with the ``inject`` context manager (tests).  The
spec grammar is ``point[:key=value[,key=value...]]`` with multiple
points separated by ``;``::

    REPRO_FAULTS="emit_fail:group=1"
    REPRO_FAULTS="tuner_hang:sleep=5;race_crash"

Every fault fires a bounded number of times (``times=N``, default 1;
``times=-1`` means unlimited), so an injected failure exercises the
degradation path once and the pipeline's recovery runs clean -- the
property the fault-matrix CI leg asserts.  Parameters other than
``times``/``sleep``/``branch`` are matched against the context keywords the
injection site passes to :func:`fire` (e.g. ``group=1`` only fires for
the stitch group with index 1).

This module is dependency-free and safe to import from any layer.
"""
from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field

#: Environment variable holding the armed fault spec.
ENV_FAULTS = "REPRO_FAULTS"

#: The named injection points the pipeline consults.
POINTS = ("emit_fail", "anchor_emit_fail", "cache_corrupt", "race_crash",
          "numeric_mismatch", "tuner_hang", "shard_spec_fail",
          "verify_flake", "swap_crash", "health_corrupt")

#: Spec keys that configure the fault itself rather than match context.
#: ``branch`` picks the branch ``race_crash`` crashes: the reference
#: matches it against the site's context, which names no branch, so its
#: ``race_crash:branch=N`` never fires; here it configures, and fires.
_CONFIG_KEYS = ("times", "sleep", "branch")


@dataclass
class Fault:
    """One armed injection point."""

    point: str
    params: dict = field(default_factory=dict)
    remaining: int = 1          # fires left; -1 = unlimited
    fired: int = 0              # times this fault actually fired

    def sleep_s(self, default: float = 30.0) -> float:
        try:
            return float(self.params.get("sleep", default))
        except (TypeError, ValueError):
            return default


class FaultPlan:
    """The set of armed faults (parsed from one spec string)."""

    def __init__(self, spec: str | None = None):
        self.faults: dict[str, Fault] = _parse(spec or "")

    def get(self, point: str) -> Fault | None:
        return self.faults.get(point)


def _parse(spec: str) -> dict[str, Fault]:
    out: dict[str, Fault] = {}
    for item in spec.split(";"):
        item = item.strip()
        if not item:
            continue
        point, _, rest = item.partition(":")
        point = point.strip()
        if point not in POINTS:
            continue  # unknown points are ignored, never fatal
        params: dict = {}
        for kv in rest.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, _, v = kv.partition("=")
            params[k.strip()] = v.strip()
        try:
            times = int(params.get("times", 1))
        except (TypeError, ValueError):
            times = 1
        out[point] = Fault(point, params, remaining=times)
    return out


_lock = threading.Lock()
_plan: FaultPlan | None = None
_env_spec_seen: str | None = None


def _active() -> FaultPlan:
    """The live plan: programmatic injection wins; otherwise the env
    spec is (re)parsed whenever ``$REPRO_FAULTS`` changes."""
    global _plan, _env_spec_seen
    with _lock:
        env = os.environ.get(ENV_FAULTS, "")
        if _plan is None or (_env_spec_seen is not None
                             and env != _env_spec_seen):
            _plan = FaultPlan(env)
            _env_spec_seen = env
        return _plan


def reset(spec: str | None = None) -> FaultPlan:
    """Re-arm from ``spec`` (or from the environment when None)."""
    global _plan, _env_spec_seen
    with _lock:
        if spec is None:
            _plan = FaultPlan(os.environ.get(ENV_FAULTS, ""))
            _env_spec_seen = os.environ.get(ENV_FAULTS, "")
        else:
            _plan = FaultPlan(spec)
            _env_spec_seen = None  # pinned: env changes don't re-arm
        return _plan


def fire(point: str, **ctx) -> Fault | None:
    """Consume one firing of ``point`` if armed and the context matches.

    Returns the :class:`Fault` (so the site can read parameters like
    ``sleep``) or None.  Context matching: every fault parameter that is
    not a config key must equal ``str(ctx[key])`` -- a parameter naming
    a context key the site did not pass never fires (so ``group=2``
    cannot accidentally fire at a site that has no group).
    """
    plan = _active()
    with _lock:
        f = plan.get(point)
        if f is None or f.remaining == 0:
            return None
        for k, v in f.params.items():
            if k in _CONFIG_KEYS:
                continue
            if k not in ctx or str(ctx[k]) != str(v):
                return None
        if f.remaining > 0:
            f.remaining -= 1
        f.fired += 1
        return f


def armed(point: str) -> bool:
    """Is ``point`` armed with firings left (without consuming one)?"""
    f = _active().get(point)
    return f is not None and f.remaining != 0


@contextmanager
def inject(spec: str):
    """Arm ``spec`` for the duration of a ``with`` block (tests).

    Yields the :class:`FaultPlan` so the test can assert ``fired``
    counts.  Nested injections restore the outer plan on exit.
    """
    global _plan, _env_spec_seen
    with _lock:
        saved = (_plan, _env_spec_seen)
        _plan = FaultPlan(spec)
        _env_spec_seen = None
    try:
        yield _plan
    finally:
        with _lock:
            _plan, _env_spec_seen = saved
