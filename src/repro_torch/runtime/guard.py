"""The part of the guard layer the plan cache and the measured tuner use:
the port of ``repro.runtime.guard``'s error taxonomy, watchdog and poison
list (``src/repro/runtime/guard.py:47-61, 108-190, 325-445``).

* **Error taxonomy** -- ``GuardError``, ``EmitError`` (raised by nothing
  yet) and the two subclasses this slice raises: ``CacheCorruptError`` (a torn, truncated or tampered plan-cache
  entry, quarantined on load) and ``RaceTimeoutError`` (a measured race
  past its deadline).
* **Watchdog** -- ``with_watchdog`` bounds a measured race
  (``$REPRO_RACE_TIMEOUT_S``); a wedged measurement raises
  ``RaceTimeoutError`` instead of hanging the compile forever.
* **Poison list** -- ``PoisonList`` pins a graph signature to a fallback
  rung, in memory and (beside a plan cache) on disk; the plan cache
  refuses to load or store a pinned signature.  The rung names are the
  reference's ladder (``anchored`` -> ``stitched`` -> ``patterns`` ->
  ``baseline``).

Not ported yet (``ROADMAP.md`` A.8): the fallback ladder itself,
``VerifyPolicy`` and ``outputs_mismatch`` (shadow verification),
``RetryPolicy`` and ``CircuitBreaker``.  Until then a failed emission or
launch raises.

Only the standard library at import time.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time


# ---------------------------------------------------------------------------
# error taxonomy
# ---------------------------------------------------------------------------
class GuardError(RuntimeError):
    """Base class for every failure the guard layer contains."""


class EmitError(GuardError):
    """Group/pattern emission failed (raised by nothing in the port yet:
    its emission raises the underlying error until the ladder lands)."""


class CacheCorruptError(GuardError):
    """A plan-cache entry was torn, truncated or failed its checksum."""


class RaceTimeoutError(GuardError):
    """A measured race exceeded the watchdog deadline."""


# ---------------------------------------------------------------------------
# fallback ladder (rung names only: the ladder is not ported yet)
# ---------------------------------------------------------------------------
#: Rung 0: anchored megakernels (prologue/epilogue chains folded into a
#: compute anchor's own grid -- matmul/attention with fused chains).
RUNG_ANCHORED = "anchored"
#: Rung 1: the stitched megakernel (one generated kernel per group).
RUNG_STITCHED = "stitched"
#: Rung 2: per-pattern fused kernels (the group's members emitted
#: separately -- stitching lost, fusion kept).
RUNG_PATTERNS = "patterns"
#: Rung 3: the plain baseline (the traced graph op by op, no generated
#: kernel at all).
RUNG_BASELINE = "baseline"

#: Ladder order, fastest first.  Degradation only ever moves right.
RUNGS = (RUNG_ANCHORED, RUNG_STITCHED, RUNG_PATTERNS, RUNG_BASELINE)


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------
#: Environment variable bounding one measured race, in seconds.
#: 0 (or negative) disables the watchdog.
ENV_RACE_TIMEOUT = "REPRO_RACE_TIMEOUT_S"

#: Default measured-race deadline.  A race builds its branches' kernels
#: before the watchdog starts; what it bounds is the warm-up, capture and
#: timing of the branches -- seconds to a minute are normal, a wedge is
#: not.
DEFAULT_RACE_TIMEOUT_S = 300.0


def race_timeout_s() -> float:
    try:
        return float(os.environ.get(ENV_RACE_TIMEOUT,
                                    DEFAULT_RACE_TIMEOUT_S))
    except ValueError:
        return DEFAULT_RACE_TIMEOUT_S


_watchdog_local = threading.local()


def watchdog_cancelled() -> bool:
    """True inside a ``with_watchdog`` body whose caller already gave
    up on it.  Long-running watched work (a sleep loop, a sweep over
    many branches) should poll this at safe points and bail out, so an
    abandoned thread winds down instead of racing interpreter shutdown
    with device work."""
    ev = getattr(_watchdog_local, "cancelled", None)
    return ev is not None and ev.is_set()


def watchdog_sleep(seconds: float, step_s: float = 0.05) -> None:
    """``time.sleep`` in watchdog-aware slices: returns early once the
    surrounding watchdog abandoned this thread."""
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        if watchdog_cancelled():
            return
        time.sleep(min(step_s, max(0.0, deadline - time.monotonic())))


def with_watchdog(fn, timeout_s: float | None = None, *,
                  label: str = "measured race"):
    """Run ``fn()`` with a deadline; raise :class:`RaceTimeoutError` if
    it does not finish in ``timeout_s`` seconds.

    The work runs on a daemon thread so a wedged ``fn`` cannot block
    interpreter shutdown; on timeout the thread is abandoned (Python
    cannot kill it) and the *caller* regains control -- which is the
    property the tuner needs: a hung race disqualifies itself instead
    of wedging the worker.  Abandonment is signalled to the thread via
    :func:`watchdog_cancelled` so cooperative work can stop early.
    ``timeout_s`` None reads the environment; <= 0 disables the
    watchdog and calls ``fn`` inline.
    """
    if timeout_s is None:
        timeout_s = race_timeout_s()
    if timeout_s <= 0:
        return fn()
    box: dict = {}
    cancelled = threading.Event()

    def run() -> None:
        _watchdog_local.cancelled = cancelled
        try:
            if not cancelled.is_set():
                box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["error"] = e
        finally:
            _watchdog_local.cancelled = None

    t = threading.Thread(target=run, name="repro-watchdog", daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        cancelled.set()
        raise RaceTimeoutError(
            f"{label} exceeded the {timeout_s:g}s watchdog deadline")
    if "error" in box:
        raise box["error"]
    return box.get("value")


# ---------------------------------------------------------------------------
# poison list
# ---------------------------------------------------------------------------
class PoisonList:
    """Quarantined graph signatures pinned to a fallback rung.

    A condemned plan's signature lands here (in the reference, by shadow
    verification or a first-execution failure; in the port, until those
    are ported, by whoever calls ``pin``): the plan cache refuses to load
    or store entries for it, so the bad plan is never re-persisted or
    served from disk.

    With ``root`` set the list is shared across processes via an
    atomically-rewritten ``poison.json`` in that directory (the plan
    cache dir); without it the list is in-memory only.  File IO is
    best-effort: a read-only dir degrades to in-memory pinning, never
    to an exception on the serving path.

    The list is bounded (``max_entries`` / ``$REPRO_POISON_MAX``,
    oldest pin evicted first) and pins are no longer permanent:
    ``unpin`` lifts one, which is how the canary loop's probation
    re-admits a signature whose fault has cleared.
    """

    FILENAME = "poison.json"
    ENV_MAX = "REPRO_POISON_MAX"
    DEFAULT_MAX = 256

    def __init__(self, root: str | None = None,
                 max_entries: int | None = None):
        self.root = root
        if max_entries is None:
            try:
                max_entries = int(os.environ.get(self.ENV_MAX,
                                                 self.DEFAULT_MAX))
            except (TypeError, ValueError):
                max_entries = self.DEFAULT_MAX
        self.max_entries = max(1, max_entries)
        self._lock = threading.Lock()
        self._entries: dict[str, dict] = {}
        self._load()

    def _path(self) -> str | None:
        return os.path.join(self.root, self.FILENAME) if self.root else None

    def _load(self) -> None:
        path = self._path()
        if path is None:
            return
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError, ValueError):
            return
        entries = data.get("entries") if isinstance(data, dict) else None
        if isinstance(entries, dict):
            self._entries.update(
                {str(k): v for k, v in entries.items()
                 if isinstance(v, dict) and v.get("rung") in RUNGS})

    def _save(self) -> None:
        path = self._path()
        if path is None:
            return
        try:
            os.makedirs(self.root, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump({"format": 1, "entries": self._entries}, f,
                          indent=1)
            os.replace(tmp, path)  # atomic: readers never see a torn list
        except OSError:
            pass  # read-only dir: in-memory pinning still holds

    def pin(self, signature: str, rung: str = RUNG_BASELINE,
            reason: str = "") -> None:
        if rung not in RUNGS:
            rung = RUNG_BASELINE
        with self._lock:
            # re-read first so concurrent pinners merge, not clobber
            self._load()
            self._entries[signature] = {"rung": rung, "reason": reason,
                                        "time": time.time()}
            while len(self._entries) > self.max_entries:
                # evict the oldest pin, never the one just added
                # (insertion order breaks timestamp ties)
                oldest = min(
                    (k for k in self._entries if k != signature),
                    key=lambda k: self._entries[k].get("time", 0.0))
                del self._entries[oldest]
            self._save()

    def unpin(self, signature: str) -> bool:
        """Lift a pin (probation passed: the signature may be served
        stitched and re-persisted again).  True iff it was pinned."""
        with self._lock:
            self._load()  # merge concurrent pinners before rewriting
            removed = self._entries.pop(signature, None) is not None
            if removed:
                self._save()
            return removed

    def rung_for(self, signature: str) -> str | None:
        with self._lock:
            e = self._entries.get(signature)
            return e.get("rung") if e else None

    def reason_for(self, signature: str) -> str:
        with self._lock:
            e = self._entries.get(signature)
            return e.get("reason", "") if e else ""

    def __contains__(self, signature: str) -> bool:
        return self.rung_for(signature) is not None

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
