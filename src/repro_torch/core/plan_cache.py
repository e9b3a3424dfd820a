"""Persistent fusion-plan / tuning cache (tune once, run many): the port of
``repro.core.plan_cache``, the same entry format and environment names.

The paper's production story (and its predecessor work on JIT tuning
cost) amortizes plan search across runs: a deployed model compiles its
stitched kernels once and every later process reuses the choice.  This
module implements that with a content-addressed on-disk cache:

  * ``graph_signature`` canonicalizes a traced graph (topology + prims +
    shapes/dtypes + primitive params) together with the hardware model
    and the planner knobs into a sha256 key.  Constant *values* are
    excluded on purpose -- plans are structural, so two graphs differing
    only in weights share one plan.
  * ``PlanCache`` stores one JSON file per signature under a root
    directory (``$REPRO_PLAN_CACHE``), written atomically so concurrent
    processes can share a cache dir.  The cache is bounded: stores
    beyond ``max_entries`` (``$REPRO_PLAN_CACHE_MAX``, default 512)
    evict the least-recently-used entries (loads refresh recency).
  * Entries record the chosen patterns *and* their tuned schedules
    (onepass/streaming/packed + block rows/cols), so a cache hit skips
    both exploration and the latency sweep.
  * Entries also record the stitch-group composition (which patterns
    plus which absorbed leftover singletons fused into each megakernel,
    and the group's schedule), so a hit skips the stitcher pass too.

Enable by exporting ``REPRO_PLAN_CACHE=/path/to/dir`` (or passing
``plan_cache=`` to ``stitched_jit``, ``Model``, ``generate`` or
``ContinuousBatcher``).  A stale or corrupt entry never
breaks compilation: validation falls back to re-planning (or, for a
bad groups section alone, to re-running just the stitcher).

Integrity (fail-safe compilation): every stored entry carries a
``checksum`` over its canonical JSON, writes go through a temp file +
atomic ``os.replace`` so a concurrent reader can never observe a torn
entry, and a file that is truncated, unparseable, or fails its
checksum is *quarantined* (moved to ``<root>/quarantine/``) rather
than crashed on or silently retried forever.  Condemned signatures live
on the cache's ``poison`` list (``runtime.guard.PoisonList``): loads
treat them as misses and stores refuse them, so a quarantined plan is
never re-persisted.

Where the port differs: the signature hashes the port's ``Hardware``
(every field, ``platform`` and ``max_block_elems`` among them), so an
``H100`` plan and a ``V5E`` plan of one graph never share an entry; and
there is no mesh record (format 7): ``core/shard.py`` is not ported, so
the port writes formats 5 and 6 by the reference's rule and reads 2-6.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time

from ..runtime.guard import CacheCorruptError, PoisonList
from ..testing import faults as _faults

from .ir import FUSIBLE_KINDS, FusionPlan, Graph, OpKind, Pattern, \
    StitchGroup


def entry_checksum(entry: dict) -> str:
    """sha256 over the entry's canonical JSON (sans the checksum field
    itself): the integrity seal every store writes and every load
    verifies, so a torn or tampered file can never decode into a plan."""
    body = {k: v for k, v in entry.items() if k != "checksum"}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True,
                   separators=(",", ":")).encode()).hexdigest()

#: Environment variable holding the cache root directory.
ENV_DIR = "REPRO_PLAN_CACHE"

#: Environment variable bounding the number of cached entries (LRU).
ENV_MAX = "REPRO_PLAN_CACHE_MAX"

#: Default entry bound when ``$REPRO_PLAN_CACHE_MAX`` is unset.
DEFAULT_MAX_ENTRIES = 512

#: Environment variable overriding the eviction grace window (seconds).
ENV_GRACE = "REPRO_PLAN_CACHE_GRACE"

#: Entries touched within this many seconds are immune from eviction:
#: a concurrent process that just stored (or touch-on-load refreshed)
#: an entry must not lose it to an evictor ranking by a stale mtime.
DEFAULT_EVICT_GRACE_S = 30.0

#: Bump when the entry layout or planner semantics change incompatibly.
#: v2: stitch groups (group membership + group schedules) + planner-side
#: MAX_PATTERN coalesce bound changed plan granularity.
#: v3: measured *group* schedules (``tuned`` flag on group records) from
#: the batched group autotuner.  v2 entries still load -- the pattern
#: and group-composition sections are unchanged -- but their group
#: schedules are dropped, degrading to re-tuning (or the analytic
#: sweep) instead of erroring; the upgraded entry is written back.
#: v4: measured *partition* choice (top-level ``partition_source``
#: marker) from the top-k partition tuner.  v3 entries still load --
#: plan, groups and tuned group schedules are unchanged -- but their
#: partition was never raced against the runner-up candidates, so an
#: autotuning process degrades to re-measuring the partition and
#: upgrades the entry in place, mirroring the v2 -> v3 path.
#: v5: per-kernel stage-vs-recompute decision (``recompute`` id list on
#: onepass schedule records) from the thread-composition scheme.  v4
#: entries still load in full -- plan, groups, tuned schedules and the
#: measured-partition marker are unchanged -- but carry no recompute
#: pins, so a onepass pin that is only feasible under recompute fails
#: its override re-price at emission and degrades to re-deciding via
#: the latency sweep; the entry is upgraded to v5 in place.
#: v6: compute-anchored groups (``anchors`` node-id list on group
#: records) from anchored stitching.  v5 entries still load in full --
#: their composition simply predates anchor absorption, so the loader
#: re-plans the anchors (absorption is deterministic) and backfills the
#: upgraded entry.  A plan with *no* anchored group is still written as
#: v5, so ``REPRO_ANCHOR=0`` runs reproduce pre-anchor entries
#: byte-for-byte; v6 entries loaded with the knob off degrade to
#: re-stitching instead of silently re-enabling the scheme.
#: v7 (the reference's SPMD-aware plans, a top-level ``mesh`` record) is
#: not written or read by the port: ``core/shard.py`` is not ported.
FORMAT_VERSION = 6

#: Formats ``entry_to_plan`` / ``entry_to_groups`` still understand.
SUPPORTED_FORMATS = (2, 3, 4, 5, FORMAT_VERSION)


def entry_format_for(groups) -> int:
    """The format ``plan_to_entry`` stamps for this composition: v6 only
    for anchored groups (see the version ladder above), so anchor-free
    plans are written as v5, as the reference writes them."""
    if groups and any(getattr(g, "anchors", ()) for g in groups):
        return 6
    return 5


# ---------------------------------------------------------------------------
# canonical graph signature
# ---------------------------------------------------------------------------
def graph_signature(graph: Graph, hw, *, remote_fusion: bool = True) -> str:
    """Canonical sha256 of (topology, prims, shapes/dtypes, params, hw,
    planner configuration).

    Constant *values* are left out, and so are the tracer's live
    handles (params whose name starts with ``_``): two graphs that differ
    only in weights share one plan, and a signature is the same in every
    process.
    """
    from .explorer import MAX_GROUP, MAX_PATTERN, TOP_K
    from .planner import BEAM_WIDTH
    from .stitcher import beam_width_from_env

    h = hashlib.sha256()

    def w(*xs) -> None:
        h.update(repr(xs).encode())
        h.update(b";")

    # NOTE: the entry FORMAT_VERSION is deliberately *not* hashed --
    # signatures are stable across format bumps so an old-format entry
    # can be found and degraded (v2 -> re-tune) instead of orphaned.
    # REPRO_STITCH_TOPK is likewise unhashed: it only widens the set of
    # measurement candidates.  The stitch beam width is hashed, as in the
    # reference.
    w("hw", hw.peak_flops, hw.hbm_bw, hw.vpu_ops, hw.vmem_bytes,
      hw.launch_s, hw.hbm_latency_s, hw.platform, hw.max_block_elems,
      hw.bf16_flops)
    w("knobs", TOP_K, MAX_GROUP, MAX_PATTERN, BEAM_WIDTH, remote_fusion,
      beam_width_from_env())
    w("io", tuple(graph.inputs), tuple(graph.outputs))
    for nid in graph.topo_order():
        n = graph.node(nid)
        params = tuple(sorted(
            (k, repr(v)) for k, v in n.params.items()
            if not k.startswith("_")))  # skip the tracer's live handles
        # anchors hash as "opaque", as in the reference: the signature
        # stays stable across the anchor classification.
        kind = "opaque" if n.kind is OpKind.ANCHOR else n.kind.value
        w(nid, n.prim, kind, n.inputs, n.spec.shape, n.spec.dtype,
          params)
    return h.hexdigest()


# ---------------------------------------------------------------------------
# entry <-> plan
# ---------------------------------------------------------------------------
def plan_to_entry(plan: FusionPlan, schedules: list[dict],
                  signature: str,
                  groups: "list[StitchGroup] | None" = None,
                  group_schedules: list[dict] | None = None,
                  partition_source: str | None = None) -> dict:
    """Serialize a chosen plan + per-pattern schedule picks.

    ``groups`` (with per-group ``group_schedules``) additionally records
    the stitch-group composition: each group names the plan patterns it
    fuses by index plus any absorbed leftover singletons by node id.
    ``partition_source`` records how the group *partition* was chosen
    (``"model"``: cost-model ranking; ``"measured"``: the top-k
    candidates were raced on silicon) -- a later autotuning process
    trusts a measured partition and re-races a modeled one.
    """
    entry = {
        "format": entry_format_for(groups),
        "signature": signature,
        "patterns": [
            {"members": sorted(pat.members), **sched}
            for pat, sched in zip(plan.patterns, schedules)
        ],
    }
    if partition_source in ("model", "measured"):
        entry["partition_source"] = partition_source
    if groups is not None:
        index_of = {pat.members: i for i, pat in enumerate(plan.patterns)}
        recs = []
        for gi, grp in enumerate(groups):
            anchors = sorted(getattr(grp, "anchors", ()))
            aset = set(anchors)
            idxs, extra = [], []
            for part in grp.parts:
                if len(part) == 1 and next(iter(part)) in aset:
                    continue  # anchor singletons live in "anchors"
                i = index_of.get(part)
                if i is not None:
                    idxs.append(i)
                else:  # absorbed leftover singleton(s)
                    extra.extend(sorted(part))
            rec: dict = {"parts": idxs, "extra": extra}
            if anchors:
                rec["anchors"] = anchors
            if group_schedules is not None and gi < len(group_schedules):
                rec.update(group_schedules[gi])
            recs.append(rec)
        entry["groups"] = recs
    return entry


def entry_to_plan(entry: dict, graph: Graph
                  ) -> tuple[FusionPlan, list[dict]] | None:
    """Reconstruct (plan, per-pattern schedule overrides); None if stale.

    Validates against the live graph (membership, fusibility,
    disjointness, convexity) so a corrupt or hand-edited entry degrades
    to a re-plan instead of a miscompile.
    """
    if not isinstance(entry, dict) \
            or entry.get("format") not in SUPPORTED_FORMATS:
        return None
    patterns: list[Pattern] = []
    overrides: list[dict] = []
    seen: set[int] = set()
    for rec in entry.get("patterns", ()):
        try:
            members = frozenset(int(m) for m in rec["members"])
        except (KeyError, TypeError, ValueError):
            return None
        if not members or not members.isdisjoint(seen):
            return None
        for nid in members:
            node = graph.nodes.get(nid)
            if node is None or node.kind not in FUSIBLE_KINDS:
                return None
        if not graph.is_convex(members):
            return None
        seen |= members
        patterns.append(Pattern(members, 0.0))
        overrides.append(_sanitize_override(rec))
    return FusionPlan(patterns), overrides


def entry_to_groups(entry: dict, plan: FusionPlan, graph: Graph
                    ) -> "tuple[list[StitchGroup], list[dict]] | None":
    """Reconstruct (stitch groups, per-group schedule overrides).

    Validates pattern indices (each used at most once), absorbed extras
    (fusible, outside every pattern, not duplicated) and union convexity
    so a corrupt groups section degrades to re-running the stitcher --
    never to a miscompile.  Patterns not referenced by any group become
    singleton groups, so the result always covers the plan.

    Version skew: a v2 entry's group *composition* loads unchanged, but
    its group schedules predate measured group tuning and are dropped
    (every override comes back empty), so the caller re-tunes (or falls
    back to the analytic sweep) instead of trusting a stale pin.  v3
    records may carry a ``tuned: true`` marker, passed through on the
    override so reports can distinguish measured from analytic pins.
    """
    recs = entry.get("groups")
    if not isinstance(recs, list):
        return None
    format_v = entry.get("format")
    n = len(plan.patterns)
    in_pattern = plan.covered()
    used_idx: set[int] = set()
    used_extra: set[int] = set()
    groups: list[StitchGroup] = []
    overrides: list[dict] = []
    for rec in recs:
        if not isinstance(rec, dict):
            return None
        try:
            idxs = [int(i) for i in rec.get("parts", ())]
            extra = [int(e) for e in rec.get("extra", ())]
            anchors = sorted(int(a) for a in rec.get("anchors", ()))
        except (TypeError, ValueError):
            return None
        if not idxs:
            return None
        for i in idxs:  # dupes within one record are corrupt too
            if i < 0 or i >= n or i in used_idx:
                return None
            used_idx.add(i)
        for e in extra:
            if e in used_extra or e in in_pattern:
                return None
            node = graph.nodes.get(e)
            if node is None or node.kind not in FUSIBLE_KINDS:
                return None
            used_extra.add(e)
        for a in anchors:
            if a in used_extra or a in in_pattern:
                return None
            node = graph.nodes.get(a)
            if node is None or node.kind is not OpKind.ANCHOR:
                return None
            used_extra.add(a)
        if anchors:
            from .cost_model import anchor_enabled

            # with the knob off an anchored composition degrades to
            # re-stitching (absorption simply won't re-form the group),
            # never to silently re-enabling the scheme.
            if not anchor_enabled():
                return None
        parts = sorted(
            [plan.patterns[i].members for i in idxs]
            + [frozenset({e}) for e in extra]
            + [frozenset({a}) for a in anchors], key=min)
        union: frozenset[int] = frozenset()
        for p in parts:
            union |= p
        if not graph.is_convex(union):
            return None
        if anchors:
            # the original pre-absorption composition is not persisted;
            # a degenerate per-part fallback keeps the guard ladder sound.
            groups.append(StitchGroup(
                tuple(parts), anchors=tuple(anchors),
                unanchored=tuple((p,) for p in parts)))
        else:
            groups.append(StitchGroup(tuple(parts)))
        if format_v == 2:  # pre-group-tuning schedules: degrade to re-tune
            overrides.append({})
            continue
        over = _sanitize_override(rec)
        if over and rec.get("tuned") is True:
            over["tuned"] = True
        overrides.append(over)
    for i in range(n):  # unreferenced patterns: singleton groups
        if i not in used_idx:
            groups.append(StitchGroup((plan.patterns[i].members,)))
            overrides.append({})
    order = sorted(range(len(groups)), key=lambda k: min(groups[k].members))
    return [groups[k] for k in order], [overrides[k] for k in order]


def entry_partition_source(entry: dict) -> str:
    """How the entry's stored group partition was chosen.

    Formats >= 4 record the marker (the partition-race semantics are
    unchanged since); older formats predate partition racing, so their
    partitions count as model-chosen and an autotuning loader degrades
    to re-measuring the top-k candidates.
    """
    fmt = entry.get("format") if isinstance(entry, dict) else None
    if isinstance(fmt, int) and not isinstance(fmt, bool) and fmt >= 4 \
            and entry.get("partition_source") == "measured":
        return "measured"
    return "model"


def override_fp(over: dict | None) -> tuple:
    """Hashable fingerprint of a schedule override (lists -> tuples).

    The one normalization point for override dicts used as cache /
    measurement / emission-dedup keys: any future list-valued override
    field (like ``recompute``) is handled here for every consumer."""
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                        for k, v in (over or {}).items()))


def _sanitize_override(rec: dict) -> dict:
    """Keep only well-typed schedule fields; a malformed override must
    degrade to the analytic sweep, not crash emission."""
    if rec.get("schedule") == "anchored":
        from .cost_model import anchor_enabled

        if not anchor_enabled():
            return {}
        over = {"schedule": "anchored"}
        v = rec.get("block_rows")
        if isinstance(v, int) and not isinstance(v, bool) and v > 0:
            over["block_rows"] = v
        return over
    if rec.get("schedule") not in ("onepass", "streaming", "packed"):
        return {}
    over = {"schedule": rec["schedule"]}
    for k in ("block_rows", "block_cols"):
        v = rec.get(k)
        if isinstance(v, int) and not isinstance(v, bool) and v > 0:
            over[k] = v
    recompute = rec.get("recompute")
    if rec["schedule"] == "onepass" and isinstance(recompute, list) \
            and recompute \
            and all(isinstance(x, int) and not isinstance(x, bool)
                    and x >= 0 for x in recompute):
        # the port's recompute scheme has no off switch (the reference's
        # ``REPRO_RECOMPUTE`` defaults to on): a pin is always kept.
        over["recompute"] = sorted(set(recompute))
    return over


# ---------------------------------------------------------------------------
# on-disk store
# ---------------------------------------------------------------------------
class PlanCache:
    """One JSON file per graph signature under ``root``.

    Bounded: when a store pushes the entry count past ``max_entries``
    the least-recently-used entries (by file mtime; loads re-touch their
    entry) are evicted, so a production cache dir cannot grow without
    bound across deployed model revisions.
    """

    def __init__(self, root: str, max_entries: int | None = None,
                 evict_grace_s: float | None = None):
        self.root = root
        if max_entries is None:
            try:
                max_entries = int(os.environ.get(ENV_MAX,
                                                 DEFAULT_MAX_ENTRIES))
            except ValueError:
                max_entries = DEFAULT_MAX_ENTRIES
        self.max_entries = max(1, max_entries)
        if evict_grace_s is None:
            try:
                evict_grace_s = float(os.environ.get(ENV_GRACE,
                                                     DEFAULT_EVICT_GRACE_S))
            except ValueError:
                evict_grace_s = DEFAULT_EVICT_GRACE_S
        self.evict_grace_s = max(0.0, evict_grace_s)
        #: per-instance hit/miss counters ("plan-cache exposes hit/miss
        #: counters"): a ``load`` returning an entry counts as a hit,
        #: anything else (absent, corrupt, wrong signature) as a miss.
        self.hits = 0
        self.misses = 0
        #: corrupt files moved aside (truncated / unparseable / bad
        #: checksum) and the last such error, for observability.
        self.quarantined = 0
        self.last_error: str = ""
        #: condemned signatures: loads miss, stores refuse.  Shared
        #: across processes via the cache dir.
        self.poison = PoisonList(root)
        #: signatures whose poison pin was lifted (``readmit``).
        self.readmitted = 0

    @classmethod
    def from_env(cls) -> "PlanCache | None":
        root = os.environ.get(ENV_DIR)
        return cls(root) if root else None

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "quarantined": self.quarantined,
                "poisoned": len(self.poison),
                "readmitted": self.readmitted}

    def _path(self, signature: str) -> str:
        return os.path.join(self.root, f"{signature}.json")

    def _quarantine(self, path: str, err: Exception) -> None:
        """Move a corrupt file aside (never delete evidence, never let
        it be retried on every load) and record the failure."""
        e = CacheCorruptError(
            f"{os.path.basename(path)}: {type(err).__name__}: {err}")
        self.last_error = str(e)
        self.quarantined += 1
        try:
            qdir = os.path.join(self.root, "quarantine")
            os.makedirs(qdir, exist_ok=True)
            os.replace(path, os.path.join(
                qdir, f"{os.path.basename(path)}.{int(time.time() * 1e3)}"))
        except OSError:
            try:  # last resort: a corrupt entry must not shadow a re-store
                os.unlink(path)
            except OSError:
                pass

    def load(self, signature: str) -> dict | None:
        if signature in self.poison:
            self.misses += 1  # quarantined plan: never served from disk
            return None
        path = self._path(signature)
        try:
            with open(path) as f:
                raw = f.read()
        except OSError:  # absent (or unreadable): a plain miss
            self.misses += 1
            return None
        try:
            entry = json.loads(raw)
            if not isinstance(entry, dict):
                raise ValueError("entry is not a JSON object")
            if entry.get("signature") != signature:
                raise ValueError("entry signature does not match filename")
            stored_sum = entry.get("checksum")
            if stored_sum is not None \
                    and stored_sum != entry_checksum(entry):
                raise ValueError("checksum mismatch (torn or tampered)")
        except (json.JSONDecodeError, ValueError) as e:
            # corrupt/truncated/unparseable: quarantine, degrade to a
            # miss -- the caller re-plans, compilation never crashes.
            self._quarantine(path, e)
            self.misses += 1
            return None
        try:
            os.utime(path, None)  # LRU: a hit refreshes recency
        except OSError:
            pass
        self.hits += 1
        return entry

    def store(self, signature: str, entry: dict) -> None:
        if signature in self.poison:
            return  # a quarantined plan is never re-persisted
        entry = dict(entry)
        entry["checksum"] = entry_checksum(entry)
        payload = json.dumps(entry, indent=1)
        fault = _faults.fire("cache_corrupt", signature=signature)
        if fault is not None:  # simulate a torn write reaching disk
            payload = payload[: max(1, len(payload) // 2)]
        try:
            os.makedirs(self.root, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                f.write(payload)
            os.replace(tmp, self._path(signature))  # atomic on POSIX
        except OSError:
            return  # a read-only cache dir must never break compilation
        self._evict()

    def readmit(self, signature: str) -> bool:
        """Lift a signature's poison pin (the reference's canary does this
        when probation passes): the plan may be loaded and stored again.
        True iff a pin was actually removed."""
        ok = self.poison.unpin(signature)
        self.readmitted += int(ok)
        return ok

    def evict_entry(self, signature: str) -> bool:
        """Drop one entry (quarantine flow: a condemned plan must not be
        served to any later process)."""
        try:
            os.unlink(self._path(signature))
            return True
        except OSError:
            return False

    def _evict(self) -> None:
        """Drop the oldest entries beyond ``max_entries`` (best-effort).

        Eviction races concurrent stores and touch-on-load refreshes:
        between listing the directory and unlinking, another process may
        have (re)written the very entry this process ranked as oldest.
        Two guards close the window: entries whose mtime is within
        ``evict_grace_s`` of now are never evicted (a just-stored entry
        cannot be the LRU victim of a stale listing), and each victim's
        mtime is re-checked immediately before the unlink -- if it moved
        since the listing, the entry was touched concurrently and is
        skipped.  The count may transiently exceed ``max_entries``; the
        next store past the grace window evicts the remainder.
        """
        try:
            now = time.time()
            aged: list[tuple[float, str]] = []
            for name in os.listdir(self.root):
                # "health.json" is the reference canary's PlanHealth file
                # (not ported yet), named literally so a cache directory
                # shared with it keeps its sidecar: neither is an LRU
                # victim.
                if not name.endswith(".json") \
                        or name in (PoisonList.FILENAME, "health.json"):
                    continue
                path = os.path.join(self.root, name)
                try:
                    aged.append((os.path.getmtime(path), path))
                except OSError:
                    continue  # vanished under a concurrent evictor
            excess = len(aged) - self.max_entries
            if excess <= 0:
                return
            aged.sort()
            for mtime, path in aged:
                if excess <= 0:
                    break
                if now - mtime < self.evict_grace_s:
                    break  # sorted: everything after is younger still
                try:
                    if os.path.getmtime(path) != mtime:
                        continue  # touched since listing: not LRU anymore
                    os.unlink(path)
                    excess -= 1
                except OSError:
                    continue
        except OSError:
            pass  # concurrent evictors / permissions: never fatal
