"""The port's measured tuner against the JAX package's.

On the CPU the tuner runs only under ``REPRO_AUTOTUNE=force``, timing
the kernels' plain versions with the host clock; what is tested here is
its logic, not a time.  With the same deterministic fake
``_time_callable`` patched into both packages, ``tune_pattern``,
``tune_group`` and ``tune_partitions`` return the reference's overrides
and winner under ``V5E``.  Then the reference's tuner tests
(``tests/test_beam_stitch.py``, ``tests/test_topk_tune.py``,
``tests/test_plan_dispatch.py``, ``tests/test_guard_faults.py``) on the
port: batched against serial sweeps, a measured partition committed,
persisted and replayed, v2 and v3 entries degraded and upgraded,
``race_crash`` and ``tuner_hang`` contained, the timer, the watchdog.
"""
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.core import autotune as jautotune  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import autotune as autotune_mod  # noqa: E402
from repro_torch.core import stitch as stitch_mod  # noqa: E402
from repro_torch.core.autotune import (autotune_available,  # noqa: E402
                                       tune_group, tune_partitions,
                                       tune_pattern)
from repro_torch.core.codegen import emit_group  # noqa: E402
from repro_torch.core.plan_cache import PlanCache, entry_partition_source, \
    entry_to_groups, entry_to_plan  # noqa: E402
from repro_torch.core.stitcher import (DEFAULT_BEAM_WIDTH,  # noqa: E402
                                       DEFAULT_TOPK, beam_width_from_env,
                                       topk_from_env)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.runtime.guard import RaceTimeoutError, \
    with_watchdog  # noqa: E402
from repro_torch.testing import faults  # noqa: E402

from test_torch_plan_cache import CASES, j_deep, t_deep  # noqa: E402

V5E = tcore.V5E
rng = np.random.default_rng(71)


@pytest.fixture
def force(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "force")


def _deep_args():
    return [rng.standard_normal(s).astype(np.float32)
            for s in CASES["deep"][2]]


def _targs(args):
    return [torch.from_numpy(a) for a in args]


def _port_case(args=None):
    """The deep chain traced, planned and stitched by the port (V5E)."""
    args = args if args is not None else _deep_args()
    graph = tcore.trace(t_deep, *_targs(args))
    ctx = tcore.CostContext(graph, V5E)
    plan = tcore.make_plan(graph, V5E, ctx=ctx)
    res = tcore.search_groups(graph, plan, V5E, ctx=ctx)
    return graph, ctx, plan, res


def _ref_case(args):
    graph = jcore.trace(j_deep, *args)
    ctx = jcore.CostContext(graph)
    plan = jcore.make_plan(graph, ctx=ctx)
    return graph, ctx, plan, jcore.search_groups(graph, plan, ctx=ctx)


def _fake_timer(scores):
    """Deterministic ``_time_callable`` stand-in keyed on the candidate."""
    def timer(fn, args, *, warmup=1, iters=3, key=None):
        assert key is not None
        return scores.get(dict(key).get("schedule"), 99.0) \
            + dict(key).get("block_rows", 0) * 1e-3
    return timer


def _force_partition_timer(want: int):
    """Partition branches of candidate ``want`` fast, all else slow;
    schedule keys a deterministic constant by block rows."""
    def timer(fn, args, *, warmup=1, iters=3, key=None):
        assert key is not None
        if isinstance(key, tuple) and key and key[0] == "partition":
            return 0.001 if key[1] == want else 1.0
        return 1.0 + dict(key).get("block_rows", 0) * 1e-3
    return timer


def _patch_both(monkeypatch, timer):
    monkeypatch.setattr(autotune_mod, "_time_callable", timer)
    monkeypatch.setattr(jautotune, "_time_callable", timer)


# -- parity with the reference's tuner ------------------------------------------
SCORES = ({"onepass": 1.0, "streaming": 2.0},
          {"onepass": 2.0, "streaming": 1.0})


@pytest.mark.parametrize("scores", SCORES, ids=["onepass", "streaming"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_tune_pattern_picks_the_reference_override(name, scores, force,
                                                   monkeypatch):
    jfn, tfn, shapes = CASES[name]
    args = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jg, tg = jcore.trace(jfn, *args), tcore.trace(tfn, *_targs(args))
    jctx, tctx = jcore.CostContext(jg), tcore.CostContext(tg, V5E)
    jplan = jcore.make_plan(jg, ctx=jctx)
    tplan = tcore.make_plan(tg, V5E, ctx=tctx)
    _patch_both(monkeypatch, _fake_timer(scores))
    assert [p.members for p in tplan.patterns] == \
        [p.members for p in jplan.patterns]
    for pat in tplan.patterns:
        info = tctx.info(pat.members)
        if info is not None:
            assert autotune_mod._candidate_overrides(info, V5E) == \
                jautotune._candidate_overrides(jctx.info(pat.members))
        assert tune_pattern(tg, pat.members, hw=V5E, ctx=tctx,
                            device="cpu") == \
            jautotune.tune_pattern(jg, pat.members, ctx=jctx)


@pytest.mark.parametrize("scores", SCORES, ids=["onepass", "streaming"])
def test_tune_group_picks_the_reference_override(scores, force,
                                                 monkeypatch):
    args = _deep_args()
    tg, tctx, _, tres = _port_case(args)
    jg, jctx, _, jres = _ref_case(args)
    _patch_both(monkeypatch, _fake_timer(scores))
    stitched = [g for g in tres.groups if g.stitched]
    assert stitched and [g.parts for g in tres.groups] == \
        [g.parts for g in jres.groups]
    for grp in stitched:
        got = tune_group(tg, grp.parts, hw=V5E, ctx=tctx, device="cpu")
        assert got == jautotune.tune_group(jg, grp.parts, ctx=jctx)
        assert got["schedule"] == min(scores, key=scores.get) or \
            got.get("recompute")


@pytest.mark.parametrize("want", [0, 1, 2])
def test_tune_partitions_picks_the_reference_winner(want, force,
                                                    monkeypatch):
    args = _deep_args()
    tg, tctx, _, tres = _port_case(args)
    jg, jctx, _, jres = _ref_case(args)
    _patch_both(monkeypatch, _force_partition_timer(want))
    assert len(tres.candidates) == len(jres.candidates) == 3
    got = tune_partitions(tg, [c.groups for c in tres.candidates], hw=V5E,
                          ctx=tctx, device="cpu")
    ref = jautotune.tune_partitions(jg, [c.groups for c in jres.candidates],
                                    ctx=jctx)
    assert got.index == ref.index == want
    assert got.overrides == ref.overrides
    assert got.branches == ref.branches
    assert got.measured_s == ref.measured_s
    assert got.disqualified == 0


# -- batched against serial (tests/test_beam_stitch.py, test_topk_tune.py) ----
@pytest.mark.parametrize("scores", SCORES, ids=["onepass", "streaming"])
def test_batched_and_serial_sweeps_agree(scores, force, monkeypatch):
    graph, ctx, plan, res = _port_case()
    grp = max(res.groups, key=len)
    assert grp.stitched
    monkeypatch.setattr(autotune_mod, "_time_callable", _fake_timer(scores))
    over_b = tune_group(graph, grp.parts, hw=V5E, ctx=ctx,
                        batch_compile=True, device="cpu")
    over_s = tune_group(graph, grp.parts, hw=V5E, ctx=ctx,
                        batch_compile=False, device="cpu")
    assert over_b == over_s and over_b is not None
    assert over_b["schedule"] == min(scores, key=scores.get)
    pat = plan.patterns[0].members
    assert tune_pattern(graph, pat, hw=V5E, ctx=ctx, batch_compile=True,
                        device="cpu") == \
        tune_pattern(graph, pat, hw=V5E, ctx=ctx, batch_compile=False,
                     device="cpu")


@pytest.mark.parametrize("want", [0, 1])
def test_tune_partitions_batched_and_serial_agree(want, force, monkeypatch):
    graph, ctx, _, res = _port_case()
    cands = [c.groups for c in res.candidates]
    monkeypatch.setattr(autotune_mod, "_time_callable",
                        _force_partition_timer(want))
    out_b = tune_partitions(graph, cands, hw=V5E, ctx=ctx,
                            batch_compile=True, device="cpu")
    out_s = tune_partitions(graph, cands, hw=V5E, ctx=ctx,
                            batch_compile=False, device="cpu")
    assert out_b.index == out_s.index == want
    assert out_b.overrides == out_s.overrides
    assert out_b.branches == out_s.branches >= len(cands)
    assert out_b.measured_s[want] <= min(
        t for i, t in enumerate(out_b.measured_s) if i != want)


@pytest.mark.parametrize("hw", ["V5E", "H100"])
def test_unmocked_sweep_returns_a_candidate_that_emits(hw, force):
    preset = getattr(tcore, hw)
    args = [a[:16] if a.ndim == 2 else a for a in _deep_args()]
    graph = tcore.trace(t_deep, *_targs(args))
    ctx = tcore.CostContext(graph, preset)
    plan = tcore.make_plan(graph, preset, ctx=ctx)
    res = tcore.search_groups(graph, plan, preset, ctx=ctx)
    grp = max(res.groups, key=len)
    over = tune_group(graph, grp.parts, hw=preset, ctx=ctx, device="cpu")
    assert over is not None and over["schedule"] in ("onepass", "streaming")
    assert over.get("block_rows", 0) > 0
    em = emit_group(graph, grp.parts, hw=preset, ctx=ctx,
                    schedule_override=over)
    assert em.estimate.schedule == over["schedule"]


# -- end to end through stitched_jit ------------------------------------------------
def _sf(tmp_path=None, **kw):
    return tcore.stitched_jit(t_deep, hw=V5E, device="cpu",
                              plan_cache=str(tmp_path) if tmp_path else None,
                              **kw)


def test_autotune_forced_produces_valid_override(force, tmp_path):
    x, g = torch.randn(64, 256), torch.randn(256)
    f = CASES["rmsnorm"][1]
    sf = tcore.stitched_jit(f, device="cpu", autotune=True,
                            plan_cache=str(tmp_path))
    rep = sf.report(x, g)
    assert rep.autotuned and rep.tune_s > 0
    torch.testing.assert_close(sf(x, g), f(x, g))
    sf2 = tcore.stitched_jit(f, device="cpu", plan_cache=str(tmp_path))
    rep2 = sf2.report(x, g)
    assert rep2.plan_cache_hit and rep2.tune_s == 0.0


def test_measured_partition_committed_persisted_and_replayed(
        force, monkeypatch, tmp_path):
    monkeypatch.setattr(autotune_mod, "_time_callable",
                        _force_partition_timer(1))
    args = _targs(_deep_args())
    sf1 = _sf(tmp_path, autotune=True)
    rep1 = sf1.report(*args)
    assert rep1.partition_source == "measured"
    assert rep1.partition_candidates >= 2 and rep1.partition_index == 1
    assert rep1.partition_branches >= rep1.partition_candidates
    y = sf1(*args)
    torch.testing.assert_close(y, t_deep(*args), rtol=1e-4, atol=1e-4)
    entry = PlanCache(str(tmp_path)).load(rep1.signature)
    assert entry["format"] == 5 and entry["partition_source"] == "measured"
    assert entry_partition_source(entry) == "measured"

    calls = []
    real_search, real_tune = stitch_mod.search_groups, \
        autotune_mod.tune_partitions
    monkeypatch.setattr(stitch_mod, "search_groups", lambda *a, **k: (
        calls.append("search") or real_search(*a, **k)))
    monkeypatch.setattr(autotune_mod, "tune_partitions", lambda *a, **k: (
        calls.append("tune") or real_tune(*a, **k)))
    sf2 = _sf(tmp_path, autotune=True)
    rep2 = sf2.report(*args)
    assert rep2.plan_cache_hit and rep2.partition_source == "measured"
    assert not calls and rep2.groups == rep1.groups
    torch.testing.assert_close(sf2(*args), y, rtol=0, atol=0)


def test_partition_source_model_without_autotune():
    rep = _sf().report(*_targs(_deep_args()))
    assert rep.partition_source == "model" and not rep.autotuned
    assert rep.partition_candidates >= 1 and rep.partition_index == 0
    assert rep.tune_s == 0.0


def test_tuned_group_schedule_roundtrips_cache(force, monkeypatch,
                                               tmp_path):
    args = _targs(_deep_args())
    rep1 = _sf(tmp_path, autotune=True).report(*args)
    assert rep1.autotuned and rep1.group_tuned >= 1
    entry = PlanCache(str(tmp_path)).load(rep1.signature)
    assert entry["format"] == 5
    tuned = [r for r in entry["groups"] if r.get("tuned")]
    assert tuned and all(r["schedule"] in ("onepass", "streaming")
                         for r in tuned)
    calls = []
    real = autotune_mod.tune_group
    monkeypatch.setattr(autotune_mod, "tune_group",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    sf2 = _sf(tmp_path, autotune=True)
    rep2 = sf2.report(*args)
    assert rep2.plan_cache_hit and rep2.group_tuned >= 1 and not calls
    torch.testing.assert_close(sf2(*args), t_deep(*args), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("fmt", [2, 3])
def test_old_entry_degrades_and_is_upgraded(fmt, force, monkeypatch,
                                            tmp_path):
    """v2 drops the group schedules (re-tuned); v3 predates the measured
    partition marker (re-raced).  Both reload, re-measure and are
    rewritten in the current format."""
    monkeypatch.setattr(autotune_mod, "_time_callable",
                        _force_partition_timer(0))
    args = _targs(_deep_args())
    rep1 = _sf(tmp_path, autotune=True).report(*args)
    path = os.path.join(str(tmp_path), f"{rep1.signature}.json")
    with open(path) as f:
        entry = json.load(f)
    entry["format"] = fmt
    entry.pop("checksum", None)
    entry.pop("partition_source", None)
    if fmt == 2:
        for r in entry["groups"]:
            r.pop("tuned", None)
    with open(path, "w") as f:
        json.dump(entry, f)
    assert entry_partition_source(entry) == "model"
    graph = tcore.trace(t_deep, *args)
    plan, _ = entry_to_plan(entry, graph)
    _, overrides = entry_to_groups(entry, plan, graph)
    if fmt == 2:
        assert all(o == {} for o in overrides)

    calls = []
    real = autotune_mod.tune_partitions
    monkeypatch.setattr(autotune_mod, "tune_partitions",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    sf2 = _sf(tmp_path, autotune=True)
    rep2 = sf2.report(*args)
    assert rep2.plan_cache_hit and rep2.partition_source == "measured"
    assert calls and rep2.group_tuned >= 1
    upgraded = PlanCache(str(tmp_path)).load(rep1.signature)
    assert upgraded["format"] == 5
    assert upgraded["partition_source"] == "measured"
    assert any(r.get("tuned") for r in upgraded["groups"])
    torch.testing.assert_close(sf2(*args), t_deep(*args), rtol=1e-4,
                               atol=1e-4)


# -- containment (tests/test_guard_faults.py) -----------------------------------------
def test_race_crash_branch_disqualified(force):
    graph, ctx, _, res = _port_case()
    cands = [c.groups for c in res.candidates]
    with faults.inject("race_crash:branch=0") as armed:
        out = tune_partitions(graph, cands, hw=V5E, ctx=ctx, device="cpu")
    assert armed.get("race_crash").fired == 1
    assert out is not None and out.disqualified == 1
    assert all(np.isfinite(t) for t in out.measured_s)


def test_race_crash_end_to_end_still_correct(force):
    args = _targs(_deep_args())
    with faults.inject("race_crash:branch=0"):
        sf = _sf(autotune=True)
        out = sf(*args)
    assert sf.reports()[0].partition_disqualified == 1
    torch.testing.assert_close(out, t_deep(*args), rtol=1e-4, atol=1e-4)


def test_tuner_hang_watchdog_aborts_race(force, monkeypatch):
    monkeypatch.setenv("REPRO_RACE_TIMEOUT_S", "0.5")
    graph, ctx, _, res = _port_case()
    with faults.inject("tuner_hang:sleep=5"):
        t0 = time.perf_counter()
        out = tune_partitions(graph, [c.groups for c in res.candidates],
                              hw=V5E, ctx=ctx, device="cpu")
    assert out is None and time.perf_counter() - t0 < 4.0
    assert ctx.caps.get("race_timeout") == 1


def test_tuner_hang_end_to_end_serves_the_model_partition(force,
                                                          monkeypatch):
    monkeypatch.setenv("REPRO_RACE_TIMEOUT_S", "0.5")
    args = _targs(_deep_args())
    with faults.inject("tuner_hang:sleep=5"):
        sf = _sf(autotune=True)
        out = sf(*args)
    rep = sf.reports()[0]
    torch.testing.assert_close(out, t_deep(*args), rtol=1e-4, atol=1e-4)
    assert rep.partition_source == "model"
    assert rep.caps_hit.get("race_timeout") == 1


@pytest.mark.parametrize("case", ["timeout", "inline", "error", "value"])
def test_watchdog(case):
    if case == "timeout":
        with pytest.raises(RaceTimeoutError):
            with_watchdog(lambda: time.sleep(2), 0.2)
    elif case == "inline":
        import threading
        assert with_watchdog(threading.current_thread, 0) is \
            threading.current_thread()
    elif case == "error":
        with pytest.raises(KeyError):
            with_watchdog(lambda: {}["x"], 5)
    else:
        assert with_watchdog(lambda: 42, 5) == 42


# -- the timer, the gate, the knobs ---------------------------------------------
def test_time_callable_runs_warmup_and_iters():
    calls = []
    t = autotune_mod._time_callable(lambda *a: calls.append(a), (1,),
                                    warmup=2, iters=3, key=("k",))
    assert t >= 0.0 and len(calls) == 5


def test_autotune_gate(monkeypatch):
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    assert not autotune_available("cpu")
    assert autotune_available("cuda") == torch.cuda.is_available()
    monkeypatch.setenv("REPRO_AUTOTUNE", "force")
    assert autotune_available("cpu")
    monkeypatch.delenv("REPRO_AUTOTUNE")
    rep = tcore.stitched_jit(CASES["softmax"][1], device="cpu",
                             autotune=True).report(torch.randn(8, 64))
    assert not rep.autotuned             # no card, no force: analytic


def test_dummy_inputs_are_seeded_and_in_range():
    graph = tcore.trace(lambda x, i: x[i] * 2.0, torch.randn(8, 4),
                        torch.tensor([1, 2]))
    a = autotune_mod._dummy_inputs(graph, graph.inputs, torch.device("cpu"))
    b = autotune_mod._dummy_inputs(graph, graph.inputs, torch.device("cpu"))
    assert torch.equal(a[0], b[0]) and a[0].std() > 0
    assert a[1].dtype == torch.int64 and not a[1].any()


def test_tuner_launches_are_not_counted():
    class Owner:
        launches = 0

    _build.count(Owner)
    with _build.uncounted():
        _build.count(Owner, 5)
    assert Owner.launches == 1


@pytest.mark.parametrize("knob,fn,default", [
    ("REPRO_STITCH_TOPK", topk_from_env, DEFAULT_TOPK),
    ("REPRO_STITCH_BEAM", beam_width_from_env, DEFAULT_BEAM_WIDTH)])
def test_env_knobs(knob, fn, default, monkeypatch):
    monkeypatch.delenv(knob, raising=False)
    assert fn() == default
    monkeypatch.setenv(knob, "5")
    assert fn() == 5
    monkeypatch.setenv(knob, "0")
    assert fn() == 1
    monkeypatch.setenv(knob, "bogus")
    assert fn() == default


def test_topk_knob_widens_the_candidates(monkeypatch):
    graph, ctx, plan, res = _port_case()
    monkeypatch.setenv("REPRO_STITCH_TOPK", "1")
    one = tcore.search_groups(graph, plan, V5E,
                              ctx=tcore.CostContext(graph, V5E))
    assert len(one.candidates) == 1 < len(res.candidates)
    assert [g.parts for g in one.groups] == [g.parts for g in res.groups]
