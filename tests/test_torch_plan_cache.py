"""The port's persistent plan cache against the JAX package's.

* Entries: under ``V5E`` the port writes the reference's entry for the
  same function -- the ``patterns`` and ``groups`` sections member for
  member (the quickstart LayerNorm, the RMSNorm, the softmax and a deep
  LayerNorm + GELU chain with stitched groups), and for the reduced Llama
  block the same records up to node ids (its graph differs in detail,
  ``ROADMAP.md`` §C); an entry the reference wrote decodes, with the
  port's ``entry_to_plan`` / ``entry_to_groups`` on the port's graph, to
  the port's own plan and groups.
* The reference's cache tests (``tests/test_plan_dispatch.py``,
  ``tests/test_topk_tune.py``, ``tests/test_guard_faults.py``), on the
  port: signatures, round trips, stale and malformed entries, quarantine
  of a torn or tampered file, the poison list, the LRU grace window, a
  hit in a second process (``EXPLORE_RUNS == 0``), the fault spec.
* The scheduler: a reduced Llama ``ContinuousBatcher`` with
  ``plan_cache`` serves a second time from a fresh model with every
  compile a hit and the same tokens.
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.core import plan_cache as jpc  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import plan_cache as tpc  # noqa: E402
from repro_torch.core.plan_cache import (FORMAT_VERSION, PlanCache,  # noqa
                                         entry_to_groups, entry_to_plan,
                                         graph_signature, plan_to_entry)
from repro_torch.runtime.guard import RUNG_BASELINE, PoisonList  # noqa: E402
from repro_torch.testing import faults  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
rng = np.random.default_rng(53)


def j_layernorm(x, g, b):
    m = jnp.mean(x, axis=-1, keepdims=True)
    v = jnp.mean((x - m) ** 2, axis=-1, keepdims=True)
    return (x - m) * jax.lax.rsqrt(v + 1e-6) * g + b


def t_layernorm(x, g, b):
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + 1e-6) * g + b


def j_rmsnorm(x, g):
    return x * jax.lax.rsqrt(jnp.mean(x ** 2, axis=-1, keepdims=True)
                             + 1e-6) * g


def t_rmsnorm(x, g):
    return x * torch.rsqrt((x ** 2).mean(-1, keepdim=True) + 1e-6) * g


def j_softmax(x):
    e = jnp.exp(x - jnp.max(x, axis=-1, keepdims=True))
    return e / jnp.sum(e, axis=-1, keepdims=True)


def t_softmax(x):
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def j_deep(x, g, b):
    for _ in range(8):
        x = j_layernorm(x, g, b)
        x = 0.5 * x * (1.0 + jnp.tanh(0.7978845608028654
                                      * (x + 0.044715 * (x * x * x)))) + x
    return x


def t_deep(x, g, b):
    for _ in range(8):
        x = t_layernorm(x, g, b)
        x = 0.5 * x * (1.0 + torch.tanh(0.7978845608028654
                                        * (x + 0.044715 * (x * x * x)))) + x
    return x


CASES = {
    "layernorm": (j_layernorm, t_layernorm, [(64, 256), (256,), (256,)]),
    "rmsnorm": (j_rmsnorm, t_rmsnorm, [(64, 256), (256,)]),
    "softmax": (j_softmax, t_softmax, [(64, 256)]),
    "deep": (j_deep, t_deep, [(64, 512), (512,), (512,)]),
}


def _args(shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _entry(root, sig) -> dict:
    with open(os.path.join(root, f"{sig}.json")) as f:
        return json.load(f)


def _both(name, tmp_path):
    """(reference entry, port entry, port compiled, reference entry's
    plan-cache dir) for one case compiled by both packages under V5E."""
    jfn, tfn, shapes = CASES[name]
    args = _args(shapes)
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    jrep = jcore.StitchedFunction(jfn, plan_cache=jdir).report(*args)
    tsf = tcore.stitched_jit(tfn, hw=tcore.V5E, device="cpu",
                             plan_cache=tdir)
    tcomp = tsf.compiled(*[torch.from_numpy(a) for a in args])
    return (_entry(jdir, jrep.signature),
            _entry(tdir, tcomp.report.signature), tcomp)


# -- entries against the reference's ------------------------------------------
@pytest.mark.parametrize("name", sorted(CASES))
def test_entry_sections_are_the_reference_entry(name, tmp_path):
    jentry, tentry, _ = _both(name, tmp_path)
    for key in ("format", "patterns", "groups", "partition_source"):
        assert tentry[key] == jentry[key], key
    if name == "deep":
        assert any(len(r["parts"]) > 1 for r in tentry["groups"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_entry_decodes_to_the_port_plan(name, tmp_path):
    jentry, _, tcomp = _both(name, tmp_path)
    plan, overrides = entry_to_plan(jentry, tcomp.graph)
    assert [p.members for p in plan.patterns] == tcomp.report.patterns
    groups, gover = entry_to_groups(jentry, plan, tcomp.graph)
    assert [g.parts for g in groups] == tcomp.report.groups
    assert [e.estimate.schedule for e in tcomp.emitted] == \
        [o.get("schedule") for o in gover]


def test_reduced_block_entry_is_the_reference_entry_up_to_ids(
        monkeypatch, tmp_path):
    from test_torch_tracer_plan import _block_setup

    jfn, jargs, tfn, targs = _block_setup(monkeypatch)
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    jrep = jcore.StitchedFunction(jfn, plan_cache=jdir).report(*jargs)
    trep = tcore.stitched_jit(tfn, hw=tcore.V5E, device="cpu",
                              plan_cache=tdir).report(*targs)
    jentry, tentry = _entry(jdir, jrep.signature), _entry(tdir,
                                                           trep.signature)

    def shape(entry):
        # the packed patterns' sizes differ with the graphs (§C); every
        # generated pattern has the reference's size and schedule
        pats = [(len(r["members"]) if r["schedule"] != "packed" else None,)
                + tuple(sorted((k, v) for k, v in r.items()
                               if k != "members"))
                for r in entry["patterns"]]
        grps = [(len(r["parts"]), len(r["extra"])) + tuple(
            sorted((k, v) for k, v in r.items()
                   if k not in ("parts", "extra")))
                for r in entry["groups"]]
        return entry["format"], pats, grps, entry["partition_source"]

    assert shape(tentry) == shape(jentry)


# -- signatures and round trips (tests/test_plan_dispatch.py) -----------------
def _ln_graph(shape=(32, 256)):
    x = torch.randn(*shape)
    return tcore.trace(t_layernorm, x, torch.ones(shape[-1]),
                       torch.zeros(shape[-1]))


def test_graph_signature_structural():
    g1, g2 = _ln_graph(), _ln_graph()
    assert graph_signature(g1, tcore.V5E) == graph_signature(g2, tcore.V5E)
    assert graph_signature(g1, tcore.V5E) != \
        graph_signature(_ln_graph((16, 256)), tcore.V5E)


@pytest.mark.parametrize("change", ["remote_fusion", "hardware", "beam"])
def test_graph_signature_covers_the_planner_configuration(change,
                                                          monkeypatch):
    g = _ln_graph()
    base = graph_signature(g, tcore.V5E)
    if change == "remote_fusion":
        other = graph_signature(g, tcore.V5E, remote_fusion=False)
    elif change == "hardware":
        other = graph_signature(g, tcore.H100)
    else:
        monkeypatch.setenv("REPRO_STITCH_BEAM", "2")
        other = graph_signature(g, tcore.V5E)
    assert other != base


@pytest.mark.parametrize("sched", [
    {"schedule": "onepass", "block_rows": 8},
    {"schedule": "streaming", "block_rows": 8, "block_cols": 512}])
def test_plan_cache_roundtrip(sched, tmp_path):
    graph = _ln_graph()
    sig = graph_signature(graph, tcore.V5E)
    plan = tcore.make_plan(graph, tcore.V5E)
    cache = PlanCache(str(tmp_path))
    cache.store(sig, plan_to_entry(plan, [dict(sched) for _ in
                                          plan.patterns], sig))
    entry = cache.load(sig)
    assert entry is not None and entry["format"] == 5
    plan2, overrides = entry_to_plan(entry, graph)
    assert [p.members for p in plan2.patterns] == \
        [p.members for p in plan.patterns]
    assert overrides[0] == sched


def test_plan_cache_rejects_stale_entry():
    graph = _ln_graph()
    assert FORMAT_VERSION == 6
    assert entry_to_plan({"format": FORMAT_VERSION, "signature": "x",
                          "patterns": [{"members": [99999]}]}, graph) is None
    assert entry_to_plan({"format": 1, "patterns": []}, graph) is None
    # v7 (the reference's mesh record) is not read: shard is not ported
    assert entry_to_plan({"format": 7, "patterns": []}, graph) is None
    # v2 is *supported* (degrades to re-tuning groups), not rejected
    assert entry_to_plan({"format": 2, "signature": "x", "patterns": []},
                         graph) is not None


def test_plan_cache_tolerates_malformed_files_and_fields(tmp_path):
    graph = _ln_graph()
    sig = graph_signature(graph, tcore.V5E)
    cache = PlanCache(str(tmp_path))
    with open(os.path.join(str(tmp_path), f"{sig}.json"), "w") as f:
        f.write("[1, 2]")
    assert cache.load(sig) is None
    plan = tcore.make_plan(graph, tcore.V5E)
    entry = plan_to_entry(plan, [{"schedule": "streaming",
                                  "block_rows": "abc", "block_cols": None}
                                 for _ in plan.patterns], sig)
    assert entry_to_plan(entry, graph)[1][0] == {"schedule": "streaming"}
    entry = plan_to_entry(plan, [{"schedule": "bogus", "block_rows": 8}
                                 for _ in plan.patterns], sig)
    assert entry_to_plan(entry, graph)[1][0] == {}


def test_sanitize_override_matches_the_reference():
    recs = [{"schedule": "onepass", "block_rows": 8, "recompute": [3, 1, 3]},
            {"schedule": "streaming", "block_rows": True, "block_cols": 64},
            {"schedule": "anchored", "block_rows": 128},
            {"schedule": "packed"}, {"schedule": "x"}, {}]
    for rec in recs:
        assert tpc._sanitize_override(rec) == jpc._sanitize_override(rec)
        assert tpc.override_fp(rec) == jpc.override_fp(rec)
        assert tpc.entry_checksum(rec) == jpc.entry_checksum(rec)


def test_in_process_cache_hit_same_signature(tmp_path):
    x, g = torch.randn(64, 256), torch.randn(256)
    sf1 = tcore.stitched_jit(t_rmsnorm, device="cpu",
                             plan_cache=str(tmp_path))
    rep1 = sf1.report(x, g)
    assert not rep1.plan_cache_hit and rep1.plan_cache_misses == 1
    sf2 = tcore.stitched_jit(t_rmsnorm, device="cpu",
                             plan_cache=str(tmp_path))
    rep2 = sf2.report(x, g)
    assert rep2.plan_cache_hit and rep2.plan_cache_hits == 1
    assert rep2.signature == rep1.signature
    assert rep2.patterns == rep1.patterns and rep2.groups == rep1.groups
    assert rep2.beam_width == 0          # the stitcher did not run
    torch.testing.assert_close(sf2(x, g), t_rmsnorm(x, g))


def test_env_names_the_cache(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path))
    x = torch.randn(8, 128)
    rep = tcore.stitched_jit(t_softmax, device="cpu").report(x)
    assert os.path.exists(tmp_path / f"{rep.signature}.json")
    assert tcore.stitched_jit(t_softmax, device="cpu").report(
        x).plan_cache_hit


_FRESH_PROC = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch.core import explorer
    from repro_torch.core.stitch import StitchedFunction

    def layernorm(x, g, b):
        m = x.mean(-1, keepdim=True)
        v = ((x - m) ** 2).mean(-1, keepdim=True)
        return (x - m) * torch.rsqrt(v + 1e-5) * g + b

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(32, 256, generator=gen)
    g, b = torch.ones(256), torch.zeros(256)
    sf = StitchedFunction(layernorm, plan_cache=sys.argv[1], device="cpu")
    rep = sf.report(x, g, b)
    err = float((sf(x, g, b) - layernorm(x, g, b)).abs().max())
    print(json.dumps({"cache_hit": rep.plan_cache_hit,
                      "explore_runs": explorer.EXPLORE_RUNS,
                      "signature": rep.signature, "max_err": err}))
""")


def test_plan_cache_hits_across_processes(tmp_path):
    """A second process compiling the same graph hits the cache and skips
    exploration entirely."""
    env = dict(os.environ, PYTHONPATH=SRC)
    results = []
    for _ in range(2):
        proc = subprocess.run(
            [sys.executable, "-c", _FRESH_PROC, str(tmp_path)],
            env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    first, second = results
    assert not first["cache_hit"] and first["explore_runs"] >= 1
    assert second["cache_hit"] and second["explore_runs"] == 0
    assert second["signature"] == first["signature"]
    assert second["max_err"] < 1e-5


# -- integrity: quarantine, poison, eviction (tests/test_guard_faults.py) -----
def _stored(tmp_path):
    graph = _ln_graph()
    sig = graph_signature(graph, tcore.V5E)
    plan = tcore.make_plan(graph, tcore.V5E)
    pc = PlanCache(str(tmp_path))
    pc.store(sig, plan_to_entry(plan, [{} for _ in plan.patterns], sig))
    return pc, sig


@pytest.mark.parametrize("damage", ["tamper", "torn_write", "not_json"])
def test_damaged_entry_is_quarantined_not_crashed_on(damage, tmp_path):
    if damage == "torn_write":
        graph = _ln_graph()
        sig = graph_signature(graph, tcore.V5E)
        plan = tcore.make_plan(graph, tcore.V5E)
        pc = PlanCache(str(tmp_path))
        with faults.inject("cache_corrupt") as armed:
            pc.store(sig, plan_to_entry(plan, [{} for _ in plan.patterns],
                                        sig))
        assert armed.get("cache_corrupt").fired == 1
    else:
        pc, sig = _stored(tmp_path)
        path = tmp_path / f"{sig}.json"
        if damage == "tamper":
            entry = json.loads(path.read_text())
            entry["patterns"][0]["block_rows"] = 99
            path.write_text(json.dumps(entry))
        else:
            path.write_text("{not json")
    assert pc.load(sig) is None
    assert pc.quarantined == 1 and pc.last_error.startswith(sig)
    assert list((tmp_path / "quarantine").iterdir())
    assert not (tmp_path / f"{sig}.json").exists()


def test_torn_entry_replans_cleanly(tmp_path):
    x = torch.randn(32, 256)
    g, b = torch.ones(256), torch.zeros(256)
    with faults.inject("cache_corrupt"):
        tcore.stitched_jit(t_layernorm, device="cpu",
                           plan_cache=str(tmp_path)).report(x, g, b)
    sf = tcore.stitched_jit(t_layernorm, device="cpu",
                            plan_cache=str(tmp_path))
    rep = sf.report(x, g, b)
    assert not rep.plan_cache_hit           # quarantined, re-planned
    torch.testing.assert_close(sf(x, g, b), t_layernorm(x, g, b))
    assert tcore.stitched_jit(t_layernorm, device="cpu",
                              plan_cache=str(tmp_path)).report(
        x, g, b).plan_cache_hit              # and stored again


def test_poison_list_blocks_load_and_store(tmp_path):
    pc, sig = _stored(tmp_path)
    assert pc.load(sig) is not None
    pc.poison.pin(sig, RUNG_BASELINE, "condemned")
    assert PoisonList(str(tmp_path)).rung_for(sig) == RUNG_BASELINE
    pc2 = PlanCache(str(tmp_path))          # the pin is shared on disk
    assert pc2.load(sig) is None and sig in pc2.poison
    assert pc2.evict_entry(sig)
    pc2.store(sig, {"format": 5, "signature": sig, "patterns": []})
    assert not (tmp_path / f"{sig}.json").exists()   # refused
    assert pc2.readmit(sig) and pc2.readmitted == 1
    pc2.store(sig, {"format": 5, "signature": sig, "patterns": []})
    assert pc2.load(sig) is not None
    assert pc2.stats()["poisoned"] == 0


def test_poison_list_is_bounded(tmp_path):
    pl = PoisonList(str(tmp_path), max_entries=2)
    for i, sig in enumerate(("a", "b", "c")):
        pl.pin(sig, "bogus-rung", f"r{i}")
        time.sleep(0.01)
    assert len(pl) == 2 and "a" not in pl
    assert pl.rung_for("c") == RUNG_BASELINE and pl.reason_for("c") == "r2"


def test_evict_grace_protects_concurrent_stores(tmp_path):
    root = str(tmp_path)
    a = PlanCache(root, max_entries=2, evict_grace_s=60.0)
    old = time.time() - 3600
    for name in ("aaa", "bbb", "ccc"):
        a.store(name, {"format": 2, "signature": name, "patterns": []})
        os.utime(os.path.join(root, f"{name}.json"), (old, old))
    b = PlanCache(root, max_entries=2, evict_grace_s=60.0)
    b.store("fresh", {"format": 2, "signature": "fresh", "patterns": []})
    assert b.load("fresh") is not None
    a.store("ggg", {"format": 2, "signature": "ggg", "patterns": []})
    assert a.load("fresh") is not None and a.load("ggg") is not None
    assert a.load("aaa") is None and a.load("bbb") is None
    c = PlanCache(root, max_entries=1, evict_grace_s=60.0)
    c.store("hhh", {"format": 2, "signature": "hhh", "patterns": []})
    for name in ("fresh", "ggg", "hhh"):
        assert c.load(name) is not None


@pytest.mark.parametrize("env,want", [
    ({}, (512, 30.0)),
    ({"REPRO_PLAN_CACHE_MAX": "7", "REPRO_PLAN_CACHE_GRACE": "2.5"},
     (7, 2.5)),
    ({"REPRO_PLAN_CACHE_MAX": "x", "REPRO_PLAN_CACHE_GRACE": "y"},
     (512, 30.0))])
def test_plan_cache_bounds_from_env(env, want, monkeypatch, tmp_path):
    for k in ("REPRO_PLAN_CACHE_MAX", "REPRO_PLAN_CACHE_GRACE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    pc = PlanCache(str(tmp_path))
    assert (pc.max_entries, pc.evict_grace_s) == want


# -- the fault spec (repro.testing.faults) -------------------------------------
@pytest.mark.parametrize("spec", [
    "emit_fail:group=1;tuner_hang:sleep=2,times=2", "race_crash:branch=3",
    "cache_corrupt;bogus_point;verify_flake:seam=serve,times=-1"])
def test_fault_spec_parses_as_the_reference(spec):
    from repro.testing import faults as jfaults

    mine, ref = faults.FaultPlan(spec), jfaults.FaultPlan(spec)
    assert {k: (f.params, f.remaining) for k, f in mine.faults.items()} == \
        {k: (f.params, f.remaining) for k, f in ref.faults.items()}
    assert faults.POINTS == jfaults.POINTS


def test_fault_injection_fires_a_bounded_number_of_times(monkeypatch):
    with faults.inject("tuner_hang:sleep=2,times=2;emit_fail:group=1"):
        assert faults.armed("tuner_hang") and not faults.armed("race_crash")
        assert faults.fire("emit_fail", group=0) is None
        assert faults.fire("emit_fail") is None
        assert faults.fire("emit_fail", group=1) is not None
        assert faults.fire("tuner_hang").sleep_s() == 2.0
        assert faults.fire("tuner_hang") is not None
        assert faults.fire("tuner_hang") is None
    monkeypatch.setenv(faults.ENV_FAULTS, "race_crash")
    faults.reset()
    assert faults.armed("race_crash")
    monkeypatch.setenv(faults.ENV_FAULTS, "")
    assert not faults.armed("race_crash")   # an env change re-parses


# -- the scheduler ---------------------------------------------------------------
def test_scheduler_serves_a_second_time_from_the_cache(tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.core import explorer
    from repro_torch.models.model import Model
    from repro_torch.serving import ContinuousBatcher

    cfg = get_config("llama3.2-3b").reduced()
    params = Model(cfg, device="cpu").init(0)
    prompts = [np.random.default_rng(5).integers(0, cfg.vocab_size, n)
               for n in (5, 9, 12)]

    def serve():
        b = ContinuousBatcher(Model(cfg, device="cpu"), params, n_slots=2,
                              max_len=32, plan_cache=str(tmp_path))
        ids = [b.submit(p, max_new=4) for p in prompts]
        out = b.run()
        return [out[i] for i in ids], b

    first, b1 = serve()
    n = len(b1.mdl.reports())
    assert (b1.stats.plan_cache_hits, b1.stats.plan_cache_misses) == (0, n)
    explored = explorer.EXPLORE_RUNS
    second, b2 = serve()
    assert (b2.stats.plan_cache_hits, b2.stats.plan_cache_misses) == (n, 0)
    assert explorer.EXPLORE_RUNS == explored
    assert b2.stats.tune_s == 0.0
    assert f"plan-cache {n}h/0m" in b2.stats.summary()
    assert second == first


def test_model_keeps_one_set_per_plan_cache(tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    m = Model(get_config("llama3.2-3b").reduced(), device="cpu")
    d = str(tmp_path)
    view = m.with_plan(d)
    assert view is m.with_plan(d) and view is not m
    assert m.with_plan() is m and view.with_plan() is m
    assert view.with_plan(d, autotune=True) is not view
    assert view.pre is not m.pre and view.plan_cache == d
    assert view.cfg is m.cfg and view.device == m.device
