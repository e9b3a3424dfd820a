"""The measured tuner and the plan cache on the card.

Marked ``gpu``: on a host without a CUDA card every test here skips (the
decision is made in a fixture, never at import).  Run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_autotune_gpu.py
"""
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import H100, CostContext, make_plan, \
    search_groups, stitched_jit, trace  # noqa: E402
from repro_torch.core.autotune import tune_group, tune_partitions, \
    tune_pattern  # noqa: E402
from repro_torch.core.codegen import emit_group  # noqa: E402
from repro_torch.core.plan_cache import PlanCache  # noqa: E402

pytestmark = pytest.mark.gpu
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def layernorm(x, g, b):
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + 1e-6) * g + b


def deep(x, g, b):
    for _ in range(4):
        x = layernorm(x, g, b)
        x = 0.5 * x * (1.0 + torch.tanh(0.7978845608028654
                                        * (x + 0.044715 * (x * x * x)))) + x
    return x


def _args(gen, R=4096, C=1024):
    """At this width ``deep`` has three candidate partitions and a
    stitched group under ``H100``."""
    return [torch.randn(R, C, generator=gen, device="cuda"),
            torch.randn(C, generator=gen, device="cuda"),
            torch.randn(C, generator=gen, device="cuda")]


@pytest.mark.parametrize("C", [3072, 65536])
def test_sweep_on_the_card_returns_a_valid_override(cuda, C):
    args = _args(cuda, 1024, C)
    graph = trace(layernorm, *args)
    ctx = CostContext(graph, H100)
    pat = frozenset(graph.fusible_nodes())
    over = tune_pattern(graph, pat, hw=H100, ctx=ctx)
    assert over is not None and over["schedule"] in ("onepass", "streaming")
    em = emit_group(graph, (tuple(sorted(pat)),), hw=H100, ctx=ctx,
                    schedule_override=over)
    assert em.estimate.schedule == over["schedule"]
    got = em.fn(torch.device("cuda"), *args)[0]
    torch.testing.assert_close(got, layernorm(*args), rtol=1e-4, atol=1e-4)


def test_partition_race_times_each_branch_as_a_replay(cuda):
    args = _args(cuda)
    graph = trace(deep, *args)
    ctx = CostContext(graph, H100)
    plan = make_plan(graph, H100, ctx=ctx)
    res = search_groups(graph, plan, H100, ctx=ctx)
    cands = [c.groups for c in res.candidates]
    assert len(cands) == 3
    out = tune_partitions(graph, cands, hw=H100, ctx=ctx)
    assert out is not None and out.disqualified == 0
    assert out.branches >= len(cands)
    assert all(math.isfinite(t) and t > 0 for t in out.measured_s)
    assert "race_timeout" not in ctx.caps


def test_the_tuner_raises_under_capture(cuda):
    args = _args(cuda, 256, 1024)
    graph = trace(layernorm, *args)
    ctx = CostContext(graph, H100)
    parts = (frozenset(graph.fusible_nodes()),)
    g = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(stream):
        g.capture_begin()
        try:
            with pytest.raises(RuntimeError, match="capturing"):
                tune_group(graph, parts, hw=H100, ctx=ctx)
        finally:
            g.capture_end()


_SECOND = """
import json, sys, torch
sys.path.insert(0, sys.argv[2])
from test_torch_autotune_gpu import deep, _args
from repro_torch.core import explorer, stitched_jit
gen = torch.Generator(device="cuda").manual_seed(0)
args = _args(gen)
sf = stitched_jit(deep, plan_cache=sys.argv[1], autotune=True)
rep = sf.report(*args)
err = float((sf(*args) - deep(*args)).abs().max())
print(json.dumps({"hit": rep.plan_cache_hit, "explore": explorer.EXPLORE_RUNS,
                  "tune_s": rep.tune_s, "source": rep.partition_source,
                  "err": err}))
"""


def test_measured_plan_is_stored_and_a_second_process_hits(cuda, tmp_path):
    args = _args(cuda)
    sf = stitched_jit(deep, plan_cache=str(tmp_path), autotune=True)
    rep = sf.report(*args)
    assert rep.autotuned and rep.tune_s > 0 and not rep.plan_cache_hit
    torch.testing.assert_close(sf(*args), deep(*args), rtol=1e-4, atol=1e-4)
    entry = PlanCache(str(tmp_path)).load(rep.signature)
    assert entry["partition_source"] == rep.partition_source
    assert rep.partition_candidates == 3 and rep.group_tuned >= 1
    assert rep.partition_source == "measured"
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-c", _SECOND, str(tmp_path),
         os.path.dirname(__file__)], env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["hit"] and out["explore"] == 0 and out["tune_s"] == 0.0
    assert out["source"] == rep.partition_source and out["err"] < 1e-3
