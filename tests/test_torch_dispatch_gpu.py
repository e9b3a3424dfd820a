"""One dispatch a stitched call on the card: ``dispatch="single"`` as a
replayed CUDA graph, donation, and the scheduler's captured prefill.

Marked ``gpu``: on a host without a CUDA card every test here skips (the
decision is made in a fixture, never at import).  Run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_dispatch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import stitched_jit  # noqa: E402
from repro_torch.core.capture import CapturedStep  # noqa: E402
from repro_torch.core.stitch import GRAPHS_PER_FUNCTION  # noqa: E402
from repro_torch.core.codegen import OnePassKernel  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

pytestmark = pytest.mark.gpu


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
        x = torch.nn.functional.gelu(x, approximate="tanh") + x
    return x


def mini_transformer(x, g1, b1, w1, w2):
    """``tests/test_plan_dispatch.py::mini_transformer``."""
    h = layernorm(x, g1, b1)
    u = torch.nn.functional.gelu(h @ w1, approximate="tanh")
    return torch.softmax(x + u @ w2, -1)


def _mini_args(gen, R=256, C=512, H=1024):
    def r(*s, scale=1.0):
        return torch.randn(*s, generator=gen, device="cuda") * scale

    return (r(R, C), r(C).abs() + 0.5, r(C), r(C, H, scale=C ** -0.5),
            r(H, C, scale=H ** -0.5))


def _close(got, want):
    lim = 1e-5 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= lim


def _kernels(fn, calls=3):
    """{kernel name: launches a call}: the largest count any of the last
    ``calls`` calls of ``fn`` gave, in one profiler session of one call
    more (the profiler can lose records of a session's first kernels),
    each call after spin kernels that mark where it starts; copies and
    fills left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(1 + calls):
            torch.cuda._sleep(1_000_000)
            for _ in range(4):  # one lost record does not merge two calls
                torch.cuda._sleep(1)
            fn()
        torch.cuda.synchronize()
    per_call, spin = [], False
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if getattr(e, "device_type", None) != DeviceType.CUDA or \
                e.name.lower().startswith(("memcpy", "memset")) or \
                e.name == "Command Buffer Full":
            continue
        if "spin_kernel" in e.name:
            if not spin:  # a call: the records after a run of spins
                per_call.append({})
            spin = True
        elif per_call:
            spin = False
            per_call[-1][e.name] = per_call[-1].get(e.name, 0) + 1
    # a loss at the start can merge the first call's spin runs with the
    # next's, or take the first run: the last calls are counted alike
    assert calls <= len(per_call) <= 1 + calls, len(per_call)
    out: dict = {}
    for c in per_call[-calls:]:
        for k, n in c.items():
            out[k] = max(out.get(k, 0), n)
    assert out, "the profiler saw no kernel"
    return out


def test_three_calls_replay_one_graph(cuda):
    """The reference's ``test_single_dispatch_is_one_python_call`` on the
    card: the first call runs the schedule eagerly, the second captures
    it (no warm-up run) and replays it; then three calls leave ``exec_count`` where the
    capture left it and replay the graph; the profiler sees the eager
    schedule's kernels once a call."""
    args = _mini_args(cuda)
    f = stitched_jit(mini_transformer)
    c = f.compiled(*args)
    want = stitched_jit(mini_transformer, dispatch="interpret")(*args)
    _close(f(*args), want)
    assert c.exec_count == 1 and c.report.graph_eager_runs == 1
    assert c.report.graph_captures == 0
    _close(f(*args), want)
    n = c.exec_count
    assert n == 2 and c.report.graph_captures == 1
    for _ in range(3):
        f(*args)
    assert c.exec_count == n and c.report.graph_eager_runs == 1
    assert c.report.graph_replays == 4 and c.report.graph_captures == 1
    replayed = _kernels(lambda: f(*args))
    assert c.exec_count == n
    assert replayed == _kernels(lambda: c.run_schedule(*args))


def test_an_earlier_output_is_not_overwritten(cuda):
    """``y1 = f(x); ...; y2 = f(x)`` at the same addresses: ``y1`` (a
    replay's output) is still referenced, so the next call captures a
    second graph and ``y1`` keeps its values; once ``y1`` is dropped its
    graph is replayed again.  The first call's eager output is kept
    too."""
    x, g, b = (torch.randn(s, generator=cuda, device="cuda")
               for s in ((512, 768), (768,), (768,)))
    x2 = torch.randn(512, 768, generator=cuda, device="cuda")
    f = stitched_jit(layernorm)
    c = f.compiled(x, g, b)
    y0 = f(x, g, b)
    y1 = f(x, g, b)
    kept = y1.clone()
    want2 = layernorm(x2, g, b)
    x.copy_(x2)
    y2 = f(x, g, b)
    assert torch.equal(y1, kept) and torch.equal(y0, kept)
    _close(y2, want2)
    assert c.report.graph_captures == 2
    del y1
    y3 = f(x, g, b)
    _close(y3, want2)
    assert torch.equal(y2, y3) and c.report.graph_captures == 2
    assert c.report.graph_replays == 3


def test_a_new_address_set_captures_a_second_graph(cuda):
    """Other input addresses are another graph once they come back; the
    first is replayed again for its own.  Sets that come back only after
    more than ``GRAPHS_PER_FUNCTION`` others (a layer loop over per-layer
    weights) run eagerly and capture nothing."""
    g, b = torch.ones(768, device="cuda"), torch.zeros(768, device="cuda")
    xs = [torch.randn(512, 768, generator=cuda, device="cuda")
          for _ in range(GRAPHS_PER_FUNCTION + 1)]
    f = stitched_jit(layernorm)
    c = f.compiled(xs[0], g, b)
    for _ in range(3):
        for x in xs:
            _close(f(x, g, b), layernorm(x, g, b))
    assert c.report.graph_captures == 0 and not c.graphs
    assert c.report.graph_eager_runs == 3 * len(xs)
    x1, x2 = xs[:2]
    for x in (x1, x2, x1, x2):
        _close(f(x, g, b), layernorm(x, g, b))
    assert c.report.graph_captures == 2
    _close(f(x1, g, b), layernorm(x1, g, b))
    assert c.report.graph_captures == 2 and len(c.graphs) == 2


def test_a_call_inside_a_captured_step_is_recorded(cuda):
    """Inside another capture the schedule runs directly: the outer
    graph records its kernel, and a replay of the step runs no Python of
    the stitched function."""
    g, b = torch.ones(768, device="cuda"), torch.zeros(768, device="cuda")
    f = stitched_jit(layernorm)
    step = CapturedStep(lambda x: f(x, g, b) * 2.0)
    x = torch.randn(512, 768, generator=cuda, device="cuda")
    _close(step(x), 2.0 * layernorm(x, g, b))
    assert step.kernels[OnePassKernel] == 1
    c = f.compiled(step.inputs[0], g, b)
    assert c.report.graph_captures == 0  # none in the step's warm-up
    n, before = c.exec_count, OnePassKernel.launches
    x2 = torch.randn(512, 768, generator=cuda, device="cuda")
    _close(step(x2), 2.0 * layernorm(x2, g, b))
    assert c.exec_count == n and OnePassKernel.launches == before + 1


def test_a_failed_capture_raises(cuda, monkeypatch):
    """A schedule that syncs with the host cannot be captured: the call
    raises, nothing runs it eagerly in the capture's place, and the
    card is usable after."""
    x, g, b = (torch.randn(s, generator=cuda, device="cuda")
               for s in ((64, 256), (256,), (256,)))
    f = stitched_jit(layernorm)
    c = f.compiled(x, g, b)
    run = c.run_schedule

    def syncs(*a):
        out = run(*a)
        float(out[0].sum())  # a read back to the host
        return out

    monkeypatch.setattr(c, "run_schedule", syncs)
    f(x, g, b)  # the first call runs eagerly: a sync is allowed there
    with pytest.raises(RuntimeError):
        f(x, g, b)
    assert c.report.graph_captures == 0 and c.report.graph_replays == 0
    assert c.report.graph_eager_runs == 1 and c.exec_count == 2
    assert not c.graphs
    torch.cuda.synchronize()
    assert float(torch.ones(2, device="cuda").sum()) == 2.0


def test_an_in_place_input_is_written_once_a_call(cuda):
    """A function that adds to its input in place: the capture runs
    nothing, so every call -- eager, capturing, replayed -- adds once."""
    def bump(x, y):
        return x.add_(y) * 2.0

    x = torch.zeros(256, 512, device="cuda")
    y = torch.ones(256, 512, device="cuda")
    f = stitched_jit(bump)
    for n in range(1, 5):
        out = f(x, y)
        assert float(x.max()) == float(x.min()) == float(n)
        assert float(out.max()) == 2.0 * n
        del out  # a held output would take a second graph
    c = f.compiled(x, y)
    assert c.report.graph_captures == 1 and c.report.graph_replays == 3


@pytest.mark.parametrize("R,C", [(512, 768), (64, 65536)])
def test_donation_aliases_on_the_card(cuda, R, C):
    """``donate=True``: the first kernel (one-pass, or B2 where the row is
    long) writes its output over x, the result agrees with the op-by-op
    replay, and later calls at the donated address capture and replay a
    graph that reads x as the caller left it."""
    x, g, b = (torch.randn(s, generator=cuda, device="cuda")
               for s in ((R, C), (C,), (C,)))
    fn = deep if C < 4096 else layernorm
    f = stitched_jit(fn, donate=True)
    ref = stitched_jit(fn, dispatch="interpret")(x, g, b)
    xin = x.clone()
    c = f.compiled(xin, g, b)
    assert c.donate_argnums == (0, 1, 2)
    first = [em for k, em in c.schedule if k == "group"][0]
    assert first.io_aliases, first.kind
    y = f(xin, g, b)  # eager
    assert y.data_ptr() == xin.data_ptr()
    _close(y, ref)
    for _ in range(2):  # a capture, then a replay
        xin.copy_(x)
        y2 = f(xin, g, b)
        assert y2.data_ptr() == xin.data_ptr()
        _close(y2, ref)
    assert c.report.graph_captures == 1 and c.report.graph_replays == 2


@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-moe-1b-a400m"])
def test_captured_prefill_gives_the_eager_token(cuda, arch):
    """The scheduler's bucketed prefill as one replayed graph a bucket:
    the same tokens as the eager prefill (and the CPU), one capture a
    bucket, every other prefill a replay."""
    from repro_torch.serving import ContinuousBatcher

    cfg = get_config(arch).reduced()
    gpu = Model(cfg)
    params = torch.utils._pytree.tree_map(
        lambda t: t.cuda(), Model(cfg, device="cpu").init(0))
    prompts = [np.random.default_rng(i).integers(0, cfg.vocab_size, n)
               for i, n in enumerate((9, 5, 13, 7, 11, 6))]

    def serve(mdl, p, capture):
        b = ContinuousBatcher(mdl, p, n_slots=3, max_len=48, capture=capture)
        ids = [b.submit(q, max_new=5) for q in prompts]
        out = b.run()
        return [out[r] for r in ids], b

    got, bc = serve(gpu, params, True)
    want, be = serve(gpu, params, False)
    assert got == want
    buckets = {bc.buckets.pad_len(len(q), cap=48) for q in prompts}
    st = bc.stats
    assert st.prefill_captures == len(buckets) == len(bc._prefills)
    assert st.prefill_replays == len(prompts) and st.prefill_pool_bytes > 0
    assert be.stats.prefill_captures == 0
    for name in bc.cache:
        lim = 1e-4 * max(1.0, float(be.cache[name].abs().max()))
        assert float((bc.cache[name] - be.cache[name]).abs().max()) <= lim
    cpu = Model(cfg, device="cpu")
    cparams = torch.utils._pytree.tree_map(lambda t: t.cpu(), params)
    assert serve(cpu, cparams, True)[0] == got
