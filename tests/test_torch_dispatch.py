"""One dispatch a stitched call, donation, and the scheduler's captured
prefill: the PyTorch port against the JAX package on the CPU.

The same numpy inputs go through ``repro.core.StitchedFunction`` (Pallas
interpret mode, ``V5E``) and the port's (``V5E``, ``device="cpu"``): the
donated flat positions (``donate``, ``donate_argnums``) and the first
kernel's aliased outputs (``io_aliases``) are the reference's, a donated
input's storage holds the output it was aliased to, and the outputs
agree with the reference and with ``dispatch="interpret"`` within 1e-5
max(1, max|y|).  On the CPU no graph is captured: ``exec_count`` counts
every call.  ``ContinuousBatcher(capture=True)`` runs the captured
prefill's function (a staged cache, the token at the true last
position) eagerly here; its tokens equal ``capture=False``'s and the
reference scheduler's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serving import ContinuousBatcher as JBatcher  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import ContinuousBatcher  # noqa: E402

rng = np.random.default_rng(27)


# -- the reference tests' functions, on both sides ---------------------------
def j_ln(x, g, b):
    m = jnp.mean(x, axis=-1, keepdims=True)
    v = jnp.mean((x - m) ** 2, axis=-1, keepdims=True)
    return (x - m) * jax.lax.rsqrt(v + 1e-5) * g + b


def t_ln(x, g, b):
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + 1e-5) * g + b


def j_deep(x, g, b):
    """``tests/test_stitch_groups.py::_deep`` (and test_beam_stitch's)."""
    for _ in range(8):
        x = j_ln(x, g, b)
        x = jax.nn.gelu(x, approximate=True) + x
    return x


def t_deep(x, g, b):
    for _ in range(8):
        x = t_ln(x, g, b)
        x = torch.nn.functional.gelu(x, approximate="tanh") + x
    return x


def _deep_args(R=16, C=256):
    x = rng.standard_normal((R, C)).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    return x, g, b


def _pass_args():
    return (rng.standard_normal((8, 128)).astype(np.float32),
            np.ones(128, np.float32))


def _kv_args():
    return (np.ones((4, 8), np.float32), np.zeros((4, 8), np.float32),
            np.ones(8, np.float32))


#: name -> (reference function, port function, args, donate options):
#: ``tests/test_stitch_groups.py:388`` (``_deep`` with ``donate=True``,
#: ``x, x * g``, the default), ``tests/test_serving_stitched.py:198``
#: (``donate_argnums=(1,)`` on a cache written at row 0, and on a
#: function returning the cache), ``tests/test_beam_stitch.py:320-350``
#: (``x, tanh(x * g) + x``).
CASES = {
    "deep_donate": (j_deep, t_deep, _deep_args, dict(donate=True)),
    "deep_default": (j_deep, t_deep, _deep_args, {}),
    "passthrough_mul": (lambda x, g: (x, x * g), lambda x, g: (x, x * g),
                        lambda: _pass_args(), dict(donate=True)),
    "passthrough_tanh": (lambda x, g: (x, jnp.tanh(x * g) + x),
                         lambda x, g: (x, torch.tanh(x * g) + x),
                         lambda: _pass_args(), dict(donate=True)),
    "cache_only": (
        lambda w, kv, tok: ((kv.at[0].set(tok) * w).sum(),
                            kv.at[0].set(tok)),
        lambda w, kv, tok: ((torch.cat([tok[None], kv[1:]]) * w).sum(),
                            torch.cat([tok[None], kv[1:]])),
        _kv_args, dict(donate_argnums=(1,))),
    "cache_is_output": (lambda w, kv: (kv, (kv * w).sum()),
                        lambda w, kv: (kv, (kv * w).sum()),
                        lambda: _kv_args()[:2], dict(donate_argnums=(1,))),
}


def _pair(name):
    jfn, tfn, make, opts = CASES[name]
    args = make()
    jsf = jcore.StitchedFunction(jfn, hw=jcore.V5E, **opts)
    tsf = tcore.StitchedFunction(tfn, hw=tcore.V5E, device="cpu", **opts)
    return jsf, tsf, args


def _kernels(compiled, kind):
    return [em for k, em in compiled.schedule if k == kind]


@pytest.mark.parametrize("name", sorted(CASES))
def test_donated_positions_and_aliases_match_reference(name):
    """The port's ``donate_argnums`` and the aliased (input, output)
    positions of each emitted kernel are the reference's."""
    jsf, tsf, args = _pair(name)
    jc = jsf.compiled(*args)
    tc = tsf.compiled(*(torch.from_numpy(a.copy()) for a in args))
    assert tc.donate_argnums == jc.donate_argnums
    jal = [em.io_aliases or {} for em in _kernels(jc, "pattern")
           if em.kind == "pallas"]
    tal = [em.io_aliases or {} for em in _kernels(tc, "group")
           if em.generated]
    assert tal == jal
    # the aliased pairs name the same graph nodes on both sides
    jpairs = [(em.ext_ids[i], em.out_ids[o]) for em in _kernels(jc, "pattern")
              for i, o in (em.io_aliases or {}).items()]
    tpairs = [(em.ext_ids[i], em.out_ids[o]) for em in _kernels(tc, "group")
              for i, o in (em.io_aliases or {}).items()]
    assert [jc.graph.inputs.index(e) for e, _ in jpairs] == \
        [tc.graph.inputs.index(e) for e, _ in tpairs]


@pytest.mark.filterwarnings("ignore:Some donated buffers were not usable")
@pytest.mark.parametrize("name", sorted(CASES))
def test_donated_outputs_match_reference_and_interpret(name):
    """Outputs against the reference and ``dispatch="interpret"`` within
    1e-5 max(1, max|y|); each aliased output lives in its donated input's
    storage, which holds it after the call."""
    jsf, tsf, args = _pair(name)
    jfn, tfn, _, _ = CASES[name]
    want = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, jsf(*(jnp.asarray(a)
                                                  for a in args))))
    tin = [torch.from_numpy(a.copy()) for a in args]
    got = torch.utils._pytree.tree_leaves(tsf(*tin))
    interp = torch.utils._pytree.tree_leaves(tcore.stitched_jit(
        tfn, hw=tcore.V5E, dispatch="interpret", device="cpu")(
            *(torch.from_numpy(a.copy()) for a in args)))
    assert len(got) == len(want) == len(interp)
    for g, w, i in zip(got, want, interp):
        lim = 1e-5 * max(1.0, float(np.abs(w).max()))
        assert np.abs(g.numpy() - w).max() <= lim
        assert float((g - i).abs().max()) <= lim
    tc = tsf.compiled(*(torch.from_numpy(a.copy()) for a in args))
    for em in _kernels(tc, "group"):
        for i, o in (em.io_aliases or {}).items():
            k = tc.graph.inputs.index(em.ext_ids[i])
            y = got[tc.graph.outputs.index(em.out_ids[o])]
            assert y.data_ptr() == tin[k].data_ptr()
            assert torch.equal(tin[k].reshape(y.shape), y)


def test_default_and_interpret_alias_nothing():
    """No donation without ``donate``; ``dispatch="interpret"`` and
    ``differentiable=True`` donate nothing either, as in the reference."""
    args = [torch.from_numpy(a) for a in _deep_args()]
    for sf in (tcore.StitchedFunction(t_deep, hw=tcore.V5E, device="cpu"),
               tcore.StitchedFunction(t_deep, hw=tcore.V5E, device="cpu",
                                      donate=True, dispatch="interpret")):
        c = sf.compiled(*args)
        assert c.donate_argnums == ()
        assert all(not em.io_aliases for em in _kernels(c, "group"))
    x = args[0].clone()
    y = tcore.stitched_jit(t_deep, hw=tcore.V5E, device="cpu")(x, *args[1:])
    assert torch.equal(x, args[0]) and y.data_ptr() != x.data_ptr()
    d = tcore.stitched_jit(t_deep, hw=tcore.V5E, device="cpu",
                           differentiable=True, donate=True)
    assert d.compiled(*args).donate_argnums == ()


def test_streaming_alias_rule():
    """B2 aliases a staged full-row input while its cluster holds the
    whole row, and never a row longer than the cluster holds (the
    columns past the stage are read from device memory in every
    phase)."""
    from repro_torch.core.codegen import emit_pattern
    from repro_torch.core.tracer import trace

    def softmax(v):
        return torch.softmax(v, -1)

    for C, aliased in ((65536, True), (600000, False)):
        x = torch.zeros(4, C)
        g = trace(softmax, x)
        pat = frozenset(n for n in g.fusible_nodes())
        em = emit_pattern(g, pat, schedule_override={
            "schedule": "streaming", "block_rows": 1, "block_cols": 2048},
            donate_into=frozenset(g.inputs))
        assert em.kind == "streaming"
        _, width, staged = em.fn.cluster()
        assert (staged == width) is aliased
        assert bool(em.io_aliases) is aliased
        if aliased:
            xin = torch.randn(4, C)
            want = torch.softmax(xin, -1)
            (out,) = em.fn("cpu", xin)
            assert out.data_ptr() == xin.data_ptr()
            assert float((out - want).abs().max()) <= 1e-6


@pytest.mark.parametrize("dispatch", ["single", "interpret"])
def test_exec_count_counts_each_call_on_the_cpu(dispatch):
    """On the CPU no graph is captured: the schedule (or the op-by-op
    replay) runs in Python at each call, as the reference's interpreter
    does; the reference's single dispatch runs it once."""
    args = _deep_args()
    tsf = tcore.StitchedFunction(t_deep, hw=tcore.V5E, device="cpu",
                                 dispatch=dispatch)
    targs = [torch.from_numpy(a) for a in args]
    c = tsf.compiled(*targs)
    for _ in range(3):
        tsf(*targs)
    assert c.exec_count == 3
    assert c.graphs is None
    assert c.report.graph_captures == c.report.graph_replays == 0
    jsf = jcore.StitchedFunction(j_deep, hw=jcore.V5E, dispatch=dispatch)
    jc = jsf.compiled(*args)
    for _ in range(3):
        jsf(*args)
    assert jc.exec_count == (1 if dispatch == "single" else 3)


# -- which calls capture a graph on the card (``_Graphs``) --------------------
class _Rep:
    """A stand-in for a captured graph: ``held`` says whether a caller
    keeps its outputs."""

    def __init__(self, held: bool):
        self.held = held

    def busy(self) -> bool:
        return self.held


def _sig():
    """A signature's report (its evictions)."""
    return tcore.stitch.StitchReport(stats=None, n_generated=0, n_packed=0,
                                     scratch_bytes=0, scratch_naive_bytes=0,
                                     plan_time_s=0.0)


def _dispatch(calls, held=False) -> tuple[str, list]:
    """Run ``calls`` ([(signature index, address set)]) through one
    function's ``_Graphs``: 'e' an eager run, 'c' a capture (then its
    replay), 'r' a replay; and the evictions of each signature."""
    graphs, sigs, out = tcore.stitch._Graphs(), {}, ""
    for sig, key in calls:
        rep_of = sigs.setdefault(sig, _sig())
        rep, capture = graphs.lookup(rep_of, key)
        if rep is not None:
            out += "r"
        elif capture:
            graphs.add(rep_of, key, _Rep(held))
            out += "c"
        else:
            out += "e"
    return out, [sigs[k].graph_evictions for k in sorted(sigs)]


_N = tcore.stitch.GRAPHS_PER_FUNCTION

#: name -> (calls, outputs held, decisions, evictions a signature)
ADMISSION = {
    # the reference's three calls: one eager first sight, then a capture
    "repeat": ([(0, "a")] * 4, False, "ecrr", [0]),
    # a layer loop over more weight sets than the graphs kept: every call
    # costs an eager call, no capture is ever dropped unreplayed
    "layer_loop": ([(0, k) for k in "abcdefg"] * 3, False, "e" * 21, [0]),
    # as many sets as the graphs kept: captured in the second round
    "cycle_fits": ([(0, k) for k in "abcd"[:_N]] * 3, False,
                   "e" * _N + "c" * _N + "r" * _N, [0]),
    # y = f(x) in a loop keeps the last y: a second graph, then eager
    "outputs_held": ([(0, "a")] * 5, True, "eccee", [0]),
    # the limit is the function's, over its signatures
    "two_signatures": ([(0, "a"), (1, "a"), (0, "b"), (1, "b")] * 2
                       + [(0, "c"), (0, "c")], False,
                       "eeeecccc" + "ec", [1, 0]),
}


@pytest.mark.parametrize("name", sorted(ADMISSION))
def test_graph_admission(name):
    """A set of addresses is captured when it comes back among the last
    ``GRAPHS_PER_FUNCTION`` sets the function saw; its first call runs
    eagerly.  A set whose graphs' outputs are all held gets a second
    graph, then runs eagerly; the least recently used graph of the
    function goes first."""
    calls, held, want, evictions = ADMISSION[name]
    assert _dispatch(calls, held) == (want, evictions)


# -- a row view where the rows are as many as the columns --------------------
def _ln_eps6(x, g, b):
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + 1e-6) * g + b


#: name -> (function, shapes of its inputs): R == C, so a [C] parameter
#: and a row's [R] scalars have one size
SQUARE = {
    "layernorm_64": (_ln_eps6, [(64, 64), (64,), (64,)]),
    "layernorm_1x128x128": (_ln_eps6, [(1, 128, 128), (128,), (128,)]),
    "softmax_bias": (lambda x, b: torch.softmax(x + b, -1)
                     * x.sum(-1, keepdim=True), [(64, 64), (64,)]),
    "rowsum_plus_vector": (lambda x, g: x.sum(-1) * 2.0 + g,
                           [(64, 64), (64,)]),
}


@pytest.mark.parametrize("name", sorted(SQUARE))
def test_square_row_view(name):
    """Where R == C a tensor's size does not tell a column parameter from
    a row's scalars: the generated kernels (their plain versions here)
    give PyTorch's result, a LayerNorm's gamma and beta being columns."""
    fn, shapes = SQUARE[name]
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in shapes]
    sf = tcore.StitchedFunction(fn, device="cpu")
    got, want = sf(*args), fn(*args)
    assert float((got - want).abs().max()) <= 1e-5 * max(
        1.0, float(want.abs().max()))
    c = sf.compiled(*args)
    if fn is _ln_eps6:
        (em,) = [em for k, em in c.schedule if k == "group"]
        g, b = c.graph.inputs[1:]
        assert em.fn.roles[g] is em.fn.roles[b] is tcore.rowspec.Role.COL


# -- the scheduler's captured prefill ----------------------------------------
_MODELS: dict = {}


def _setup(arch):
    if arch not in _MODELS:
        jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
        jm = build_model(jcfg, "xla", remat=False)
        jparams = jm.init(jax.random.PRNGKey(0))
        tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                                  device="cpu")
        _MODELS[arch] = (cfg, jm, jparams, tparams)
    return _MODELS[arch]


@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-moe-1b-a400m"])
def test_captured_prefill_tokens_match_eager_and_reference(arch):
    """``capture=True`` (the captured prefill's function, run eagerly on
    the CPU: a staged batch-1 cache copied into the slot, the greedy
    token read at the true last position) gives ``capture=False``'s
    tokens and the reference scheduler's, and leaves the same cache."""
    cfg, jm, jparams, tparams = _setup(arch)
    p_rng = np.random.default_rng(5)
    prompts = [p_rng.integers(0, cfg.vocab_size, n).astype(np.int64)
               for n in (9, 5, 13, 6, 11, 3)]
    jserver = JBatcher(jm, jparams, n_slots=2, max_len=40)
    jids = [jserver.submit(p.astype(np.int32), max_new=4) for p in prompts]
    want = jserver.run()
    got = {}
    caches = {}
    for capture in (True, False):
        server = ContinuousBatcher(Model(cfg, device="cpu"), tparams,
                                   n_slots=2, max_len=40, capture=capture)
        assert (server._prefills is not None) is capture
        ids = [server.submit(p, max_new=4) for p in prompts]
        assert ids == jids
        got[capture] = server.run()
        caches[capture] = server.cache
        st = server.stats
        assert st.prefills == len(prompts)
        assert len(st.prefill_s) == len(prompts)
        assert st.prefill_captures == st.prefill_replays == 0
    assert got[True] == got[False]
    for rid in jids:
        assert got[True][rid] == want[rid], f"request {rid}"
    for name in caches[True]:
        assert torch.equal(caches[True][name], caches[False][name])


def test_recurrent_prefill_stays_eager():
    """The recurrent families keep exact prompt lengths and an eager
    prefill: no bucket graph, with ``capture=True`` too."""
    cfg, _, _, tparams = _setup("mamba2-370m")
    server = ContinuousBatcher(Model(cfg, device="cpu"), tparams,
                               n_slots=2, max_len=32)
    assert server._pad_prompts is False and server._prefills is None
