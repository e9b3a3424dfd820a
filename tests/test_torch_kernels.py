"""The hand-written kernels' modules on the CPU: each custom operator's
plain version against the JAX package's Pallas kernel in interpret mode
(same numpy inputs), the oracles against ``repro.kernels.ref``, the
operators as single opaque nodes of a traced graph, ``ops``' switch, and
the CUDA build's refusal where there is no ``nvcc``."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm_fwd as jrmsnorm_fwd  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import trace  # noqa: E402
from repro_torch.core.ir import OpKind  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402
from repro_torch.models.layers import STITCHED  # noqa: E402
from repro_torch.models.model import block_apply, block_init  # noqa: E402

rng = np.random.default_rng(12)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(37, 96), (2, 5, 64), (1, 200)])
def test_rmsnorm_matches_the_pallas_kernel(shape):
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape[-1]).astype(np.float32)
    # block_rows 16: rows that are not a multiple of the block
    jy, jr = jrmsnorm_fwd(jnp.asarray(x), jnp.asarray(g), eps=1e-6,
                          block_rows=16, interpret=True)
    before = RN.rmsnorm_cuda.launches
    y, rstd = RN.rmsnorm(torch.from_numpy(x), torch.from_numpy(g), 1e-6)
    assert RN.rmsnorm_cuda.launches == before   # the plain version ran
    assert rstd.shape == (x.size // shape[-1], 1) and rstd.dtype == \
        torch.float32
    # float32, the same formula: a few ulp
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jr), rtol=1e-6,
                               atol=1e-6)


def test_rmsnorm_op_equals_the_oracle():
    x = torch.from_numpy(rng.standard_normal((3, 7, 48)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(48).astype(np.float32))
    torch.testing.assert_close(ops.rmsnorm(x, g, 1e-6),
                               ops.rmsnorm(x, g, 1e-6, use_kernels=False),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
FLASH_CASES = {"causal": (40, 40, True), "causal-offset": (8, 40, True),
               "noncausal-ragged": (24, 40, False)}


def _qkv(Sq, Skv, B=2, Hq=4, Hkv=2, D=32):
    return (rng.standard_normal((B, Hq, Sq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32))


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_matches_the_pallas_kernel(case):
    Sq, Skv, causal = FLASH_CASES[case]
    q, k, v = _qkv(Sq, Skv)
    # 16-row blocks: Skv 40 leaves a ragged, padded last K block
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, block_q=16, block_k=16, interpret=True)
    before = FA.flash_attention_cuda.launches
    got = FA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal, None)
    assert FA.flash_attention_cuda.launches == before
    # float32, one softmax pass against the kernel's online one
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_flash_attention_scale_and_refusals():
    qn, kn, vn = _qkv(8, 8)
    want = jflash(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                  causal=False, scale=0.5, block_q=4, block_k=4,
                  interpret=True)
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    got = FA.flash_attention(q, k, v, False, 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(ValueError, match="Sq <= Skv"):
        FA.flash_attention_plain(q, k[:, :, :4], v[:, :, :4], True)
    with pytest.raises(ValueError, match="Hq % Hkv"):
        FA.flash_attention_plain(q[:, :3], k, v, False)
    # the CUDA wrapper never takes a CPU tensor to its plain version
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_cuda(q, k, v, False)
    with pytest.raises(ValueError, match="CUDA"):
        RN.rmsnorm_cuda(q, torch.ones(32), 1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_oracle_matches_the_reference(causal):
    q, k, v = _qkv(12, 20)
    want = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal)
    got = ref.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                        causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_decode_attention_oracle_matches_the_reference():
    q = rng.standard_normal((3, 4, 32)).astype(np.float32)
    _, k, v = _qkv(1, 24, B=3)
    lengths = np.array([1, 9, 24], np.int64)
    want = jref.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v),
                                 lengths=jnp.asarray(lengths, jnp.int32))
    got = ref.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v),
                               lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_decode_attention_switch():
    q = torch.from_numpy(rng.standard_normal((2, 4, 32)).astype(np.float32))
    k, v = (torch.from_numpy(a) for a in _qkv(1, 16)[1:])
    # a tensor kv_len masks (both modes); an int slices (plain mode) or
    # streams the live prefix through flash_decode (kernels)
    masked = ops.decode_attention(q, k, v, kv_len=torch.tensor(5))
    sliced = ops.decode_attention(q, k, v, kv_len=5, use_kernels=False)
    torch.testing.assert_close(masked, sliced, rtol=1e-5, atol=1e-6)
    static = ops.decode_attention(q, k, v, kv_len=5)
    torch.testing.assert_close(static, sliced, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the operators in a traced graph
# ---------------------------------------------------------------------------
def _op_nodes(gm, name):
    return [n for n in gm.graph.nodes if n.op == "call_function"
            and str(n.target).startswith(f"repro_torch.{name}")]


@pytest.mark.parametrize("mode", ["fake", "meta"])
def test_each_operator_is_one_node(mode):
    dev = "meta" if mode == "meta" else "cpu"
    x = torch.randn(6, 64, device=dev)
    g = torch.randn(64, device=dev)
    q = torch.randn(1, 4, 8, 32, device=dev)
    kv = torch.randn(1, 2, 8, 32, device=dev)
    trace_mode = "fake" if mode == "fake" else "real"
    gm = make_fx(lambda a, b: ops.rmsnorm(a, b, 1e-6) * 2.0,
                 tracing_mode=trace_mode)(x, g)
    assert len(_op_nodes(gm, "rmsnorm")) == 1
    gm = make_fx(lambda a, b, c: ops.attention(a, b, c),
                 tracing_mode=trace_mode)(q, kv, kv)
    assert len(_op_nodes(gm, "flash_attention")) == 1


def test_operators_lower_to_opaque_nodes():
    x, g = torch.randn(6, 64), torch.randn(64)
    graph = trace(lambda a, b: ops.rmsnorm(a, b, 1e-6) + 1.0, x, g)
    rms = [n for n in graph.nodes.values()
           if n.prim == "repro_torch.rmsnorm.default"]
    assert len(rms) == 1 and rms[0].kind is OpKind.OPAQUE
    assert rms[0].params["multi_out"] == 2
    # y goes through the tracer's tuple_get; the unused rstd is pruned
    gets = [n for n in graph.nodes.values() if n.prim == "tuple_get"]
    assert [(n.inputs, n.params["index"]) for n in gets] == \
        [((rms[0].nid,), 0)]
    q, kv = torch.randn(1, 4, 8, 32), torch.randn(1, 2, 8, 32)
    graph = trace(lambda a, b, c: ops.attention(a, b, c), q, kv, kv)
    fl = [n for n in graph.nodes.values()
          if n.prim == "repro_torch.flash_attention.default"]
    assert len(fl) == 1 and fl[0].kind is OpKind.OPAQUE


def test_stitched_block_holds_two_norms_and_one_flash_node():
    cfg = get_config("llama3.2-3b")
    p = block_init(cfg, None, torch.float32, "meta")
    graph = trace(functools.partial(block_apply, cfg, fm=STITCHED), p,
                  torch.empty(4, 512, cfg.d_model, device="meta"),
                  torch.empty(512, dtype=torch.int64, device="meta"))
    prims = [n.prim for n in graph.nodes.values()
             if n.kind is OpKind.OPAQUE and n.prim != "tuple_get"]
    assert sorted(prims) == ["repro_torch.flash_attention.default",
                             "repro_torch.rmsnorm.default",
                             "repro_torch.rmsnorm.default"]


# ---------------------------------------------------------------------------
# the CUDA build
# ---------------------------------------------------------------------------
def test_build_without_nvcc_raises_naming_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os, "access", lambda *a, **k: False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "cuda")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()


def test_build_names_libraries_by_source_hash(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "cuda")
    a = _build._lib_path(src)
    src.write_text("// two\n")
    b = _build._lib_path(src)
    assert a != b and a.parent == b.parent == tmp_path / "cuda"
    assert a.name.startswith("k-") and a.suffix == ".so"
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == \
        {"rmsnorm", "flash_attention", "flash_decode", "layernorm",
         "softmax", "ssd_scan"}
