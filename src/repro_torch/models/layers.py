"""Model layers in PyTorch (the dense, encoder, MoE, SSM and hybrid
families, with the serving KV and SSM caches).

The counterparts of ``repro.models.layers``.  Each memory-intensive
pattern routes through ``repro_torch.kernels.ops``, so the execution mode
is chosen per model:

  fusion_mode="stitched" -> the hand-written CUDA kernels (LayerNorm,
                            RMSNorm, flash attention, the router's
                            softmax, the SSD scan), one opaque node each
                            in a traced graph, differentiable
  fusion_mode="xla"      -> the plain oracles of ``kernels/ref.py``, which
                            ``stitched_jit`` traces, plans and compiles
                            into generated kernels

Matmuls stay ``x @ w``.  Layouts follow the JAX package (``x @ w``
weights, attention tensors [B, H, S, D]) so the tests compare like with
like.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels import ops


@dataclass(frozen=True)
class FusionMode:
    name: str = "stitched"   # "stitched" | "xla"

    def __post_init__(self):
        if self.name not in ("stitched", "xla"):
            raise ValueError(f"fusion mode {self.name!r}: 'stitched' or 'xla'")

    @property
    def use_kernels(self) -> bool:
        return self.name == "stitched"


STITCHED = FusionMode("stitched")
XLA = FusionMode("xla")


def dense(gen: torch.Generator, d_in: int, d_out: int, dtype,
          device) -> torch.Tensor:
    w = torch.randn(d_in, d_out, generator=gen, device=device,
                    dtype=torch.float32) / math.sqrt(d_in)
    return w.to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def norm_init(cfg: ArchConfig, dtype, device) -> dict:
    p = {"g": torch.ones(cfg.d_model, dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["b"] = torch.zeros(cfg.d_model, dtype=dtype, device=device)
    return p


def norm_apply(cfg: ArchConfig, p: dict, x, fm: FusionMode):
    if cfg.norm == "layernorm":
        return ops.layernorm(x, p["g"], p["b"], cfg.norm_eps,
                             use_kernels=fm.use_kernels)
    return ops.rmsnorm(x, p["g"], cfg.norm_eps, use_kernels=fm.use_kernels)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------
def rope(q, k, positions, theta: float):
    """q, k: [B, H, S, D]; positions: [S], shared by the batch, or [B, S],
    one row of positions a sequence (a continuous batch's slots)."""
    D = q.shape[-1]
    half = D // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=q.device)
                      * (math.log(theta) / half))
    angles = positions.to(torch.float32)[..., None] * freqs   # [(B,) S, half]
    if angles.dim() == 3:                                     # [B,1,S,half]
        angles = angles[:, None]
    while angles.dim() < q.dim():                             # [1,1,S,half]
        angles = angles[None]
    cos, sin = torch.cos(angles), torch.sin(angles)

    def rot(x):
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin,
                          x2 * cos + x1 * sin], dim=-1).to(x.dtype)

    return rot(q), rot(k)


# ---------------------------------------------------------------------------
# attention (GQA, optional KV cache)
# ---------------------------------------------------------------------------
def attn_init(cfg: ArchConfig, gen, dtype, device,
              d_in: int | None = None) -> dict:
    """``d_in`` is the input width (Zamba2's shared block takes
    ``2 d_model``); the output is ``d_model`` wide."""
    d, Dh = d_in or cfg.d_model, cfg.resolved_head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    return {"wq": dense(gen, d, Hq * Dh, dtype, device),
            "wk": dense(gen, d, Hkv * Dh, dtype, device),
            "wv": dense(gen, d, Hkv * Dh, dtype, device),
            "wo": dense(gen, Hq * Dh, cfg.d_model, dtype, device)}


def attn_qkv(cfg: ArchConfig, p: dict, x, positions):
    """x [B, S, d] -> q [B, Hq, S, Dh], k and v [B, Hkv, S, Dh], RoPE at
    ``positions`` ([S], or [B, S] a row each) applied to q and k."""
    B, S, _ = x.shape
    Dh, Hq, Hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = (x @ p["wq"]).reshape(B, S, Hq, Dh).transpose(1, 2)
    k = (x @ p["wk"]).reshape(B, S, Hkv, Dh).transpose(1, 2)
    v = (x @ p["wv"]).reshape(B, S, Hkv, Dh).transpose(1, 2)
    q, k = rope(q, k, positions, cfg.rope_theta)
    return q, k, v


def cache_write(cache: dict, k, v, positions) -> None:
    """Write k, v [B, Hkv, S, Dh] into the cache rows ``positions`` in
    place: [S], the same rows of every sequence, or [B, S], each
    sequence's own (a continuous batch's slots, each at its position).
    ``positions`` is a tensor on the cache's device, so the write needs no
    host sync.  Never traced: the port's tracer has no mutation, so the
    cache is written between two stitched functions (the reference
    returns a new cache from ``dynamic_update_slice``)."""
    if positions.dim() == 2:
        idx = positions[:, None, :, None].expand(k.shape)
        cache["k"].scatter_(2, idx, k.to(cache["k"].dtype))
        cache["v"].scatter_(2, idx, v.to(cache["v"].dtype))
        return
    cache["k"].index_copy_(2, positions, k.to(cache["k"].dtype))
    cache["v"].index_copy_(2, positions, v.to(cache["v"].dtype))


def attn_core(cfg: ArchConfig, p: dict, q, k, v, *, fm: FusionMode,
              kv_len=None, decode: bool = False):
    """Attention and the output projection -> [B, S, d].

    Without ``kv_len`` and ``decode``: causal attention of q over this
    call's k, v (prefill, or no cache).  Otherwise one decode token, q
    [B, Hq, 1, Dh] over the cache k, v [B, Hkv, max_len, Dh]: a device
    -valued ``kv_len`` (a 0-d tensor) masks the cache to its first
    ``kv_len`` rows; with ``decode`` a static one -- an int, the first
    ``kv_len`` rows, or None, the whole cache -- streams them
    (``flash_decode`` with kernels), as the reference's ``attn_apply``
    does with ``eff = kv_len if kv_len is not None else kc.shape[2]``.
    """
    B, Hq, S, Dh = q.shape
    if kv_len is None and not decode:
        o = ops.attention(q, k, v, causal=cfg.causal,
                          use_kernels=fm.use_kernels)
    else:
        # q[:, :, 0] as a reshape (S == 1): no opaque select in the graph
        o = ops.decode_attention(q.reshape(B, Hq, Dh), k, v, kv_len=kv_len,
                                 use_kernels=fm.use_kernels)[:, :, None]
    o = o.transpose(1, 2).reshape(B, S, Hq * Dh)
    return o @ p["wo"]


def attn_apply(cfg: ArchConfig, p: dict, x, *, fm: FusionMode, positions):
    """x [B, S, d] -> [B, S, d], causal over this call's tokens, no cache
    (``src/repro/models/layers.py:102-140`` without one).  With a cache,
    ``models/model.py`` stitches ``attn_qkv`` and ``attn_core`` on either
    side of ``cache_write``."""
    q, k, v = attn_qkv(cfg, p, x, positions)
    return attn_core(cfg, p, q, k, v, fm=fm)


def attn_cache_init(cfg: ArchConfig, batch: int, max_len: int, dtype,
                    device) -> dict:
    Dh, Hkv = cfg.resolved_head_dim, cfg.n_kv_heads
    return {"k": torch.zeros(batch, Hkv, max_len, Dh, dtype=dtype,
                             device=device),
            "v": torch.zeros(batch, Hkv, max_len, Dh, dtype=dtype,
                             device=device)}


# ---------------------------------------------------------------------------
# MLP (SwiGLU, GeGLU, plain GELU)
# ---------------------------------------------------------------------------
def mlp_init(cfg: ArchConfig, gen, dtype, device) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.activation == "gelu_mlp":
        return {"w_up": dense(gen, d, ff, dtype, device),
                "w_down": dense(gen, ff, d, dtype, device)}
    return {"w_gate": dense(gen, d, ff, dtype, device),
            "w_up": dense(gen, d, ff, dtype, device),
            "w_down": dense(gen, ff, d, dtype, device)}


def gelu_tanh(x):
    """``jax.nn.gelu(x, approximate=True)`` written out as JAX writes it,
    so that it traces to element-wise primitives, as in the reference."""
    cdf = 0.5 * (1.0 + torch.tanh(math.sqrt(2 / math.pi)
                                  * (x + 0.044715 * x ** 3)))
    return x * cdf


def _gate_act(cfg: ArchConfig, x):
    """The gated branch's activation: SiLU (SwiGLU) or the tanh GELU
    (GeGLU, ``activation="gelu"``; ``src/repro/models/layers.py:162-166``)."""
    if cfg.activation == "silu":
        return F.silu(x)
    if cfg.activation == "gelu":
        return gelu_tanh(x)
    raise ValueError(f"activation {cfg.activation!r}: 'silu' or 'gelu' "
                     "gate a branch; 'gelu_mlp' has none")


def mlp_apply(cfg: ArchConfig, p: dict, x):
    if cfg.activation == "gelu_mlp":
        # jax.nn.gelu(approximate=True) is the tanh form
        return F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]
    return (_gate_act(cfg, x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


# ---------------------------------------------------------------------------
# MoE (top-k routing; GShard dense dispatch or sort/scatter dispatch)
# ---------------------------------------------------------------------------
def moe_init(cfg: ArchConfig, gen, dtype, device) -> dict:
    """The router [d, E] and the experts' stacked SwiGLU weights
    [E, d, ff], [E, d, ff], [E, ff, d]."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * scale).to(dtype)

    return {"router": dense(gen, d, E, dtype, device),
            "w_gate": normal((E, d, ff), 1.0 / math.sqrt(d)),
            "w_up": normal((E, d, ff), 1.0 / math.sqrt(d)),
            "w_down": normal((E, ff, d), 1.0 / math.sqrt(ff))}


def route(probs, k: int):
    """The top-k experts of each token, in descending order of
    probability as ``jax.lax.top_k`` returns them, and their gates
    renormalized over the k: -> (gate_vals [T, k] float32, gate_idx [T, k]
    int64)."""
    vals, idx = torch.topk(probs, k)
    return vals / vals.sum(-1, keepdim=True), idx


def _capacity(cfg: ArchConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens (at least 4), as the
    reference sizes them (``np.ceil`` of the same float product)."""
    return max(math.ceil(cfg.top_k * tokens / cfg.n_experts
                         * cfg.capacity_factor), 4)


def moe_apply(cfg: ArchConfig, p: dict, x, fm: FusionMode,
              impl: str | None = None):
    """x [B, S, d] -> (y [B, S, d], aux): the MoE layer of
    ``src/repro/models/layers.py:190-255``.

    The router's softmax goes through ``ops.softmax`` (the CUDA kernel in
    the stitched mode).  ``impl="sort"`` scatters each sequence's
    (token, choice) pairs into per-expert slots (``_moe_sort_dispatch``);
    ``impl="einsum"`` is GShard's dense one-hot dispatch over all T
    tokens.  Pairs past an expert's capacity are dropped.  ``aux`` is the
    GShard load-balance loss: E times the sum over experts of the mean
    router probability and the share of tokens whose first choice it is.
    """
    impl = impl or cfg.moe_impl or "einsum"
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, d)

    logits = (xt @ p["router"]).to(torch.float32)            # [T, E]
    probs = ops.softmax(logits, use_kernels=fm.use_kernels)
    gate_vals, gate_idx = route(probs, k)                    # [T, k]
    experts = torch.arange(E, device=x.device)
    me = probs.mean(0)
    ce = (gate_idx[:, :1] == experts).to(torch.float32).mean(0)
    aux = E * (me * ce).sum()

    if impl == "sort":
        y = _moe_sort_dispatch(cfg, p, x, gate_vals.reshape(B, S, k),
                               gate_idx.reshape(B, S, k))
        return y.reshape(B, S, d), aux
    if impl != "einsum":
        raise ValueError(f"moe impl {impl!r}: 'sort' or 'einsum'")

    capacity = _capacity(cfg, T)
    slots = torch.arange(capacity, device=x.device)
    dispatch = xt.new_zeros(T, E, capacity)
    combine = torch.zeros(T, E, capacity, dtype=torch.float32,
                          device=x.device)
    counts = torch.zeros(E, dtype=torch.int64, device=x.device)
    for j in range(k):
        onehot = (gate_idx[:, j:j + 1] == experts).to(torch.int64)  # [T, E]
        pos = torch.cumsum(onehot, 0) - onehot + counts[None, :]
        slot = (pos * onehot).sum(-1)                               # [T]
        keep = slot < capacity
        counts = counts + onehot.sum(0)
        oh_slot = ((slot[:, None] == slots) & keep[:, None]).to(xt.dtype)
        dispatch = dispatch + onehot.to(xt.dtype)[:, :, None] \
            * oh_slot[:, None, :]
        combine = combine + (onehot.to(torch.float32)
                             * gate_vals[:, j:j + 1])[:, :, None] \
            * oh_slot.to(torch.float32)[:, None, :]

    xe = torch.einsum("tec,td->ecd", dispatch, xt)           # [E, C, d]
    h = _gate_act(cfg, torch.bmm(xe, p["w_gate"])) \
        * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"])
    y = torch.einsum("tec,ecd->td", combine.to(ye.dtype), ye)
    return y.reshape(B, S, d), aux


def _moe_sort_dispatch(cfg: ArchConfig, p: dict, x, gate_vals, gate_idx):
    """Grouped sort/scatter dispatch (``src/repro/models/layers.py:258-317``).

    x [G, Tg, d] (one group per sequence); gate_vals, gate_idx [G, Tg, k].
    Each group's (token, choice) pairs get slots within their expert from
    a stable sort by expert, so the earlier token keeps the earlier slot;
    pairs past ``capacity`` are dropped.  The reference's ``vmap`` over
    groups is the leading batch dimension of every index op here.  The
    kept rows are scattered into one buffer, expert-major ([E, G, C] rows,
    so each expert's GEMM reads one contiguous [G C, d] panel, where the
    reference keeps [G, E, C]); dropped pairs land on one spare row past
    the end.  Every scatter is out of place (the tracer has no mutation).
    The experts' outputs are gathered back in (token, choice) order and
    summed over the choices, weighted by their gates.
    """
    G, Tg, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    capacity = _capacity(cfg, Tg)
    Tk = Tg * k
    dev = x.device
    flat_e = gate_idx.reshape(G, Tk)                        # [G, Tk]
    flat_g = gate_vals.reshape(G, Tk).to(torch.float32)

    # slot within the expert: position in the stable sort minus the start
    # of the expert's segment, scattered back to (token, choice) order
    se, order = torch.sort(flat_e, dim=-1, stable=True)
    starts = torch.searchsorted(
        se, torch.arange(E, device=dev).repeat(G, 1))
    slot_sorted = torch.arange(Tk, device=dev) - torch.gather(starts, 1, se)
    slot = torch.zeros_like(order).scatter(1, order, slot_sorted)
    keep = slot < capacity

    rows = E * G * capacity
    group = torch.arange(G, device=dev)[:, None]
    dest = torch.where(keep, (flat_e * G + group) * capacity + slot, rows)
    x_rep = x[:, :, None, :].expand(G, Tg, k, d).reshape(G * Tk, d)
    buf = x.new_zeros(rows + 1, d).index_put((dest.reshape(-1),), x_rep)
    xe = buf[:rows].reshape(E, G * capacity, d)

    h = _gate_act(cfg, torch.bmm(xe, p["w_gate"])) \
        * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"]).reshape(rows, d)

    # dropped pairs gather row 0 with gate 0.  ``index_select``'s backward
    # adds each row's gradient atomically: only row 0 repeats, and its
    # extra terms are zeros, so the sum is deterministic (``ye[src]``'s
    # sort-based backward walks the run of equal indices serially)
    src = torch.where(keep, dest, 0).reshape(-1)
    gate = torch.where(keep, flat_g, 0.0).to(ye.dtype)
    out_tok = ye.index_select(0, src).reshape(G, Tk, d) * gate[..., None]
    return out_tok.reshape(G, Tg, k, d).sum(2)


# ---------------------------------------------------------------------------
# Mamba2 block (SSD)
# ---------------------------------------------------------------------------
def mamba_init(cfg: ArchConfig, gen, dtype, device) -> dict:
    """``src/repro/models/layers.py:323-338``: A = -exp(A_log) = -1, D 1,
    dt_bias -2 (softplus about 0.12)."""
    d, di, N = cfg.d_model, cfg.resolved_d_inner, cfg.ssm_state
    H, W = cfg.ssm_heads, cfg.conv_width
    conv_dim = di + 2 * N
    f32 = torch.float32
    conv_w = torch.randn(W, conv_dim, generator=gen, device=device,
                         dtype=f32) * 0.2
    return {"in_proj": dense(gen, d, 2 * di + 2 * N + H, dtype, device),
            "conv_w": conv_w.to(dtype),
            "conv_b": torch.zeros(conv_dim, dtype=dtype, device=device),
            "A_log": torch.zeros(H, dtype=f32, device=device),
            "D": torch.ones(H, dtype=f32, device=device),
            "dt_bias": torch.full((H,), -2.0, dtype=f32, device=device),
            "norm_g": torch.ones(di, dtype=dtype, device=device),
            "out_proj": dense(gen, di, d, dtype, device)}


def causal_depthwise_conv(x, w, b):
    """x [B, S, C]; w [W, C]: the depthwise causal convolution of
    ``src/repro/models/layers.py:341-350`` (cross-correlation over the
    W - 1 zero rows before the sequence, as ``conv_general_dilated``)."""
    W, C = w.shape
    xp = F.pad(x, (0, 0, W - 1, 0)).transpose(1, 2)        # [B, C, S+W-1]
    out = F.conv1d(xp, w.t().unsqueeze(1), groups=C)       # [B, C, S]
    return out.transpose(1, 2) + b


def mamba_apply(cfg: ArchConfig, p: dict, x, *, fm: FusionMode, cache=None):
    """x [B, S, d] -> (y [B, S, d], new_cache): the Mamba2 block of
    ``src/repro/models/layers.py:353-420``.

    ``cache = {"conv": [B, W-1, conv_dim], "ssm": [B, H, P, N]}``.  With
    S > 1 (and with no cache) the chunked SSD scan over the sequence,
    padded to a chunk multiple with dt = 0 after the softplus, so the pad
    neither decays nor feeds the state; with a cache it returns the new
    one (the last W-1 pre-conv rows, the final state) and ignores the
    given one's values.  With a cache and S == 1: one recurrence step from
    the cache.  The gated RMSNorm epilogue ends both.
    """
    B, S, _ = x.shape
    di, N = cfg.resolved_d_inner, cfg.ssm_state
    H, P, W = cfg.ssm_heads, cfg.ssm_head_dim, cfg.conv_width
    conv_dim = di + 2 * N
    f32 = torch.float32

    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + conv_dim]
    dt_raw = zxbcdt[..., di + conv_dim:].to(f32)             # [B, S, H]
    A = -torch.exp(p["A_log"])

    if cache is not None and S == 1:
        conv_state = torch.cat([cache["conv"], xBC], dim=1)  # [B, W, cd]
        xBC_c = F.silu((conv_state * p["conv_w"]).sum(1) + p["conv_b"])
        xs = xBC_c[:, :di].reshape(B, H, P).to(f32)
        Bv = xBC_c[:, di:di + N].to(f32)
        Cv = xBC_c[:, di + N:].to(f32)
        dt = F.softplus(dt_raw[:, 0] + p["dt_bias"])          # [B, H]
        decay = torch.exp(dt * A)
        upd = dt[:, :, None, None] * Bv[:, None, None, :] * xs[..., None]
        h = cache["ssm"] * decay[:, :, None, None] + upd     # [B, H, P, N]
        y = (Cv[:, None, None, :] * h).sum(-1)               # [B, H, P]
        y = (y + p["D"][None, :, None] * xs).reshape(B, 1, di)
        new_cache = {"conv": conv_state[:, 1:], "ssm": h}
    else:
        xBC_c = F.silu(causal_depthwise_conv(xBC, p["conv_w"], p["conv_b"]))
        xs = xBC_c[..., :di]
        Bv = xBC_c[..., di:di + N]
        Cv = xBC_c[..., di + N:]
        dt = F.softplus(dt_raw + p["dt_bias"])                # [B, S, H]

        chunk = min(cfg.ssm_chunk, S)
        pad = (-S) % chunk
        if pad:
            xs, dt, Bv, Cv = (F.pad(t, (0, 0, 0, pad))
                              for t in (xs, dt, Bv, Cv))
        y, state = ops.ssd_scan(xs.reshape(B, S + pad, H, P), dt, A, Bv, Cv,
                                chunk=chunk, use_kernels=fm.use_kernels)
        y = y[:, :S].to(f32) + p["D"][None, None, :, None] \
            * xs[:, :S].reshape(B, S, H, P).to(f32)
        y = y.reshape(B, S, di)
        new_cache = None
        if cache is not None:  # the pre-conv rows feed the decode cache
            conv = (xBC[:, S - (W - 1):] if S >= W - 1
                    else F.pad(xBC, (0, 0, W - 1 - S, 0)))
            new_cache = {"conv": conv, "ssm": state}

    # gated RMSNorm epilogue
    y = y * F.silu(z.to(f32))
    y = ops.rmsnorm(y.to(x.dtype), p["norm_g"], cfg.norm_eps,
                    use_kernels=fm.use_kernels)
    return y @ p["out_proj"], new_cache


def mamba_cache_init(cfg: ArchConfig, batch: int, dtype, device) -> dict:
    di, N = cfg.resolved_d_inner, cfg.ssm_state
    H, P, W = cfg.ssm_heads, cfg.ssm_head_dim, cfg.conv_width
    return {"conv": torch.zeros(batch, W - 1, di + 2 * N, dtype=dtype,
                                device=device),
            "ssm": torch.zeros(batch, H, P, N, dtype=torch.float32,
                               device=device)}
