"""Plain PyTorch oracles: the port's counterparts of ``repro.kernels.ref``
for the normalizations, the softmax, attention and the Mamba-2 SSD scan.

They are the numerical ground truth of the tests and the
``fusion_mode="xla"`` path of the model code, which ``stitched_jit``
traces and compiles.  Attention is written with ``bmm`` on reshaped
operands in place of the reference's einsums: the traced graph then
plans as the reference's (ROADMAP C, "The causal mask").
"""
from __future__ import annotations

import math

import torch


def layernorm(x, gamma, beta, eps: float = 1e-6):
    xf = x.to(torch.float32)
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * gamma + beta).to(x.dtype)


def rmsnorm(x, gamma, eps: float = 1e-6):
    xf = x.to(torch.float32)
    ms = (xf ** 2).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * gamma).to(x.dtype)


def softmax(x, dim: int = -1):
    return torch.softmax(x.to(torch.float32), dim).to(x.dtype)


def attention(q, k, v, *, causal: bool = True, scale: float | None = None):
    """Multi-head attention with repeat-free GQA.

    q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] (Hq % Hkv == 0).  The query
    heads of one KV head are folded into the row dimension of a batched
    product, so K/V are never repeated.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.reshape(B * Hkv, g * Sq, D)
    kf = k.reshape(B * Hkv, Skv, D)
    vf = v.reshape(B * Hkv, Skv, D)
    logits = torch.bmm(qf, kf.transpose(1, 2)).reshape(B, Hkv, g, Sq, Skv) \
        * scale
    if causal:
        # built as ``jnp.tril(ones, k=Skv-Sq)`` builds it (a select over
        # the causal comparison) and broadcast to the full score shape as
        # ``jnp.where`` does: the masked softmax then has a row view and
        # plans as the reference's one-pass softmax tail
        row = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
        col = torch.arange(Skv, device=q.device)[None, :]
        mask = torch.where(row >= col, True, False)
        logits = torch.where(mask.expand(logits.shape), logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.bmm(probs.reshape(B * Hkv, g * Sq, Skv), vf)
    return out.reshape(B, Hq, Sq, D)


def decode_attention(q, k_cache, v_cache, lengths=None, scale=None):
    """Single-token decode: q [B, Hq, D]; caches [B, Hkv, S, D].

    ``lengths`` [B] masks cache rows at or past each sequence's length.
    q and a cache of another type (a bfloat16 model's q against the
    default float32 cache) compute in the wider of the two, as JAX
    promotes them, and the result is in q's type, as the decode kernel's
    (the reference keeps the promoted type; ROADMAP C).
    """
    out_dtype = q.dtype
    dt = torch.promote_types(q.dtype, k_cache.dtype)
    q, k_cache, v_cache = q.to(dt), k_cache.to(dt), v_cache.to(dt)
    B, Hq, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    g = Hq // Hkv
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.reshape(B * Hkv, g, D)
    kf = k_cache.reshape(B * Hkv, S, D)
    vf = v_cache.reshape(B * Hkv, S, D)
    logits = torch.bmm(qf, kf.transpose(1, 2)).reshape(B, Hkv, g, S) * sc
    if lengths is not None:
        mask = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
        logits = torch.where(mask[:, None, None, :].expand(logits.shape),
                             logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.bmm(probs.reshape(B * Hkv, g, S), vf)
    return out.reshape(B, Hq, D).to(out_dtype)


# --------------------------------------------------------------------------
# Mamba2 SSD (state-space duality) chunked scan
# --------------------------------------------------------------------------
def ssd_scan(x, dt, A, B, C, *, chunk: int = 64, init_state=None):
    """Chunked SSD scan (``src/repro/kernels/ref.py:93-150``).

    x [b, L, H, P]; dt [b, L, H] (softplus-activated, > 0); A [H]
    (negative); B, C [b, L, N] (one group, shared by the heads) ->
    (y [b, L, H, P] like x, final state [b, H, P, N] float32), float32
    inside.  All chunks at once, then a short loop over the chunks for
    the running state, as the reference computes it.  Every einsum has
    two operands (no ``[b, nc, c, c, H, P]`` intermediate), and the decay
    exponent is taken only where i >= j: the kept values are the
    reference's, and the masked pairs never overflow.
    """
    b, L, H, P = x.shape
    N = B.shape[-1]
    if L % chunk:
        raise ValueError(f"ssd_scan: L {L} is not a multiple of the chunk "
                         f"{chunk}; pad the sequence first")
    nc = L // chunk
    f32 = torch.float32
    xc = x.reshape(b, nc, chunk, H, P).to(f32)
    dtc = dt.reshape(b, nc, chunk, H).to(f32)
    Bc = B.reshape(b, nc, chunk, N).to(f32)
    Cc = C.reshape(b, nc, chunk, N).to(f32)

    cum = torch.cumsum(dtc * A.to(f32), dim=2)            # [b,nc,c,H]

    # intra-chunk (quadratic within the chunk)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [b,nc,c,c,H]
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()[:, :, None]
    lmat = torch.exp(torch.where(causal, seg, -math.inf))
    cb = torch.einsum("bzcn,bzsn->bzcs", Cc, Bc)           # [b,nc,c,c]
    w = cb[..., None] * lmat * dtc[:, :, None, :, :]       # [b,nc,c,s,H]
    y_intra = torch.einsum("bzcsh,bzshp->bzchp", w, xc)

    # each chunk's contribution to the running state
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)      # [b,nc,c,H]
    xw = xc * (decay_states * dtc)[..., None]              # [b,nc,c,H,P]
    states = torch.einsum("bzsn,bzshp->bzhpn", Bc, xw)     # [b,nc,H,P,N]

    # the recurrence over the chunks
    chunk_decay = torch.exp(cum[:, :, -1, :])              # [b,nc,H]
    h = (torch.zeros(b, H, P, N, dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    h_prevs = []
    for z in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, z, :, None, None] + states[:, z]
    h_prev = torch.stack(h_prevs, dim=1)                   # [b,nc,H,P,N]

    y_inter = torch.einsum("bzcn,bzhpn->bzchp", Cc, h_prev) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, L, H, P).to(x.dtype)
    return y, h
