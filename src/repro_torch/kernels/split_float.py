"""The three-way TF32 split that B3 and B4 run on the tensor cores, in
plain PyTorch.

A float32 value x is written as ``big = tf32(x)`` plus ``small =
tf32(x - big)``, each rounded as ``cvt.rna.tf32.f32`` rounds (to nearest,
ties away from zero, 10 mantissa bits kept), so ``big + small`` is x to
about 2^-22 of |x|.  A product then takes three TF32 products into one
float32 sum,

    a b ~ big_a big_b + big_a small_b + small_a big_b,

and drops ``small_a small_b``, below 2^-22 of |a b|.  A product of two
TF32 values is exact in float32 (11 by 11 significant bits), so the
split's only roundings are the float32 sum's and the two dropped terms.
``csrc/matmul_fused.cuh`` (B3, ``wgmma``), ``csrc/flash_attention.cuh``
(B4, ``mma.sync``) and ``csrc/ssd_scan.cu`` (B11, ``mma.sync``) compute
exactly this; the functions here are its plain version, for the CPU
tests (``tests/test_torch_split_float.py``) and for the measurement on
the card:

    PYTHONPATH=src python -m repro_torch.kernels.split_float

which, at the shapes the main path gives the three kernels, holds the
split product (three TF32 products on the card's tensor cores, summed in
float32) and the plain float32 product against float64, and prints the
worst ratio of each to the limit ``chip_smoke.py`` holds the kernels to.
``ssd_chunked`` is B11's chunk-parallel decomposition of the SSD scan,
with its four products taken by a given product function.

Where both operands are bfloat16 the kernels take Hopper's native
products instead (``csrc/matmul_bf16.cuh``, ``csrc/mma_bf16.cuh``): a
product of two bfloat16 values (8 significant bits each) is exact in
float32, so one bfloat16 product forms what the split formed, summed in
float32 (``bf16_matmul``).  Attention's p is float32: it is written as
``hi = bf16(p)`` plus ``lo = bf16(p - hi)``, about 16 significant bits,
and p v is two bfloat16 products into one float32 sum (``bf16_pv``).
B8's native bfloat16 kernel takes the same products, its online softmax
kept a warp of 16 keys at a time (``bf16_decode``).

    PYTHONPATH=src python -m repro_torch.kernels.split_float --bf16

measures, on the card, B3's native instance (one float32 sum over all
of K) at K 3072 and 8192 against the bfloat16 rule ``chip_smoke.py``
holds it to, beside the plain form with a partial sum each k-tile
(``bf16_matmul(chunk=64)``) on the same inputs.
"""
from __future__ import annotations

import json
import math

import torch

#: ``chip_smoke.py``'s limits (a test holds the two files equal): B3 within
#: B3_RTOL max(1, max|plain|) + B3_SUM_FACTOR (the plain version's own
#: distance from float64); B4 within RTOL |plain| + RTOL mean|plain|.
B3_RTOL, B3_SUM_FACTOR = 1e-5, 3.0
RTOL = 1e-5
#: B11 within SSD_RTOL max(1, max|plain|), each output
SSD_RTOL = 1e-4
#: K chunks measured for B3: one k-tile of each instance
B3_CHUNKS = (16, 32, 64)
#: head-dim chunks measured for B4's q k^T (a partial sum a chunk)
B4_D_CHUNKS = (8, 16, 32)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on float32 bits: add half of the last kept
    mantissa bit to the magnitude, clear the 13 dropped bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(big, small) of a float32 tensor: both TF32 values."""
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def split_matmul(a: torch.Tensor, b: torch.Tensor,
                 chunk: int | None = None) -> torch.Tensor:
    """``a @ b`` (float32, [..., M, K] by [..., K, N]) as the kernels take
    it: the three TF32 products, exact, summed in float32.  ``chunk``
    None: one float32 sum over the concatenated K of the three terms (on
    the card, one tensor-core accumulator over all of K); else K in
    chunks of ``chunk``, each chunk's three products summed from zero
    (one tensor-core accumulator a chunk), the chunks' partial sums then
    added in order in float32, rounded to nearest."""
    ab, as_ = split(a.float())
    bb, bs = split(b.float())
    K = a.shape[-1]
    step = K if chunk is None else chunk
    out = None
    for k0 in range(0, K, step):
        sl = slice(k0, min(K, k0 + step))
        part = torch.matmul(
            torch.cat([as_[..., sl], ab[..., sl], ab[..., sl]], -1),
            torch.cat([bb[..., sl, :], bs[..., sl, :], bb[..., sl, :]], -2))
        out = part if out is None else out + part
    return out


def bf16_pair(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of a float32 tensor, both bfloat16: hi = x rounded to the
    nearest bfloat16 (ties to even, ``cvt.rn.bf16x2.f32``), lo = x - hi
    rounded the same way.  hi + lo is x to about 2^-16 of |x|."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def bf16_matmul(a: torch.Tensor, b: torch.Tensor,
                chunk: int | None = None) -> torch.Tensor:
    """``a @ b`` of bfloat16 operands as the native instances take it:
    each product exact in float32, summed in float32 (float32 results).
    ``chunk`` None: one sum over all of K (the tensor cores' accumulator
    over the whole loop); else partial sums of ``chunk`` of K, each from
    zero, added in order (the partial sums the TF32 instances take)."""
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"bf16_matmul takes bfloat16 operands, got "
                        f"{a.dtype}, {b.dtype}")
    a32, b32 = a.float(), b.float()
    K = a.shape[-1]
    step = K if chunk is None else chunk
    out = None
    for k0 in range(0, K, step):
        part = torch.matmul(a32[..., k0:k0 + step], b32[..., k0:k0 + step, :])
        out = part if out is None else out + part
    return out


def bf16_pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``p @ v`` as B4's bfloat16 instances take it: the float32 p split
    into bfloat16 hi and lo (``bf16_pair``), v bfloat16, two products each
    exact in float32, one float32 sum."""
    hi, lo = bf16_pair(p)
    v32 = v.to(torch.bfloat16).float()
    return torch.matmul(torch.cat([lo, hi], -1).float(),
                        torch.cat([v32, v32], -2))


def bf16_decode(q, k, v, kv_len: int | None = None,
                scale: float | None = None, *, rows: int, tile: int = 64,
                warps: int = 4) -> torch.Tensor:
    """o [B, Hq, D] (float32) of bfloat16 q [B, Hq, D] against bfloat16
    caches [B, Hkv, S, D] as B8's native bfloat16 kernel takes it
    (``flash_decode_bf16_kernel``): the live rows cut into splits of
    ``rows``, each split's rows into tiles of ``tile`` keys, ``tile /
    warps`` keys of each tile a warp; q . k one bfloat16 product, exact in
    float32, summed in float32; each warp's online softmax over its keys
    in units of log2 e (rows past ``kv_len`` probability 0); p float32,
    split into bfloat16 hi and lo (``bf16_pair``), p v two products into
    one float32 sum; the warps' states merged, then the splits' (m in
    natural units), and the division by max(l, 1e-30)."""
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    g, kw = Hq // Hkv, tile // warps
    eff = S if kv_len is None else min(int(kv_len), S)
    sc = 1.0 / math.sqrt(D) if scale is None else scale
    splits = -(-eff // rows)
    nt = rows // tile
    n = splits * rows
    kf = torch.zeros(B, Hkv, n, D)
    vf = torch.zeros(B, Hkv, n, D)
    kf[:, :, :eff] = k[:, :, :eff].float()
    vf[:, :, :eff] = v[:, :, :eff].float()
    live = torch.arange(n) < eff
    s = torch.matmul(q.float().reshape(B, Hkv, g, D), kf.transpose(-1, -2))
    s2 = (s * (sc / math.log(2.0))).masked_fill(~live, -1e30)
    # [B, Hkv, g, splits, tiles, warps, kw] and V's keys alike
    s2 = s2.reshape(B, Hkv, g, splits, nt, warps, kw)
    ok = live.reshape(splits, nt, warps, kw)
    vt = vf.reshape(B, Hkv, 1, splits, nt, warps, kw, D)
    m = torch.full((B, Hkv, g, splits, warps), -1e30)
    l = torch.zeros(B, Hkv, g, splits, warps)
    acc = torch.zeros(B, Hkv, g, splits, warps, D)
    for t in range(nt):
        st = s2[:, :, :, :, t]
        mn = torch.maximum(m, st.amax(-1))
        al = torch.exp2(m - mn)
        p = torch.where(ok[:, t], torch.exp2(st - mn[..., None]), 0.0)
        l = l * al + p.sum(-1)
        hi, lo = bf16_pair(p)
        vv = vt[:, :, :, :, t]
        acc = (acc * al[..., None]
               + torch.matmul(hi.float()[..., None, :], vv)[..., 0, :]
               + torch.matmul(lo.float()[..., None, :], vv)[..., 0, :])
        m = mn
    mm = m.amax(-1, keepdim=True)
    w = torch.exp2(m - mm)
    ls, accs = (l * w).sum(-1), (acc * w[..., None]).sum(-2)
    mn = mm[..., 0] * math.log(2.0)
    mx = mn.amax(-1, keepdim=True)
    w = torch.exp(mn - mx)
    lt, at = (ls * w).sum(-1), (accs * w[..., None]).sum(-2)
    return (at / lt.clamp_min(1e-30)[..., None]).reshape(B, Hq, D)


def attention(q, k, v, *, causal: bool, scale: float | None = None,
              bias=None, product=torch.matmul, pv=None) -> torch.Tensor:
    """Attention over [B, H, S, D] (k, v with Hkv heads), q k^T taken by
    ``product`` and p v by ``pv`` (default ``product``): ``torch.matmul``
    for the plain float32 version, ``split_matmul`` for the split one."""
    pv = product if pv is None else pv
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    sc = 1.0 / math.sqrt(D) if scale is None else scale
    qf = q.reshape(B, Hkv, g * Sq, D)
    s = product(qf, k.transpose(-1, -2)).reshape(B, Hkv, g, Sq, Skv) * sc
    if bias is not None:
        s = s + bias.reshape(1, 1, 1, Sq, Skv)
    if causal:
        row = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
        col = torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(row >= col, s, -1e30)
    p = torch.softmax(s, -1).reshape(B, Hkv, g * Sq, Skv)
    return pv(p, v).reshape(B, Hq, Sq, D)


def ssd_chunked(x, dt, A, B, C, chunk: int, product=torch.matmul):
    """The SSD scan (``ssd_scan.ssd_scan_plain``'s function) as B11
    computes it, chunk-parallel, its four products taken by ``product``.

    Every (batch, chunk, head) at once: the cumulative decay ``cum``, the
    chunk's own state contribution S = (x * exp(cum_last - cum) * dt)^T B
    [P, N], and C B^T [c, c] once per (batch, chunk).  Then the state
    passed along the chunks in order, h = h exp(cum_last) + S, and, with
    h the state entering each chunk, y = exp(cum) * (C h^T) + W x, W = C
    B^T * exp(cum_i - cum_j) * dt_j (i >= j); the final state is h after
    the last chunk."""
    b, L, H, P = x.shape
    N = B.shape[-1]
    nc = L // chunk
    f32 = torch.promote_types(x.dtype, torch.float32)  # float64 stays
    xz = x.to(f32).reshape(b, nc, chunk, H, P).permute(0, 1, 3, 2, 4)
    dtz = dt.to(f32).reshape(b, nc, chunk, H).permute(0, 1, 3, 2)
    Bz = B.to(f32).reshape(b, nc, chunk, N)
    Cz = C.to(f32).reshape(b, nc, chunk, N)
    cum = torch.cumsum(dtz * A.to(f32)[:, None], -1)        # [b, nc, H, c]
    cb = product(Cz, Bz.transpose(-1, -2))                  # [b, nc, c, c]
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()
    seg = cum[..., :, None] - cum[..., None, :]
    w = cb[:, :, None] * torch.exp(torch.where(causal, seg, -math.inf)) \
        * dtz[..., None, :]
    y = product(w, xz)                                      # [b, nc, H, c, P]
    sc = torch.exp(cum[..., -1:] - cum) * dtz
    S = product((xz * sc[..., None]).transpose(-1, -2),
                Bz[:, :, None])                             # [b, nc, H, P, N]
    h = torch.zeros(b, H, P, N, dtype=f32, device=x.device)
    for z in range(nc):
        inter = product(Cz[:, z, None], h.transpose(-1, -2))   # [b, H, c, P]
        y[:, z] = y[:, z] + torch.exp(cum[:, z])[..., None] * inter
        h = h * torch.exp(cum[:, z, :, -1])[..., None, None] + S[:, z]
    return y.permute(0, 1, 3, 2, 4).reshape(b, L, H, P).to(x.dtype), h


def ssd_ratio(got, plain) -> float:
    """The worst ratio of |got - plain| to B11's limit, SSD_RTOL max(1,
    max|plain|), over y and the state."""
    return max(float((g.double() - w.double()).abs().max())
               / (SSD_RTOL * max(1.0, float(w.abs().max())))
               for g, w in zip(got, plain))


def b3_ratio(got, plain, f64) -> float:
    """The worst ratio of |got - plain| to B3's limit."""
    sum_err = float((plain.double() - f64).abs().max())
    scale = max(1.0, float(plain.abs().max()))
    limit = B3_RTOL * scale + B3_SUM_FACTOR * sum_err
    return float((got - plain).abs().max()) / limit


def b4_ratio(got, want) -> float:
    """The worst ratio of |got - want| to B4's limit, RTOL |want| + RTOL
    mean|want| elementwise."""
    w = want.float()
    limit = (RTOL * w.abs() + RTOL * float(w.abs().mean())) \
        .clamp_min(torch.finfo(torch.float32).tiny)
    return float(((got.float() - w).abs() / limit).max())


def _measure() -> list[dict]:
    """Step 0 of the tensor-core design, on the card: the split against
    the plain float32 product and float64 at the main path's shapes."""
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = True   # the split's terms are
    torch.backends.cudnn.allow_tf32 = False        # TF32 values already
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    def plain_mm(a, b):
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return torch.matmul(a, b)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = True

    rows = []

    def b3_row(label, lhs, rhs, epi):
        f64 = epi(lhs.double() @ rhs.double())
        plain = epi(plain_mm(lhs, rhs))
        row = {"kernel": "B3", "shape": label,
               "plain_vs_f64": float((plain.double() - f64).abs().max()),
               "max_abs_plain": float(plain.abs().max())}
        for chunk in (None,) + B3_CHUNKS:
            got = epi(split_matmul(lhs, rhs, chunk))
            tag = "one_sum" if chunk is None else f"chunk{chunk}"
            row[f"{tag}_err_over_limit"] = b3_ratio(got, plain, f64)
            row[f"{tag}_vs_f64"] = float((got.double() - f64).abs().max())
            del got
        rows.append(row)
        print(json.dumps(row), flush=True)

    M, K, N = 2048, 3072, 8192
    x, wg = randn(M, K), randn(K, N, scale=K ** -0.5)
    up = plain_mm(x, randn(K, N, scale=K ** -0.5))
    b3_row("llama gate + SiLU x up M2048 K3072 N8192", x, wg,
           lambda h: F.silu(h) * up.to(h.dtype))
    b3_row("decode M4 K3072 N8192", x[:4], wg,
           lambda h: F.silu(h) * up[:4].to(h.dtype))
    del wg, up
    g, w1 = randn(K), randn(K, N)
    lhs = x * g + 1.0
    gelu = (lambda h: h * (0.5 * (1.0 + torch.tanh(
        0.7978845608028654 * (h + 0.044715 * h ** 3)))))
    b3_row("bench MLP group 0 M2048 K3072 N8192 (unscaled)", lhs, w1, gelu)
    h = gelu(plain_mm(lhs, w1))
    del w1, lhs
    w2, r = randn(N, K), randn(M, K)
    b3_row("bench MLP group 1 M2048 K8192 N3072 (unscaled)", h, w2,
           lambda a: torch.tanh(a) + r.to(a.dtype))
    del h, w2, r
    w = randn(K, 256, scale=K ** -0.5)
    b3_row("row-reducing epilogue M2048 K3072 N256 (RMSNorm)", x, w,
           lambda a: a * torch.rsqrt((a ** 2).mean(-1, keepdim=True) + 1e-6))
    del x, w

    for label, (B, Hq, Hkv, S, D), causal, bias in (
            ("llama prefill", (4, 24, 8, 512, 128), True, False),
            ("hubert train", (8, 16, 16, 512, 80), False, False),
            ("granite prefill", (4, 16, 8, 512, 64), True, False),
            ("zamba2 prefill", (4, 32, 32, 500, 64), True, False),
            ("score_mod llama heads + bias", (4, 24, 24, 512, 128), False,
             True),
            ("gemma-7b heads", (4, 16, 16, 512, 256), True, False)):
        q, k, v = randn(B, Hq, S, D), randn(B, Hkv, S, D), randn(B, Hkv, S, D)
        bb = randn(S, S) if bias else None
        plain = attention(q, k, v, causal=causal, bias=bb, product=plain_mm)
        f64 = attention(q.double(), k.double(), v.double(), causal=causal,
                        bias=None if bb is None else bb.double())
        row = {"kernel": "B4", "shape": f"{label} B{B} Hq{Hq} Hkv{Hkv} "
                                        f"S{S} D{D}",
               "plain_vs_f64_err_over_limit": b4_ratio(plain, f64)}
        kt = 32 if D > 128 else 64
        variants = [("one_sum", split_matmul, split_matmul),
                    ("qk_only", split_matmul, plain_mm),
                    ("pv_only", plain_mm, split_matmul)]
        for dc in (None,) + B4_D_CHUNKS:
            variants.append((
                f"qk_chunk{dc or D}_pv_chunk{kt}",
                lambda a, b, _c=dc: split_matmul(a, b, _c),
                lambda a, b: split_matmul(a, b, kt)))
        for tag, qk_, pv_ in variants:
            got = attention(q, k, v, causal=causal, bias=bb, product=qk_,
                            pv=pv_)
            row[f"{tag}_err_over_limit"] = b4_ratio(got, plain)
            row[f"{tag}_vs_f64_err_over_limit"] = b4_ratio(got, f64)
            del got
        if D == 80:
            sdpa = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
            row["sdpa_vs_plain_err_over_limit"] = b4_ratio(sdpa, plain)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del q, k, v, plain, f64
    rows += _measure_b11(randn, plain_mm)
    return rows


#: B11's products measured: one tensor-core sum over each product's
#: contracted extent (c 64 or N), or a partial sum each 16 or 32 of it
B11_CHUNKS = (16, 32)


def _measure_b11(randn, plain_mm) -> list[dict]:
    """Step 0 of B11's tensor-core design: the chunk-parallel scan with
    its four products split (one sum, and partial sums), and with plain
    float32 products, against the plain version and float64, at the main
    path's shapes."""
    import torch.nn.functional as F

    from .ssd_scan import ssd_scan_plain

    rows = []
    for label, (b, L, H, P, N) in (
            ("mamba2 prefill", (4, 512, 32, 64, 128)),
            ("zamba2 prefill", (4, 512, 64, 64, 64)),
            ("mamba2 train", (8, 512, 32, 64, 128))):
        x, Bm, Cm = randn(b, L, H, P), randn(b, L, N), randn(b, L, N)
        dt = F.softplus(randn(b, L, H) - 2.0)
        A = -torch.exp(0.3 * randn(H))
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            plain = ssd_scan_plain(x, dt, A, Bm, Cm, 64)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = True
        f64 = ssd_chunked(x.double(), dt.double(), A.double(), Bm.double(),
                          Cm.double(), 64)
        row = {"kernel": "B11", "shape": f"{label} b{b} L{L} H{H} P{P} "
                                         f"N{N} chunk64",
               "plain_vs_f64_err_over_limit": ssd_ratio(plain, f64)}
        for tag, prod in (("chunked_plain_products", plain_mm),
                          ("one_sum", split_matmul),
                          *((f"chunk{k}", lambda a, m, _k=k:
                             split_matmul(a, m, _k)) for k in B11_CHUNKS)):
            got = ssd_chunked(x, dt, A, Bm, Cm, 64, product=prod)
            row[f"{tag}_err_over_limit"] = ssd_ratio(got, plain)
            row[f"{tag}_vs_f64_err_over_limit"] = ssd_ratio(got, f64)
            del got
        rows.append(row)
        print(json.dumps(row), flush=True)
        del x, Bm, Cm, dt, plain, f64
    return rows


#: ``cvt.rna.tf32.f32`` against the kernels' integer form of it, on every
#: float32 bit pattern below 3e38 in magnitude (2^28 a launch)
_RNA_CHECK = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void rna_check(unsigned long long* bad, uint32_t base) {
  const uint32_t bits = base + blockIdx.x * blockDim.x + threadIdx.x;
  const float x = __uint_as_float(bits);
  if (!(fabsf(x) < 3.0e38f)) return;
  uint32_t c;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(c) : "f"(x));
  if (c != ((bits + 0x1000u) & 0xFFFFE000u)) atomicAdd(bad, 1ull);
}
extern "C" int repro_rna_check(void* bad, unsigned base, void* stream) {
  rna_check<<<(1 << 28) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(bad), base);
  return static_cast<int>(cudaGetLastError());
}
"""


#: ``chip_smoke.py``'s bfloat16 rule for B3 (a test holds the two files
#: equal): each element within BF16_BAND (rtol, atol) of the plain
#: version, and the largest distance from float64 at most BF16_F64_FACTOR
#: times the plain version's
BF16_BAND, BF16_F64_FACTOR = (4e-2, 1.2e-1), 2.0


def bf16_rule_ratio(got, plain, f64) -> float:
    """The worst ratio of a bfloat16 output to its rule (``BF16_BAND``
    and ``BF16_F64_FACTOR``): 1 at the limit."""
    g, w = got.double(), plain.double()
    rtol, atol = BF16_BAND
    band = float(((g - w).abs() / (atol + rtol * w.abs())).max())
    kerr = float((g - f64).abs().max())
    perr = float((w - f64).abs().max())
    return max(band, kerr / (BF16_F64_FACTOR * max(perr, 1e-30)))


def _gate(x, wg, u):
    import torch.nn.functional as F

    return F.silu(x @ wg) * u


def _measure_bf16() -> list[dict]:
    """B3's native bfloat16 instance (Llama's gate + SiLU x up, M 2048, N
    8192: one tensor-core sum over all of K) at K 3072 and 8192, and the
    plain form of the same products with a partial sum each k-tile
    (``bf16_matmul(chunk=64)``, the same epilogue's roundings), each
    against the plain version and float64: the worst ratio to the
    bfloat16 rule."""
    import torch.nn.functional as F
    from ..core import stitched_jit

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(bf)

    rows = []
    M, N = 2048, 8192
    for K in (3072, 8192):
        args = (rnd(M, K), rnd(K, N, scale=K ** -0.5), rnd(M, N))
        comp = stitched_jit(_gate).compiled(*args)
        em = next(e for e in comp.emitted if e.kind == "anchored")
        given = dict(zip(comp.graph.inputs, args))
        vals = [given[i] for i in em.ext_ids]
        got = em.fn.launch(*vals)[0]
        plain = em.fn.plain(*vals)[0]
        x, wg, u = args
        h = bf16_matmul(x, wg, 64).to(bf).float()
        chunked = (F.silu(h).to(bf).float() * u.float()).to(bf)
        h64 = x.double() @ wg.double()
        f64 = h64 * torch.sigmoid(h64) * u.double()
        row = {"kernel": "B3 native bf16", "shape": f"M{M} K{K} N{N}",
               "one_sum_err_over_limit": bf16_rule_ratio(got, plain, f64),
               "chunk64_form_err_over_limit": bf16_rule_ratio(chunked,
                                                              plain, f64),
               "elements_differing": int((got != chunked).sum())}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del comp, em, got, plain, chunked, h, h64, f64
    return rows


def rna_mismatches() -> int:
    """Bit patterns on which the card's ``cvt.rna.tf32.f32`` and the
    integer rounding the kernels use (and ``tf32_rna``) differ."""
    import ctypes

    from . import _build

    fn = _build.generated_library("tf32_rna_check", _RNA_CHECK) \
        .repro_rna_check
    fn.argtypes = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bad = torch.zeros(1, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for base in range(0, 1 << 32, 1 << 28):
        _build.check(fn(bad.data_ptr(), base, stream), "repro_rna_check")
    return int(bad.item())


def main(argv=None) -> int:
    import argparse
    import subprocess

    ap = argparse.ArgumentParser(description="The split's and the native "
                                 "bfloat16 products' limits, on the card.")
    ap.add_argument("--bf16", action="store_true",
                    help="only B3's native bfloat16 instance, beside "
                         "the plain form with partial sums")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("split_float: no CUDA device")
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card)
    if args.bf16:
        rows = _measure_bf16()
        for key in ("one_sum_err_over_limit",
                    "chunk64_form_err_over_limit"):
            print(f"worst {key} {max(r[key] for r in rows):.4f} ({card})")
        return 0
    print(f"cvt.rna.tf32.f32 against the integer rounding: "
          f"{rna_mismatches()} of the float32 bit patterns below 3e38 "
          "differ")
    rows = _measure()
    for key in sorted({k for r in rows for k in r
                       if k.endswith("err_over_limit")}):
        print(f"worst {key} {max(r.get(key, 0.0) for r in rows):.4f} "
              f"({card})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
