"""Fused matmul B3: ``epilogue(prologue(lhs) @ rhs, epilogue operands)``.

The counterpart of ``matmul_fused`` (the TPU kernel,
``src/repro/kernels/matmul.py:53``, ``pallas_call`` at :105), which
compute-anchored stitching emits for a group folded around one
``dot_general``: the element-wise chain feeding the contraction runs on
the lhs as it is staged, and the chain consuming it runs on the float32
accumulator before the store, so neither chain's interface tensor
round-trips device memory.

Operands fold into the kernel's 2D views by role, as in the reference:
prologue operands against (M, K), epilogue operands and outputs against
(M, N); ``full`` is the whole view, ``row`` one value a row, ``col`` one
value a column, ``scalar`` one value.

The TPU kernel tiles M only (block_m 128) and keeps the whole (K, N)
panel resident in VMEM.  An H100 block has at most 227 KB of shared
memory, a 3072 x 8192 panel is 100 MB: the CUDA kernel
(``csrc/matmul_fused.cuh``, instantiated per chain by
``core/codegen_cuda.py``) is a GPU GEMM instead -- a grid over (N tiles,
M tiles), a loop over K through a ring of shared-memory stages, the
products on the tensor cores (``wgmma``) through the three-way TF32
split (``kernels/split_float.py``), float32 results.  The rhs and the
chains' operands and outputs may be bfloat16: a bfloat16 operand is
exact in TF32, so its side of the split has no small half (one side
bfloat16: two TF32 products a k-step); the accumulator rounds to the
product's type before the epilogue, as the reference's ``anchor_dtype``
cast.  Where the prologue's lhs node and the rhs are both bfloat16 the
chain instantiates the native template instead
(``csrc/matmul_bf16.cuh``, ``NATIVE_TILES``): bfloat16 tiles copied by
the Tensor Memory Accelerator into the 128-byte swizzle, ``wgmma`` with
bfloat16 operands at the tensor cores' full rate, the same chains.  A
prologue that reduces over K gets its row statistics from a pass over
the block's lhs rows before the k-tiles; an epilogue that reduces over
N runs on the row tile, whose blocks along N form a thread-block
cluster of up to ``MAX_CLUSTER`` (so N up to ``ROW_MAX_N``) that
exchanges the row partials through distributed shared memory.
``TILES`` (and ``NATIVE_TILES``) hold the tile constants; the cost
model's H100 feasibility gate
(``cost_model._anchor_vmem``) and the launcher read them from here, so
the two cannot drift apart (the generated source asserts each
instance's shared memory against ``Tile.smem_bytes``).

``matmul_fused`` runs the plain version (``torch.matmul`` between the
chains, evaluated on whole tensors) for CPU tensors and the generated
CUDA kernel for CUDA tensors, or raises.  ``matmul_fused.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from . import _build, widen

ROLE_FULL, ROLE_ROW, ROLE_COL, ROLE_SCALAR = "full", "row", "col", "scalar"

DEFAULT_BLOCK_M = 128


@dataclass(frozen=True)
class Tile:
    """One instance of the CUDA template: a (bm, bn) output tile a block,
    K staged bk at a time; ``raw_stages`` float32 k-tiles in flight
    (cp.async), split into a ring of ``stages`` TF32 operand tiles; bm /
    64 x ``wn`` consumer warpgroups (each 64 rows by bn / wn columns,
    ``wn`` of them along N) and ``producers`` producer warpgroups (each
    the k-tiles of its residue); the products of ``promote`` k-tiles
    summed on the tensor cores from zero, then added into the
    accumulator; ``a_rows`` (8) keeps only 8 lhs rows in shared memory,
    for M <= 8.  A ``native`` tile is one of ``csrc/matmul_bf16.cuh``
    (bfloat16 x bfloat16): ``stages`` TMA stages of 64 of K, one
    producer warpgroup, no raw stages, one sum over all of K."""
    bm: int
    bn: int
    bk: int
    stages: int
    raw_stages: int
    wn: int = 1
    promote: int = 1
    producers: int = 1
    a_rows: int = 0
    native: bool = False

    @property
    def am(self) -> int:
        """Rows of the lhs operand tile: ``bm``, or ``a_rows`` (8) on the
        decode tile, which takes M <= 8 only."""
        return self.a_rows or self.bm

    @property
    def consumers(self) -> int:
        return self.bm // 64 * self.wn

    @property
    def threads(self) -> int:
        return 128 * (self.consumers + self.producers)

    @property
    def template_args(self) -> str:
        """The arguments of ``repro_mm::launch`` for this instance (of
        ``repro_mm::launch_bf16`` for a native one)."""
        if self.native:
            return (f"{self.bm}, {self.bn}, {self.stages}, {self.wn}, "
                    f"{self.am}")
        return (f"{self.bm}, {self.bn}, {self.bk}, {self.stages}, "
                f"{self.raw_stages}, {self.wn}, {self.promote}, "
                f"{self.producers}, {self.am}")

    def smem(self, epi_slots: int = 0, pro_slots: int = 0) -> int:
        """Shared memory of one block (``smem_bytes`` in
        ``csrc/matmul_fused.cuh``) for a chain whose epilogue holds
        ``epi_slots`` row reductions and whose prologue ``pro_slots``: the
        operand stages (big and small TF32 tiles of the lhs and the rhs),
        the raw stages (the lhs rows padded by 4 floats), the epilogue's
        slot exchanges (across the ``wn`` consumer warpgroups where ``wn``
        > 1, and across the cluster), the prologue's row statistics, and
        two barriers a stage.  A native tile (``native_smem_bytes`` in
        ``csrc/matmul_bf16.cuh``): 1,024 bytes to align the ring, its
        stages of bfloat16 lhs and rhs tiles (128 bytes a row), two
        barriers a stage, the same exchanges and statistics."""
        xch = self.wn * self.bm * epi_slots if self.wn > 1 else 0
        cx = self.bm * epi_slots
        if self.native:
            return (1024 + self.stages * 128 * (self.am + self.bn)
                    + 16 * self.stages
                    + 4 * (xch + cx + self.am * pro_slots))
        op = self.stages * 2 * (self.am + self.bn) * self.bk
        raw = self.raw_stages * (self.am * (self.bk + 4) + self.bk * self.bn)
        return 4 * (op + raw + xch + cx + self.am * pro_slots) \
            + 16 * self.stages

    @property
    def smem_bytes(self) -> int:
        """Shared memory of one block of a chain without reductions."""
        return self.smem()


#: prefill-sized M: 128 x 128 a block (two consumer warpgroups of 64 x
#: 128, two producers), 16 deep, 6 raw and 3 operand stages, a partial
#: sum each 32 of K (208,944 bytes: one block an SM)
TILE_LARGE = Tile(128, 128, 16, 3, 6, promote=2, producers=2)
#: where the large tile leaves SMs idle (decode's M 4): 64 x 32 a block,
#: 32 deep, 3 raw and 3 operand stages (113,712 bytes: two blocks an SM),
#: so that N / 32 blocks stream the panel (bytes bound there), a partial
#: sum each 64 of K
TILE_SMALL = Tile(64, 32, 32, 3, 3, promote=2)
#: epilogues that reduce over N: 256 columns of N a block, two consumer
#: warpgroups of 64 x 128 side by side along N, two producers; the
#: blocks of a row form one thread-block cluster that exchanges the row
#: partials through distributed shared memory
TILE_ROW = Tile(64, 256, 16, 3, 4, wn=2, promote=2, producers=2)
#: decode (M <= 8): 8 lhs rows in shared memory, which frees it for 12
#: raw stages (11 k-tiles of the panel in flight a block) and two blocks
#: an SM, N / 32 blocks streaming the panel (bytes bound)
TILE_DECODE = Tile(64, 32, 32, 3, 12, promote=2, a_rows=8)
TILES = (TILE_LARGE, TILE_SMALL, TILE_ROW, TILE_DECODE)
#: The native bfloat16 instances (``csrc/matmul_bf16.cuh``), in the order
#: of ``TILES`` (a chain's tile index names the same role in both):
#: prefill-sized M, 128 x 256 a block (two consumer warpgroups of 64 x
#: 256), 4 TMA stages of 64 of K (197,696 bytes: one block an SM); the
#: faster on the card at Llama's gate of it and 128 x 128 with 6 stages
NATIVE_LARGE = Tile(128, 256, 64, 4, 0, native=True)
#: where the large tile leaves SMs idle: 64 x 64, 6 stages (99,424 bytes:
#: two blocks an SM)
NATIVE_SMALL = Tile(64, 64, 64, 6, 0, native=True)
#: epilogues that reduce over N: 256 columns a block, two consumer
#: warpgroups of 64 x 128 side by side, the row's blocks one cluster
NATIVE_ROW = Tile(64, 256, 64, 4, 0, wn=2, native=True)
#: decode (M <= 8): 8 lhs rows repeated over the 64 of `wgmma`, 12 stages
#: of the streamed panel (111,808 bytes), N / 64 blocks
NATIVE_DECODE = Tile(64, 64, 64, 12, 0, a_rows=8, native=True)
NATIVE_TILES = (NATIVE_LARGE, NATIVE_SMALL, NATIVE_ROW, NATIVE_DECODE)
#: blocks a cluster of the row tile holds at most (``kMaxCluster``: the
#: portable cluster size, which every H100 grants), and so the widest N
#: an epilogue may reduce over: the gate refuses a wider one (it then
#: runs memory-only), and otherwise only by shared memory
MAX_CLUSTER = 8
ROW_MAX_N = MAX_CLUSTER * TILE_ROW.bn
#: the H100's streaming multiprocessors
SMS = 132


#: Launches of two forms, counted beside ``matmul_fused.launches`` (which
#: counts every form): instances whose prologue reduces over K (its row
#: statistics first)
PROLOGUE_REDUCE = _build.LaunchCount("matmul_fused_prologue_reduce")
#: launches whose epilogue reduces across the N tiles of a cluster
CLUSTER_EPILOGUE = _build.LaunchCount("matmul_fused_cluster_epilogue")
#: launches of the TF32 split's instances with a bfloat16 operand (one
#: side float32: the mixed-type instances)
BF16 = _build.LaunchCount("matmul_fused_bf16")
#: launches of the native bfloat16 instances (bfloat16 lhs and rhs)
NATIVE_BF16 = _build.LaunchCount("matmul_fused_native_bf16")


def tile_set(native: bool) -> tuple:
    """The instances of a chain: ``NATIVE_TILES`` for a bfloat16 lhs and
    rhs, else ``TILES``; both indexed by ``pick_tile``."""
    return NATIVE_TILES if native else TILES


def pick_tile(M: int, N: int, row_reduce: bool, native: bool = False) -> int:
    """Index into ``TILES`` (with ``native``, ``NATIVE_TILES``) of the
    instance an (M, N) call runs: the row tile for an epilogue that
    reduces over N, else the decode tile for M <= 8, the large tile where
    it gives every SM a block, else the small one."""
    if row_reduce:
        return TILES.index(TILE_ROW)
    if M <= TILE_DECODE.am:
        return TILES.index(TILE_DECODE)
    large_tile = tile_set(native)[TILES.index(TILE_LARGE)]
    large = -(-M // large_tile.bm) * -(-N // large_tile.bn)
    return TILES.index(TILE_LARGE if large >= SMS else TILE_SMALL)


def _view(v: torch.Tensor, role: str, R: int, C: int) -> torch.Tensor:
    if role == ROLE_FULL:
        return v.reshape(R, C)
    if role == ROLE_ROW:
        return v.reshape(R, 1)
    if role == ROLE_COL:
        return v.reshape(1, C)
    return v.reshape(())


_OUT_SHAPE = {ROLE_FULL: lambda M, N: (M, N), ROLE_ROW: lambda M, N: (M, 1),
              ROLE_COL: lambda M, N: (1, N), ROLE_SCALAR: lambda M, N: (1, 1)}


def matmul_fused_plain(pro_args: Sequence, rhs, epi_args: Sequence, *,
                       M: int, K: int, N: int, pro_roles: Sequence[str],
                       epi_roles: Sequence[str], out_roles: Sequence[str],
                       out_dtypes: Sequence, prologue: Callable | None = None,
                       epilogue: Callable | None = None) -> tuple:
    """The kernel's function in plain PyTorch: the prologue on the whole
    (M, K) view, ``torch.matmul`` in float32 (a bfloat16 lhs or rhs
    widened exactly), the epilogue on the whole (M, N) result.  Outputs
    are 2D by role: (M, N), (M, 1), (1, N) or (1, 1)."""
    pro = [_view(v, r, M, K) for v, r in zip(pro_args, pro_roles)]
    lhs = prologue(*pro) if prologue is not None else pro[0]
    acc = torch.matmul(lhs.to(torch.float32), rhs.reshape(K, N)
                       .to(torch.float32))
    epi = [_view(v, r, M, N) for v, r in zip(epi_args, epi_roles)]
    outs = epilogue(acc, *epi) if epilogue is not None else (acc,)
    return tuple(o.expand(_OUT_SHAPE[r](M, N)).to(dt)
                 for o, r, dt in zip(outs, out_roles, out_dtypes))


def matmul_fused_cuda(pro_args: Sequence, rhs, epi_args: Sequence, *,
                      M: int, K: int, N: int, out_roles: Sequence[str],
                      out_dtypes: Sequence, entry, tile: int) -> tuple:
    """Launch a generated instance of ``csrc/matmul_fused.cuh``.

    ``entry`` is the instance's C entry point (``codegen_cuda``; its
    ``pro_slots`` and ``epi_slots`` are the chain's row reductions), ``tile``
    an index into ``TILES``.  The rhs is read as a contiguous [K, N]
    panel of float32 or bfloat16 (the instance's type), every operand as a
    contiguous array of its role's view.  Every launch counts in ``matmul_fused.launches``; one with a
    reducing prologue also in ``PROLOGUE_REDUCE``, one whose epilogue
    reduces across more than one N tile in ``CLUSTER_EPILOGUE``, one of
    a native instance (``entry.native``) in ``NATIVE_BF16``, one of the
    TF32 split with a bfloat16 operand in ``BF16``."""
    dev = rhs.device
    vals = list(pro_args) + [rhs] + list(epi_args)
    if any(v.device != dev for v in vals) or dev.type != "cuda":
        raise ValueError("matmul_fused_cuda: every operand must lie on one "
                         f"CUDA device, got {sorted({str(v.device) for v in vals})}")
    if rhs.dtype not in widen.TAKEN_DTYPES:
        raise TypeError(f"matmul_fused_cuda takes a float32, bfloat16 or "
                        f"float16 rhs, got {rhs.dtype}")
    pro = [v.contiguous() for v in pro_args]
    epi = [v.contiguous() for v in epi_args]
    # a float16 rhs (an instance's rhs is bfloat16 only for a bfloat16
    # graph) is read as float32, widened first as the reference widens
    rhs = widen.own(rhs).reshape(K, N).contiguous()
    outs = [torch.empty(_OUT_SHAPE[r](M, N), dtype=dt, device=dev)
            for r, dt in zip(out_roles, out_dtypes)]

    def ptrs(ts):
        return (ctypes.c_void_p * max(1, len(ts)))(
            *[t.data_ptr() for t in ts])

    _build.check(entry(
        tile, ptrs(pro), rhs.data_ptr(), ptrs(epi), ptrs(outs), M, K, N,
        torch.cuda.current_stream(dev).cuda_stream), "repro_mm_fused")
    _build.count(matmul_fused)
    if getattr(entry, "pro_slots", 0):
        _build.count(PROLOGUE_REDUCE)
    if getattr(entry, "epi_slots", 0) and N > TILE_ROW.bn:
        _build.count(CLUSTER_EPILOGUE)
    if getattr(entry, "native", False):
        _build.count(NATIVE_BF16)
    elif any(v.dtype == torch.bfloat16 for v in vals):
        _build.count(BF16)
    return tuple(outs)


def matmul_fused(pro_args: Sequence, rhs, epi_args: Sequence, *,
                 M: int, K: int, N: int, pro_roles: Sequence[str],
                 epi_roles: Sequence[str], out_roles: Sequence[str],
                 out_dtypes: Sequence, prologue: Callable | None = None,
                 epilogue: Callable | None = None, entry=None,
                 tile: int = 0) -> tuple:
    """Run ``epilogue(prologue(pro_args) @ rhs, epi_args)``: the plain
    version on CPU tensors, the generated CUDA kernel (``entry`` at
    ``TILES[tile]``) on CUDA tensors.  ``prologue`` maps the prologue
    operands' (M, K) views to the lhs (None: ``pro_args[0]`` is the lhs);
    ``epilogue`` maps the (M, N) product and the epilogue operands'
    views to the outputs (None: the product is the one output)."""
    devs = {v.device.type for v in (*pro_args, rhs, *epi_args)}
    if devs == {"cpu"}:
        return matmul_fused_plain(
            pro_args, rhs, epi_args, M=M, K=K, N=N, pro_roles=pro_roles,
            epi_roles=epi_roles, out_roles=out_roles, out_dtypes=out_dtypes,
            prologue=prologue, epilogue=epilogue)
    if devs != {"cuda"}:
        raise ValueError(f"matmul_fused: operands on {sorted(devs)}; all "
                         "must lie on the CPU (plain version) or on CUDA")
    if entry is None:
        raise RuntimeError("matmul_fused: no CUDA instance for this chain")
    return matmul_fused_cuda(pro_args, rhs, epi_args, M=M, K=K, N=N,
                             out_roles=out_roles, out_dtypes=out_dtypes,
                             entry=entry, tile=tile)


matmul_fused.launches = 0  # kernel launches (plain runs excluded)
