"""Two-level cost model (paper §4.3 latency-evaluator, §5.4 delta-evaluator).

The formulas are the JAX package's re-derivation of the paper's GPU
model, kept unchanged so that the ``V5E`` preset plans exactly as the
reference does; the ``H100`` preset feeds the same formulas Hopper's
numbers (on-chip budget = the shared memory one block may use, HBM rate,
per-element costs from ``classify._GPU_COST``):

  latency-evaluator (accurate, used by codegen):
      paper:  L = N_wave * L_warp,  N_wave = N_warp / Occupancy,
              L_warp = N_instr * CPI
      here:   L = N_step * t_step + t_launch
              t_step = max(t_hbm, t_vpu)   if double-buffering fits VMEM
                     = t_hbm + t_vpu       otherwise  (occupancy analogue)
      A TensorCore runs one kernel at a time, so GPU occupancy has no
      analogue; what limits overlap is whether 2x the per-step working set
      fits the VMEM budget (input buffer pair + scratch).

  delta-evaluator (fast, used by the explorer):
      paper:  f = T_reduced_mem + T_reduced_calls - T_penalty
      here:   identical structure; T_reduced_mem from HBM bytes that stop
              round-tripping, T_reduced_calls from launch overhead,
              T_penalty from a simplified latency model (fixed live-set,
              max-scratch instead of lifetime analysis -- mirroring the
              paper's simplifications of fixed register count and max
              shared memory).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass

from .classify import op_cost as _table_cost
from .ir import Graph, OpKind
from .memory_planner import ReusePlan, plan_reuse, plan_scratch, \
    recompute_extra_ops
from .rowspec import Role, RowInfo, analyze, role_bytes_per_row

@dataclass(frozen=True)
class Hardware:
    """One accelerator as the cost model sees it.

    The defaults are the JAX package's TPU v5e constants (``V5E``), kept
    so the port can plan a graph exactly as the reference does.
    ``vmem_bytes`` is the on-chip working budget of one kernel step and
    ``vpu_ops`` the element-op rate.  ``platform`` ("tpu" or "gpu")
    selects the per-element cost table in ``classify`` and how a packed
    pattern runs: on the TPU the JAX package hands it to XLA, which
    loop-fuses it; the port runs it as plain PyTorch ops, one launch and
    one HBM round trip per op.  ``max_block_elems`` is the most elements
    one generated program holds per live value (its register block,
    rows x columns, each padded to a power of two); 0 sets no cap.
    ``peak_flops`` is the compute peak an anchored kernel's products are
    priced at (the reference's ``peak_bf16_flops`` on ``V5E``).
    """

    hbm_bw: float = 819e9                # bytes/s
    vpu_ops: float = 4.0e12              # vector-ALU element-ops/s
    vmem_bytes: int = 16 * 1024 * 1024   # per-core VMEM working budget
    launch_s: float = 4e-6               # per-executable dispatch overhead
    hbm_latency_s: float = 1.2e-6        # fixed cost per kernel's HBM round
    platform: str = "tpu"
    max_block_elems: int = 0
    peak_flops: float = 197e12           # MXU bf16 FLOP/s

    @property
    def vmem_budget(self) -> int:
        # half for the in/out double-buffer pair, half for scratch
        return self.vmem_bytes // 2

    @property
    def anchor_budget(self) -> int:
        """What an anchored kernel's working set may take: on the TPU the
        reference's half of VMEM (the other half double-buffers); on the
        GPU one block's whole shared memory, since the CUDA instance's own
        figure already counts its ring of stages."""
        return self.vmem_bytes if self.platform == "gpu" else self.vmem_budget


V5E = Hardware()

#: NVIDIA H100 SXM.  Data-sheet figures, not measurements: 989 TFLOP/s
#: bf16, 3.35 TB/s HBM, 900 GB/s NVLink (450 each way), 132 SMs of 128
#: FP32 lanes at 1.98 GHz (67 TFLOP/s FP32 = 33.5e12 lane ops/s), and
#: 232,448 bytes of shared memory one block may use -- the on-chip
#: budget of one generated kernel's step.  ``launch_s`` (an eager
#: PyTorch launch) and ``hbm_latency_s`` are assumed, not measured.  The
#: generated kernels keep a value's whole block in registers: 8192
#: elements (32 per thread at 8 warps) per value.  ``peak_flops`` is the
#: rate of the anchored kernels' products: the tensor cores' 495 TFLOP/s
#: of TF32 over the three products of the float32 split.
H100 = Hardware(hbm_bw=3.35e12, vpu_ops=33.5e12, vmem_bytes=232_448,
                launch_s=5e-6, hbm_latency_s=1e-6, platform="gpu",
                max_block_elems=8192, peak_flops=495e12 / 3)

#: Block-row candidates the codegen enumerates (launch-dimension analogue).
BLOCK_ROWS = (1, 8, 16, 32, 64, 128, 256)


def _pad(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def block_fits(hw: Hardware, rows: int, cols: int) -> bool:
    """Does a generated program's ``rows`` x ``cols`` block per value,
    each side padded to a power of two as the kernel generator pads it,
    fit ``hw.max_block_elems``?"""
    return (not hw.max_block_elems
            or next_pow2(rows) * next_pow2(cols) <= hw.max_block_elems)


# ---------------------------------------------------------------------------
# latency-evaluator
# ---------------------------------------------------------------------------
@dataclass
class KernelEstimate:
    schedule: str           # "onepass" | "streaming" | "packed" | "unfused"
    block_rows: int
    latency_s: float
    hbm_bytes: int
    vpu_ops: float
    scratch_bytes: int      # per grid step
    n_steps: int
    feasible: bool
    block_cols: int = 0     # streaming column tile (0: whole row / n.a.)
    recompute_ids: tuple = ()  # values rematerialized per consumer instead
    #                            of staged (onepass thread-composition)


def _per_step_elems(role: Role, br: int, Cp: int) -> int:
    return (br * Cp if role is Role.FULL else
            br if role is Role.ROW else Cp if role is Role.COL else 1)


def _onepass_op_cost(graph: Graph, info: RowInfo, br: int, Cp: int,
                     hw: Hardware):
    """One evaluation of a node, in element-ops per grid step."""
    def op_cost(nid: int) -> float:
        node = graph.node(nid)
        role = info.roles[nid]
        per_step = _per_step_elems(role, br, Cp)
        if node.kind is OpKind.REDUCE:
            per_step = br * Cp  # reduce reads a FULL operand tile
        return _table_cost(node.prim, hw.platform) * per_step
    return op_cost


def _onepass_fixed_bytes(graph: Graph, info: RowInfo, br: int, Cp: int,
                         ext_in, outs) -> tuple[int, int]:
    """(step_hbm, col_bytes): the non-scratch part of the one-pass
    per-step working set.  Shared by ``estimate_onepass`` and
    ``reuse_plan`` so the feasibility verdicts of the recompute decision
    pass and the estimator can never drift apart."""
    def tile_bytes(nid: int) -> int:
        node = graph.node(nid)
        role = info.roles.get(nid)
        if role is Role.FULL:
            return br * Cp * node.spec.itemsize
        if role is Role.ROW:
            return br * node.spec.itemsize
        if role is Role.COL:
            return Cp * node.spec.itemsize  # loaded once, charged per step
        return node.spec.itemsize

    bytes_in = sum(tile_bytes(i) for i in ext_in
                   if graph.node(i).kind is not OpKind.CONST
                   or graph.node(i).spec.size > 128)
    bytes_out = sum(tile_bytes(o) for o in outs)
    col_bytes = sum(Cp * graph.node(i).spec.itemsize for i in ext_in
                    if info.roles.get(i) is Role.COL)
    return bytes_in + bytes_out, col_bytes


def estimate_onepass(graph: Graph, pattern: frozenset[int], info: RowInfo,
                     block_rows: int, hw: Hardware = H100,
                     ctx=None,
                     recompute: frozenset[int] | None = None
                     ) -> KernelEstimate:
    """Latency of the stitched one-pass row kernel at a given block size.

    ``recompute`` prices the thread-composition variant: those members
    get no scratch slot (the working set shrinks) but are re-evaluated
    at every consumer (extra VPU ops, ``recompute_extra_ops``).
    """
    R, C = info.R, info.C
    Cp = _pad(C, 128)
    br = min(block_rows, R)
    n_steps = math.ceil(R / br)
    rec = frozenset(recompute) & pattern if recompute else frozenset()

    if ctx is not None:
        b = ctx.bounds(pattern)
        ext_in, outs = b.inputs, b.outputs
    else:
        ext_in = graph.pattern_inputs(pattern)
        outs = graph.pattern_outputs(pattern)

    step_hbm, col_bytes = _onepass_fixed_bytes(graph, info, br, Cp,
                                               ext_in, outs)

    op_cost = _onepass_op_cost(graph, info, br, Cp, hw)
    ops = sum(op_cost(nid) for nid in pattern)
    if rec:
        ops += recompute_extra_ops(graph, pattern, rec, op_cost)

    scratch = (ctx.scratch(pattern, info, recompute=rec) if ctx is not None
               else plan_scratch(graph, pattern, info, recompute=rec))
    scratch_bytes = scratch.total_bytes * br
    working = step_hbm + scratch_bytes + col_bytes

    t_hbm = step_hbm / hw.hbm_bw
    t_vpu = ops / hw.vpu_ops
    # one feasibility check: the in/out buffer pair (2x the per-step
    # working set) must fit VMEM; the same bound decides HBM/VPU overlap.
    double_buffer_fits = 2 * working <= hw.vmem_bytes
    t_step = max(t_hbm, t_vpu) if double_buffer_fits else (t_hbm + t_vpu)

    total_hbm = (ctx.hbm_bytes(pattern) if ctx is not None
                 else graph.pattern_hbm_bytes(pattern))
    lat = n_steps * t_step + hw.launch_s + hw.hbm_latency_s
    return KernelEstimate("onepass", br, lat, total_hbm, ops * n_steps,
                          int(working), n_steps,
                          double_buffer_fits and block_fits(hw, br, C),
                          recompute_ids=tuple(sorted(rec)))


# ---------------------------------------------------------------------------
# stage vs. recompute pricing (paper §4: thread-composition scheme)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class RecomputeCost:
    """Price of rematerializing one value inside its consumers.

    ``cone`` is the member-ancestor closure the inlined expression
    re-evaluates (reading kernel externals / staged reduce results at
    the leaves); ``ops_per_row`` its VPU element-ops per row per
    evaluation; ``ext_read_bytes_per_row`` the external bytes the cone
    re-reads per row (VMEM-resident re-reads in a one-pass cell, but
    reported so the trade is visible).  ``legal`` is False when the
    cone crosses a reduce-level boundary: the value is (or depends on)
    a reduction, whose result only exists after a full row pass --
    those values must stay staged (block composition).
    """

    cone: tuple[int, ...]
    ops_per_row: float
    ext_read_bytes_per_row: int
    legal: bool


def recompute_cost(graph: Graph, pattern: frozenset[int], nid: int,
                   info: RowInfo, outputs=None,
                   hw: "Hardware | None" = None) -> RecomputeCost:
    """Memoizable (via ``CostContext.recompute_cost``) stage-vs-recompute
    pricing of one pattern member (paper §4's per-value scheme choice)."""
    node = graph.node(nid)
    outs = set(graph.pattern_outputs(pattern) if outputs is None
               else outputs)
    _, anc = graph.reachability()
    pmask = 0
    reduce_mask = 0
    for m in pattern:
        pmask |= 1 << m
        if graph.node(m).kind is OpKind.REDUCE:
            reduce_mask |= 1 << m
    cone_mask = (anc[nid] & pmask) | (1 << nid)
    # illegal across reduce-level boundaries: the value is a reduction or
    # its producer cone contains one (recomputing it per consumer would
    # redo a full row pass; block composition stages it instead).  An
    # output must also stay materialized for its HBM write.
    legal = (node.kind is not OpKind.REDUCE
             and not (cone_mask & reduce_mask)
             and nid not in outs
             and any(c in pattern for c in graph.consumers(nid)))

    cone: list[int] = []
    m = cone_mask
    while m:
        lsb = m & -m
        cone.append(lsb.bit_length() - 1)
        m ^= lsb
    ops = 0.0
    ext_bytes = 0
    seen_ext: set[int] = set()
    for cn in cone:
        cnode = graph.node(cn)
        role = info.roles.get(cn)
        per_row = (info.C if role in (Role.FULL, Role.COL)
                   else 1 if role in (Role.ROW, Role.SCALAR) else info.C)
        ops += _table_cost(cnode.prim, (hw or H100).platform) * per_row
        for i in cnode.inputs:
            if i not in pattern and i not in seen_ext:
                seen_ext.add(i)
                erole = info.roles.get(i)
                ext_bytes += role_bytes_per_row(
                    erole if erole is not None else Role.FULL,
                    info.C, graph.node(i).spec.itemsize)
    return RecomputeCost(cone=tuple(cone), ops_per_row=ops,
                         ext_read_bytes_per_row=ext_bytes, legal=legal)


def reuse_plan(graph: Graph, pattern: frozenset[int], info: RowInfo,
               block_rows: int, hw: Hardware = H100,
               ctx=None) -> ReusePlan | None:
    """The pattern's stage-vs-recompute decision at one block size.

    Assembles the fixed (non-scratch) part of the one-pass working set
    exactly as ``estimate_onepass`` does, screens flip candidates
    through ``recompute_cost`` legality, and hands the greedy
    flip-until-feasible loop to ``memory_planner.plan_reuse``.  Returns
    None when no candidate is legal.
    """
    R, C = info.R, info.C
    Cp = _pad(C, 128)
    br = min(max(1, block_rows), R)
    if ctx is not None:
        b = ctx.bounds(pattern)
        ext_in, outs = b.inputs, b.outputs
    else:
        ext_in = graph.pattern_inputs(pattern)
        outs = graph.pattern_outputs(pattern)

    # legal flip targets with their cone prices (the greedy's per-round
    # evaluation-order tie-break: cheaper cones first)
    candidates: dict[int, float] = {}
    for nid in sorted(pattern):
        rc = (ctx.recompute_cost(pattern, nid) if ctx is not None
              else recompute_cost(graph, pattern, nid, info,
                                  outputs=outs, hw=hw))
        if rc.legal:
            candidates[nid] = rc.ops_per_row
    if not candidates:
        return None

    step_hbm, col_bytes = _onepass_fixed_bytes(graph, info, br, Cp,
                                               ext_in, outs)
    return plan_reuse(graph, pattern, info, hw.vmem_bytes,
                      block_rows=br, fixed_step_bytes=step_hbm + col_bytes,
                      op_cost=_onepass_op_cost(graph, info, br, Cp, hw),
                      candidates=candidates)


def reduce_levels(graph: Graph, pattern: frozenset[int]) -> dict[int, int]:
    """Phase level per node for the streaming schedule.

    A reduce result becomes available only after a full pass over the
    row, so ``lvl(reduce) = lvl(input) + 1``; everything else inherits
    the max of its inputs.  Phases needed = max level + 1 (LayerNorm:
    mean pass, variance pass, apply pass = 3).
    """
    lvl: dict[int, int] = {}
    for nid in sorted(pattern):
        node = graph.node(nid)
        base = max((lvl.get(i, 0) for i in node.inputs), default=0)
        lvl[nid] = base + 1 if node.kind is OpKind.REDUCE else base
    return lvl


def estimate_streaming(graph: Graph, pattern: frozenset[int], info: RowInfo,
                       block_rows: int, block_cols: int,
                       hw: Hardware = H100, ctx=None) -> KernelEstimate:
    """Streaming multi-phase schedule (warp-composition analogue):
    column-tiled passes with ROW accumulators staged in VMEM scratch;
    FULL inputs are re-read (and low-level nodes re-computed) once per
    phase -- the reuse/recompute trade of paper §2.3, priced here."""
    R, C = info.R, info.C
    br = max(1, min(block_rows, R))
    bc = max(128, min(block_cols, _pad(C, 128)))
    phases = max(reduce_levels(graph, pattern).values(), default=0) + 1
    n_col_tiles = math.ceil(C / bc)
    n_steps = math.ceil(R / br) * phases * n_col_tiles

    if ctx is not None:
        b = ctx.bounds(pattern)
        ext_in, outs = b.inputs, b.outputs
    else:
        ext_in = graph.pattern_inputs(pattern)
        outs = graph.pattern_outputs(pattern)
    full_in = sum(br * bc * graph.node(i).spec.itemsize for i in ext_in
                  if info.roles.get(i) is Role.FULL)
    other_in = sum(graph.node(i).spec.itemsize * br for i in ext_in
                   if info.roles.get(i) is Role.ROW)
    out_b = sum(br * (bc if info.roles[o] is Role.FULL else 1)
                * graph.node(o).spec.itemsize for o in outs)
    # inputs stream every phase; outputs only in the last phase
    step_hbm = full_in + other_in + out_b / phases

    ops = 0.0
    for nid in pattern:
        node = graph.node(nid)
        per_tile = br * bc if info.roles[nid] is Role.FULL else br
        if node.kind is OpKind.REDUCE:
            per_tile = br * bc
        ops += _table_cost(node.prim, hw.platform) * per_tile  # per phase

    n_reduces = sum(1 for n in pattern
                    if graph.node(n).kind is OpKind.REDUCE)
    working = 2 * (full_in + out_b) + n_reduces * br * 4
    overlap = 2 * working <= hw.vmem_bytes
    t_step = max(step_hbm / hw.hbm_bw, ops / hw.vpu_ops) if overlap \
        else (step_hbm / hw.hbm_bw + ops / hw.vpu_ops)
    lat = n_steps * t_step + hw.launch_s + hw.hbm_latency_s
    feasible = (working <= hw.vmem_budget
                and block_fits(hw, br, min(block_cols, C)))
    hbm = (ctx.hbm_bytes(pattern) if ctx is not None
           else graph.pattern_hbm_bytes(pattern))
    return KernelEstimate("streaming", br, lat, hbm * phases,
                          ops * n_steps, int(working), n_steps, feasible,
                          block_cols=bc)


def estimate_packed(graph: Graph, pattern: frozenset[int],
                    hw: Hardware = H100, ctx=None) -> KernelEstimate:
    """Kernel-packing fallback: one launch, XLA-style loop fusion inside.

    Intermediates consumed by *foreign-parallelism* members still spill,
    but the launch count collapses to 1 and same-loop intermediates fuse.
    We charge full HBM for external IO plus half of the internal bytes
    (the paper's thread-composition keeps same-index chains in registers).
    On the GPU the port runs a packed pattern op by op, so it is charged
    the unfused price under the "packed" name.
    """
    if hw.platform == "gpu":
        est = estimate_unfused(graph, pattern, hw)
        return KernelEstimate("packed", 0, est.latency_s, est.hbm_bytes,
                              est.vpu_ops, 0, est.n_steps, True)
    if ctx is not None:
        hbm = ctx.hbm_bytes(pattern) + ctx.internal_bytes(pattern) // 2
    else:
        hbm = (graph.pattern_hbm_bytes(pattern)
               + graph.internal_bytes(pattern) // 2)
    ops = float(graph.subgraph_flops(pattern))
    t = max(hbm / hw.hbm_bw, ops / hw.vpu_ops) + hw.launch_s + hw.hbm_latency_s
    return KernelEstimate("packed", 0, t, hbm, ops, 0, 1, True)


def estimate_unfused(graph: Graph, pattern: frozenset[int],
                     hw: Hardware = H100) -> KernelEstimate:
    """Every member its own kernel (the no-fusion baseline)."""
    hbm = graph.unfused_hbm_bytes(pattern)
    ops = float(graph.subgraph_flops(pattern))
    n_kernels = sum(1 for nid in pattern
                    if graph.node(nid).kind in (OpKind.LIGHT_EW, OpKind.EXPENSIVE_EW,
                                                OpKind.REDUCE, OpKind.TRANSPOSE))
    n_kernels = max(n_kernels, 1)
    t = hbm / hw.hbm_bw + ops / hw.vpu_ops \
        + n_kernels * (hw.launch_s + hw.hbm_latency_s)
    return KernelEstimate("unfused", 0, t, hbm, ops, 0, n_kernels, True)


#: Streaming (block_rows, block_cols) tile candidates the sweep tries.
STREAM_TILES = ((8, 512), (8, 2048), (64, 2048))


def onepass_rows(hw: Hardware, C: int) -> tuple[int, ...]:
    """One-pass block-row candidates: ``BLOCK_ROWS``, or under a register
    cap every power of two whose (rows, C) block fits it."""
    if not hw.max_block_elems:
        return BLOCK_ROWS
    n = hw.max_block_elems // next_pow2(C)
    return tuple(1 << k for k in range(n.bit_length()))


def stream_tiles(hw: Hardware, C: int) -> tuple[tuple[int, int], ...]:
    """Streaming tile candidates: ``STREAM_TILES``, or under a register
    cap each tile with its rows cut to the most that fit the cap."""
    if not hw.max_block_elems:
        return STREAM_TILES
    tiles: list[tuple[int, int]] = []
    for br, bc in STREAM_TILES:
        rows = min(br, hw.max_block_elems // next_pow2(min(bc, C)))
        if rows >= 1:
            tile = (1 << (rows.bit_length() - 1), bc)
            if tile not in tiles:
                tiles.append(tile)
    return tuple(tiles)


def best_estimate(graph: Graph, pattern: frozenset[int],
                  hw: Hardware = H100, ctx=None) -> KernelEstimate:
    """Enumerate schedules x launch dims, return the latency-optimal one.

    When staging makes a one-pass block size VMEM-infeasible, the
    thread-composition variant is priced too: ``reuse_plan`` flips the
    cheapest staged values to per-consumer recompute until the working
    set fits, and the resulting (smaller-scratch, more-VPU) estimate
    joins the sweep -- so unions that are *only* feasible under
    recompute stop losing to a split-or-refuse.
    """
    cands = [estimate_packed(graph, pattern, hw, ctx=ctx)]
    info = ctx.info(pattern) if ctx is not None else analyze(graph, pattern)
    if info is not None:
        for br in onepass_rows(hw, info.C):
            est = estimate_onepass(graph, pattern, info, br, hw, ctx=ctx)
            if est.feasible:
                cands.append(est)
            else:
                rp = (ctx.reuse(pattern, br) if ctx is not None
                      else reuse_plan(graph, pattern, info, br, hw))
                if rp is not None and rp.feasible and rp.recompute:
                    est = estimate_onepass(graph, pattern, info, br, hw,
                                           ctx=ctx, recompute=rp.recompute)
                    if est.feasible:
                        cands.append(est)
            if br >= info.R:
                break
        # streaming (warp-composition analogue) for long rows
        for br, bc in stream_tiles(hw, info.C):
            est = estimate_streaming(graph, pattern, info, br, bc, hw,
                                     ctx=ctx)
            if est.feasible:
                cands.append(est)
    return min(cands, key=lambda e: e.latency_s)


# ---------------------------------------------------------------------------
# cross-pattern stitch pricing (paper §4: megakernel composition)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class StitchGain:
    """What fusing several plan patterns into ONE kernel buys (or costs).

    ``latency_gain_s`` compares the latency-evaluator's per-part sum
    (each part its own ``pallas_call``: per-kernel launch + interface
    tensors round-tripping HBM) against the best schedule of the union
    kernel, which prices the added VMEM pressure -- a union that no
    longer fits one-pass VMEM residency falls to the multi-phase
    streaming schedule whose recompute cost may eat the saving, and a
    union with no feasible stitched schedule is marked infeasible.
    ``hbm_bytes_saved`` is the structural inter-pattern traffic
    eliminated (interface writes + re-reads + shared-input re-reads).
    """

    latency_gain_s: float
    hbm_bytes_saved: int
    feasible: bool
    union_schedule: str


def stitch_gain(graph: Graph, parts, hw: Hardware = H100,
                ctx=None) -> StitchGain:
    """Price merging the disjoint patterns ``parts`` into one kernel."""
    if ctx is not None:
        # register the union's parts chain so its boundary sets derive
        # incrementally from the parts' memoized bounds
        union = ctx.union_all(parts)
    else:
        union = frozenset()
        for p in parts:
            union |= p
    if ctx is not None:
        parts_lat = sum(ctx.best(p).latency_s for p in parts)
        parts_hbm = sum(ctx.hbm_bytes(p) for p in parts)
        u_est = ctx.best(union)
        u_hbm = ctx.hbm_bytes(union)
    else:
        parts_lat = sum(best_estimate(graph, p, hw).latency_s for p in parts)
        parts_hbm = sum(graph.pattern_hbm_bytes(p) for p in parts)
        u_est = best_estimate(graph, union, hw)
        u_hbm = graph.pattern_hbm_bytes(union)
    feasible = u_est.feasible and u_est.schedule in ("onepass", "streaming")
    return StitchGain(
        latency_gain_s=parts_lat - u_est.latency_s,
        hbm_bytes_saved=max(0, parts_hbm - u_hbm),
        feasible=feasible,
        union_schedule=u_est.schedule,
    )


def partition_gain(graph: Graph, partition, hw: Hardware = H100,
                   ctx=None) -> float:
    """Total modeled stitch gain of a whole candidate partition.

    ``partition`` is a sequence of groups, each a sequence of member
    patterns.  This is the quantity the top-k partition search ranks
    candidates by: the sum of ``stitch_gain`` over the stitched groups
    (singleton groups contribute zero; an infeasible group -- which the
    search's repair pass should have split -- contributes zero rather
    than poisoning the ranking with a meaningless negative).
    """
    total = 0.0
    for parts in partition:
        parts = tuple(frozenset(p) for p in parts)
        if len(parts) <= 1:
            continue
        g = (ctx.stitch_gain(parts) if ctx is not None
             else stitch_gain(graph, parts, hw))
        if g.feasible:
            total += g.latency_gain_s
    return total


# ---------------------------------------------------------------------------
# compute-anchored stitching (fusion across the memory/compute divide)
# ---------------------------------------------------------------------------
#: Env switch, the reference's own: ``REPRO_ANCHOR=0`` (or ``off``,
#: ``false``) turns compute-anchored groups off, so anchors stay hard
#: graph breaks.  On by default.
ENV_ANCHOR = "REPRO_ANCHOR"


def anchor_enabled() -> bool:
    return os.environ.get(ENV_ANCHOR, "1").lower() \
        not in ("0", "off", "false")


@dataclass(frozen=True)
class AnchorGain:
    """What folding memory-intensive parts into a compute kernel buys.

    ``hbm_bytes_saved`` is the interface traffic eliminated: every value
    that crosses between a folded part and the anchor (or between two
    folded parts) stops round-tripping HBM -- one store plus one load
    each.  ``latency_gain_s`` adds the launches saved by collapsing the
    parts and the anchor's own launch into one kernel.  ``vmem_bytes``
    is the anchored kernel's on-chip working set (``_anchor_vmem``); a
    group over the budget, or one the device's kernel cannot run, is
    infeasible and stays on the memory-only plan.
    """

    latency_gain_s: float
    hbm_bytes_saved: int
    vmem_bytes: int
    feasible: bool


def anchor_interface_bytes(graph: Graph, anchors, parts) -> int:
    """HBM bytes eliminated on the anchor/part interfaces.

    A value saves its round-trip (2x nbytes: the producer kernel's store
    and the consumer kernel's load) when it is produced inside the union,
    all its consumers are inside the union, it is not a graph output, and
    at least one consumer lives in a *different* sub-part than the
    producer (values internal to one part were already saved by the
    memory-only stitch and must not be double-counted).
    """
    part_of: dict[int, int] = {}
    for pi, p in enumerate(parts):
        for nid in p:
            part_of[nid] = pi
    for ai, a in enumerate(anchors):
        part_of[a] = -1 - ai
    outset = set(graph.outputs)
    saved = 0
    for nid, home in part_of.items():
        if nid in outset:
            continue
        cons = graph.consumers(nid)
        if not cons or any(c not in part_of for c in cons):
            continue
        if any(part_of[c] != home for c in cons):
            saved += 2 * graph.node(nid).nbytes
    return saved


def _anchor_vmem_tpu(graph: Graph, anchors) -> int:
    """The reference's per-grid-step working set (rough): the lhs tile,
    the resident (K, N) panel and the f32 accumulator at block_m 128."""
    total = 0
    for a in anchors:
        node = graph.node(a)
        if node.prim != "dot_general" or len(node.inputs) < 2:
            # attention-call prims / conv: assume flash-style 128-blocks
            total += 4 * 128 * 128 * 4
            continue
        lhs = graph.node(node.inputs[0]).spec
        rhs = graph.node(node.inputs[1]).spec
        K = lhs.shape[-1] if lhs.shape else 1
        N = rhs.shape[-1] if rhs.shape else 1
        bm = 128
        if len(anchors) > 1:
            # attention pair (QK + PV): flash blocks, panels never whole
            total += bm * (K + N) * 4 + bm * bm * 4
        else:
            # matmul: lhs tile (bm, K) + resident rhs panel (K, N)
            # + f32 accumulator tile (bm, N)
            total += bm * K * lhs.itemsize + K * N * rhs.itemsize \
                + bm * N * 4
    return total


#: Types the CUDA chains compute in (the anchored kernels are float32).
_GPU_CHAIN_DTYPES = ("float32", "bool")


def _anchor_vmem_gpu(graph: Graph, anchors, parts) -> int | None:
    """Shared memory of the CUDA instance the emitter would launch, from
    that kernel's own tile constants; None where no instance can run the
    group: a prologue that reduces (the kernel stages the lhs k-tile by
    k-tile, never a whole row of K), an epilogue that reduces over an N
    wider than the row tile or with more reductions than its slots, a
    value outside float32 and bool, or an attention head dim the flash
    kernel has no tuned instance for (above 256 the wide kernel runs,
    which takes no score functor)."""
    from ..kernels import flash_attention as fa
    from ..kernels import matmul as mm

    members = frozenset(n for p in parts for n in p)
    for nid in members | frozenset(
            i for n in members for i in graph.node(n).inputs):
        if graph.node(nid).spec.dtype not in _GPU_CHAIN_DTYPES:
            return None
    if len(anchors) == 2:
        q = graph.node(graph.node(anchors[0]).inputs[0]).spec
        if (q.dtype != "float32" or not q.shape
                or fa.flash_instance(q.shape[-1]) is None):
            return None                  # the wide kernel takes no score_mod
        return fa.flash_smem_bytes(q.shape[-1])
    if len(anchors) != 1:
        return None
    a = anchors[0]
    node = graph.node(a)
    if node.prim != "dot_general" or len(node.inputs) < 2:
        return None
    lhs = graph.node(node.inputs[0]).spec
    rhs = graph.node(node.inputs[1]).spec
    if "float32" != lhs.dtype or "float32" != rhs.dtype:
        return None
    K, N = lhs.shape[-1], rhs.shape[-1]
    M = lhs.size // max(1, K)
    _, anc = graph.reachability()
    reduces = [n for n in members if graph.node(n).kind is OpKind.REDUCE]
    if any((anc[a] >> n) & 1 for n in reduces):
        return None                      # prologue reduction over K
    if reduces and N > mm.TILE_ROW.bn:
        return None                      # the row of N exceeds one block
    if len(reduces) > mm.MAX_SLOTS:
        return None                      # more row reductions than slots
    return mm.TILES[mm.pick_tile(M, N, bool(reduces))].smem_bytes


def _anchor_vmem(graph: Graph, anchors, hw: Hardware,
                 parts=()) -> int | None:
    """On-chip working set of the anchored kernel, None if no kernel of
    the device can run it.  ``tpu``: the reference's formula, unchanged;
    ``gpu``: the CUDA instance's shared memory (``_anchor_vmem_gpu``)."""
    if hw.platform == "gpu":
        return _anchor_vmem_gpu(graph, tuple(anchors), parts)
    return _anchor_vmem_tpu(graph, anchors)


def anchor_gain(graph: Graph, anchors, parts, hw: Hardware = H100,
                ctx=None) -> AnchorGain:
    """Price folding ``parts`` into the compute kernel(s) ``anchors``.

    Unlike ``stitch_gain`` this does not re-price the union schedule --
    the anchored kernel keeps the compute op's own grid and the folded
    chains ride along tile by tile, so the gain is pure interface
    traffic plus launch collapse, gated by the working-set check.
    """
    saved = anchor_interface_bytes(graph, anchors, parts)
    launches_saved = max(0, len(parts) + len(anchors) - 1) \
        * (hw.launch_s + hw.hbm_latency_s)
    vmem = _anchor_vmem(graph, anchors, hw, parts)
    return AnchorGain(
        latency_gain_s=saved / hw.hbm_bw + launches_saved,
        hbm_bytes_saved=saved,
        vmem_bytes=-1 if vmem is None else vmem,
        feasible=vmem is not None and vmem <= hw.anchor_budget,
    )


# ---------------------------------------------------------------------------
# delta-evaluator
# ---------------------------------------------------------------------------
def delta_evaluator(graph: Graph, pattern: frozenset[int],
                    hw: Hardware = H100, ctx=None) -> float:
    """Score f(P) = T_reduced_mem + T_reduced_calls - T_penalty  (§5.4).

    With a ``CostContext`` the boundary sets and rowspec analysis come
    from the per-graph memo instead of being rebuilt per call.
    """
    if len(pattern) == 1:
        return 0.0

    # T_reduced_mem: internal tensors stop round-tripping HBM (1 write +
    # one read per consumer), and shared external inputs are read once.
    saved_bytes = 0
    if ctx is not None:
        b = ctx.bounds(pattern)
        internal_ids, ext_ids = b.internal, b.inputs
    else:
        outset = set(graph.outputs)
        internal_ids = [nid for nid in pattern
                        if nid not in outset and graph.consumers(nid)
                        and all(c in pattern for c in graph.consumers(nid))]
        ext_ids = graph.pattern_inputs(pattern)
    for nid in internal_ids:
        saved_bytes += graph.node(nid).nbytes * (1 + len(graph.consumers(nid)))
    for ext in ext_ids:
        n_in = sum(1 for c in graph.consumers(ext) if c in pattern)
        if n_in > 1:
            saved_bytes += graph.node(ext).nbytes * (n_in - 1)
    t_mem = saved_bytes / hw.hbm_bw

    # T_reduced_calls
    n_kernels = sum(1 for nid in pattern
                    if graph.node(nid).kind in (OpKind.LIGHT_EW, OpKind.EXPENSIVE_EW,
                                                OpKind.REDUCE, OpKind.TRANSPOSE))
    t_calls = max(0, n_kernels - 1) * (hw.launch_s + hw.hbm_latency_s)

    # T_penalty: simplified latency model (paper: fixed regs=16, max shmem,
    # no lifetime analysis).  Here: max per-row scratch w/o sharing, fixed
    # 16-value live set; VMEM overflow and no-row-view both penalize.
    t_penalty = 0.0
    info = ctx.info(pattern) if ctx is not None else analyze(graph, pattern)
    if info is None:
        # not stitchable -> only packing benefits remain; forfeit most of
        # the reuse saving but keep call reduction.
        t_penalty = 0.7 * t_mem
    else:
        Cp = _pad(info.C, 128)
        naive_scratch = 0
        for nid in pattern:
            node = graph.node(nid)
            naive_scratch += role_bytes_per_row(info.roles[nid], Cp,
                                                node.spec.itemsize)
        # fixed live-set of 16 rows (paper's fixed register count analogue)
        est_working = 16 * max(naive_scratch, Cp * 4)
        if est_working > hw.vmem_budget:
            t_penalty += t_mem * min(1.0, est_working / (4 * hw.vmem_budget))
        # expensive ops staged mid-pattern add VPU pressure per consumer
        for nid in info.expensive_nodes:
            cons_in = sum(1 for c in graph.consumers(nid) if c in pattern)
            if cons_in > 1:
                node = graph.node(nid)
                t_penalty += (0.1 * _table_cost(node.prim, hw.platform)
                              * node.spec.size / hw.vpu_ops)

    return t_mem + t_calls - t_penalty
