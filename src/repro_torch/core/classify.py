"""Primitive classification + per-op element cost tables.

Mirrors the paper's three fusible classes (§4): *light element-wise*,
*expensive element-wise*, *reduction*.  The primitive names are the
reference vocabulary ``repro_torch.core.tracer`` lowers aten ops to.

Two cost tables price one element of a primitive:

* ``_VPU_COST`` -- the JAX package's TPU v5e VPU table, kept verbatim so
  the ``V5E`` hardware preset plans a graph exactly as the reference
  does;
* ``_GPU_COST`` -- the Hopper table the ``H100`` preset uses: cost 1.0 is
  one FP32 lane operation (an SM starts 128 a clock); the special
  function unit does 16 a clock, so one MUFU instruction (ex2, rsqrt,
  sin, rcp) costs 8, and IEEE division, which Triton and PyTorch lower to
  a refined reciprocal, costs about as much.  These are instruction-mix
  estimates, not measurements.
"""
from __future__ import annotations

from .ir import OpKind

# --------------------------------------------------------------------------
# primitive name -> OpKind
# --------------------------------------------------------------------------
# div / integer_pow / rem are classified light for *fusion legality* (XLA
# duplicates them freely, and the paper's expensive set is transcendental:
# "reduction, tan, log, et al."); their VPU *cost* stays elevated below.
_LIGHT = {
    "add", "sub", "mul", "neg", "abs", "max", "min", "and", "or", "xor",
    "not", "eq", "ne", "ge", "gt", "le", "lt", "select_n", "sign",
    "floor", "ceil", "round", "clamp", "shift_left", "shift_right_logical",
    "shift_right_arithmetic", "rem", "convert_element_type", "bitcast_convert_type",
    "copy", "stop_gradient", "is_finite", "nextafter", "real", "imag",
    "square", "div", "integer_pow",
    # data-movement ops the paper treats as memory-intensive and fusible
    # (they join *packed* patterns; the row-stitched Pallas emitter skips
    # them via EMITTABLE_PRIMS): RoPE et al. stop costing a kernel each.
    "concatenate", "slice", "iota", "pad", "rev",
}
_EXPENSIVE = {
    "exp", "exp2", "expm1", "log", "log2", "log1p", "tanh", "sin", "cos",
    "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh", "asinh",
    "acosh", "atanh", "logistic", "erf", "erfc", "erf_inv", "rsqrt",
    "sqrt", "cbrt", "pow", "digamma", "lgamma",
}
_REDUCE = {
    "reduce_sum", "reduce_max", "reduce_min", "reduce_prod",
    "reduce_and", "reduce_or",
}
_BROADCAST = {"broadcast_in_dim"}
_RESHAPE = {"reshape", "squeeze", "expand_dims"}
_TRANSPOSE = {"transpose"}

# Compute-intensive MXU ops: never plain pattern members, but not plain
# graph breaks either -- the stitcher may open a group *around* one and
# fold adjacent memory-intensive chains into its kernel body (epilogue
# fusion / folded attention score chains).  Custom fused-attention call
# prims land here too so a traced model that routes through them is
# priced as compute, not as the default elementwise bucket.
_ANCHOR = {
    "dot_general", "conv_general_dilated",
    "scaled_dot_product_attention", "flash_attention",
}

# Cross-shard data movement: collectives bound to mesh axes (traced via
# ``axis_env`` for per-shard functions) plus GSPMD resharding points.
# Hard stitch boundaries -- a kernel cannot span a network transfer --
# but distinct from OPAQUE so the stitcher can count them and the beam
# can deliberately fold the flanking elementwise chains into the
# neighboring groups (FlashFuser's inter-core expansion, inverted:
# fuse *up to* the wire, never across it).
_COLLECTIVE = {
    "psum", "pmax", "pmin", "all_gather", "reduce_scatter", "all_to_all",
    "ppermute", "pbroadcast", "axis_index", "sharding_constraint",
}

# Everything else (gather, scatter, cumsum, sort, dynamic_slice, rng,
# while/scan/cond, argmax, ...) is OPAQUE: a hard fusion boundary,
# exactly like ops the paper's code generator cannot stitch.


def classify(prim_name: str) -> OpKind:
    if prim_name in _LIGHT:
        return OpKind.LIGHT_EW
    if prim_name in _EXPENSIVE:
        return OpKind.EXPENSIVE_EW
    if prim_name in _REDUCE:
        return OpKind.REDUCE
    if prim_name in _BROADCAST:
        return OpKind.BROADCAST
    if prim_name in _RESHAPE:
        return OpKind.RESHAPE
    if prim_name in _TRANSPOSE:
        return OpKind.TRANSPOSE
    if prim_name in _ANCHOR:
        return OpKind.ANCHOR
    if prim_name in _COLLECTIVE:
        return OpKind.COLLECTIVE
    return OpKind.OPAQUE


# --------------------------------------------------------------------------
# VPU cost multipliers (CPI-table analogue).  Unit: vector-ALU-op equivalents
# per element.  Calibrated against public TPU microbenchmarks: transcendental
# ops cost ~10-20 vector ops on the VPU's slow path.
# --------------------------------------------------------------------------
_VPU_COST: dict[str, float] = {
    # light
    **{p: 1.0 for p in _LIGHT},
    "convert_element_type": 0.5,
    "copy": 0.0,
    "stop_gradient": 0.0,
    # expensive
    "div": 4.0,
    "rem": 4.0,
    "sqrt": 8.0,
    "rsqrt": 8.0,
    "cbrt": 12.0,
    "exp": 14.0, "exp2": 12.0, "expm1": 16.0,
    "log": 14.0, "log2": 12.0, "log1p": 16.0,
    "logistic": 16.0,
    "tanh": 16.0, "sinh": 18.0, "cosh": 18.0,
    "erf": 18.0, "erfc": 18.0, "erf_inv": 24.0,
    "sin": 20.0, "cos": 20.0, "tan": 24.0,
    "asin": 24.0, "acos": 24.0, "atan": 24.0, "atan2": 28.0,
    "asinh": 24.0, "acosh": 24.0, "atanh": 24.0,
    "pow": 24.0, "integer_pow": 3.0,
    "digamma": 40.0, "lgamma": 40.0,
    # reduction: cost per *input* element
    **{p: 1.0 for p in _REDUCE},
    # layout
    "broadcast_in_dim": 0.25,
    "reshape": 0.0, "squeeze": 0.0, "expand_dims": 0.0,
    "transpose": 1.0,
    # compute anchors: per *output* element cost of the VPU-visible work
    # (the MXU does the contraction; these keep a union that sees an
    # anchor from being priced as one light elementwise op per element).
    "dot_general": 32.0,
    "conv_general_dilated": 32.0,
    "scaled_dot_product_attention": 64.0,
    "flash_attention": 64.0,
    # collectives: the wire dominates, not the VPU; a nominal per-element
    # cost keeps them from pricing as free while the boundary rule (not
    # this number) is what actually keeps them out of kernels.
    **{p: 2.0 for p in _COLLECTIVE},
    "axis_index": 0.0,
    "sharding_constraint": 0.0,
}


def vpu_cost(prim_name: str) -> float:
    """Vector-op-equivalents per element for ``prim_name`` (default 1.0)."""
    return _VPU_COST.get(prim_name, 1.0)


_MUFU = 8.0  # one special-function-unit op, in FP32 lane-op slots

_GPU_COST: dict[str, float] = {
    **{p: 1.0 for p in _LIGHT},
    "copy": 0.0,
    "stop_gradient": 0.0,
    "div": _MUFU + 2.0, "rem": _MUFU + 4.0,
    "integer_pow": 2.0,
    "sqrt": _MUFU, "rsqrt": _MUFU, "cbrt": 2 * _MUFU,
    "exp": _MUFU + 1.0, "exp2": _MUFU, "expm1": _MUFU + 2.0,
    "log": _MUFU + 1.0, "log2": _MUFU, "log1p": _MUFU + 2.0,
    "logistic": 2 * _MUFU + 2.0,
    "tanh": 2 * _MUFU + 2.0, "sinh": 2 * _MUFU + 2.0, "cosh": 2 * _MUFU + 2.0,
    "erf": 3 * _MUFU, "erfc": 3 * _MUFU, "erf_inv": 4 * _MUFU,
    "sin": _MUFU, "cos": _MUFU, "tan": 2 * _MUFU + 2.0,
    "asin": 4 * _MUFU, "acos": 4 * _MUFU, "atan": 4 * _MUFU,
    "atan2": 5 * _MUFU, "asinh": 4 * _MUFU, "acosh": 4 * _MUFU,
    "atanh": 4 * _MUFU,
    "pow": 3 * _MUFU,
    "digamma": 8 * _MUFU, "lgamma": 8 * _MUFU,
    **{p: 1.0 for p in _REDUCE},
    "broadcast_in_dim": 0.0,   # a register broadcast, no instruction
    "reshape": 0.0, "squeeze": 0.0, "expand_dims": 0.0,
    "transpose": 2.0,
    "dot_general": 2.0, "conv_general_dilated": 2.0,
    "scaled_dot_product_attention": 4.0, "flash_attention": 4.0,
    **{p: 2.0 for p in _COLLECTIVE},
    "axis_index": 0.0,
    "sharding_constraint": 0.0,
}


def gpu_cost(prim_name: str) -> float:
    """FP32-lane-op equivalents per element on Hopper (default 1.0)."""
    return _GPU_COST.get(prim_name, 1.0)


def op_cost(prim_name: str, platform: str) -> float:
    """Per-element cost of ``prim_name`` on ``platform`` ("tpu": the VPU
    table, "gpu": the Hopper table)."""
    return gpu_cost(prim_name) if platform == "gpu" else vpu_cost(prim_name)
