"""FusionStitching core: trace -> plan -> stitch -> generated kernels, with
the persistent plan cache and measured tuning; ``stitched_jit(...,
differentiable=True)`` stitches the backward too."""
from .costctx import CostContext
from .cost_model import H100, V5E, Hardware, best_estimate, \
    delta_evaluator, partition_gain, stitch_gain
from .ir import FusionPlan, Graph, Node, OpKind, Pattern, StitchGroup
from .plan_cache import PlanCache, graph_signature
from .planner import make_plan, plan_stats
from .stitch import DifferentiableStitched, StitchedFunction, \
    StitchReport, fusion_report, stitched_jit
from .stitcher import PartitionCandidate, StitchStats, TopKResult, \
    make_groups, search_groups
from .tracer import check_lowerings, trace, trace_with_tree

__all__ = [
    "CostContext",
    "H100", "V5E", "Hardware", "best_estimate", "delta_evaluator",
    "partition_gain", "stitch_gain",
    "FusionPlan", "Graph", "Node", "OpKind", "Pattern", "StitchGroup",
    "PlanCache", "graph_signature",
    "make_plan", "plan_stats",
    "DifferentiableStitched", "StitchedFunction", "StitchReport",
    "fusion_report", "stitched_jit",
    "PartitionCandidate", "StitchStats", "TopKResult",
    "make_groups", "search_groups",
    "check_lowerings", "trace", "trace_with_tree",
]
