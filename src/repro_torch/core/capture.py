"""One dispatch per step: a step captured once as a CUDA graph, then
replayed.

The counterpart of the reference compiling a whole schedule into one
``jax.jit`` dispatch (``src/repro/core/stitch.py:28-36, 198-200``).  A
stitched call captures its own schedule once its input addresses repeat
(``core/stitch.py``); a model's compiled functions run theirs directly
(``stitch.run_directly``), layer by layer, so a decode step of
Llama-3.2-3B is hundreds of launches whose host cost exceeds their
device time.
``CapturedStep`` records a whole step's launches once and replays them
with one call: a decode step or wave, the scheduler's prefill of a
bucket.

    step = CapturedStep(lambda tok, pos: ..., restore=state)
    out = step(tok, pos)      # 1st call: warm up, capture, replay
    out = step(tok2, pos2)    # then: copy the inputs in, replay

The first call follows ``torch.cuda.graph``'s rules: ``fn`` runs eagerly
``WARMUP`` times on a side stream -- every ``nvcc`` build, generated
kernel, Triton compile and trace of a compiled function happens there,
none during the capture, and a stitched call inside captures no graph
of its own (``_build.warming``) -- then one call is captured into a
graph whose allocations (a kernel wrapper's outputs and scratch) come
from the graph's own memory pool, and the graph is replayed for the
call.  The
inputs are the graph's static tensors: each later call copies its
tensors (or fills its ints) into them.  Everything else ``fn``
reads -- weights, the cache written in place -- is read at the addresses
it had at capture, so it must stay where it is: updated in place, never
replaced.

A warm-up run is a real run: it writes the cache.  The KV rows a decode
step writes, the replay writes again with the same values before it
reads them; the tensors in ``restore`` (the Mamba layers' states, which
a step advances from their own values) are saved before the warm-up and
put back before the capture, so the replay advances them once.

A failed capture raises (a host sync, an allocation the graph cannot
take, a launch the capture refuses): there is no eager fallback.  The
outputs are the graph's own tensors, overwritten by the next call.
Steps given one ``pool`` (``torch.cuda.graph_pool_handle()``) allocate
from one memory pool: a replay may overwrite another step's outputs, so
each replay's outputs are read before the next replay of any of them.

Kernel wrappers count their launches in Python (``kernels/_build.py::
count``); a replay runs no Python, so the launches recorded at capture
are counted once a replay, in the same counters.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
from torch.utils import _pytree as pytree

from ..kernels import _build


#: Eager runs before a capture: the first builds and compiles, the second
#: runs as every later call does.
WARMUP = 2


class CapturedStep:
    """``fn(*inputs) -> outputs`` (a pytree of CUDA tensors), captured at
    its first call and replayed at each call."""

    def __init__(self, fn: Callable, *, restore: Sequence = (),
                 pool=None):
        self.fn = fn
        self.restore = list(restore)
        #: the memory pool the graph allocates from (``graph_pool_handle``;
        #: None: a pool of its own)
        self.pool = pool
        #: device memory the capture reserved for the pool
        self.pool_bytes = 0
        self.graph: torch.cuda.CUDAGraph | None = None
        self.inputs: list[torch.Tensor] = []
        self.outputs: Any = None
        #: {counter owner: launches} recorded into the graph
        self.kernels: dict = {}
        self.replays = 0

    def __call__(self, *inputs):
        if self.graph is None:
            self._capture(inputs)
        else:
            if len(inputs) != len(self.inputs):
                raise ValueError(f"captured step: {len(inputs)} inputs, "
                                 f"captured with {len(self.inputs)}")
            for buf, x in zip(self.inputs, inputs):
                if isinstance(x, torch.Tensor):
                    if x.shape != buf.shape:
                        raise ValueError(
                            f"captured step: input of shape "
                            f"{tuple(x.shape)}, captured at "
                            f"{tuple(buf.shape)}")
                    buf.copy_(x)
                else:
                    buf.fill_(x)  # an int: a fill, no copy from the host
        self.graph.replay()
        self.replays += 1
        _build.add_replayed(self.kernels)
        return self.outputs

    @staticmethod
    def _static(x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            if x.device.type != "cuda":
                raise ValueError(f"captured step: input on {x.device}; a "
                                 "captured step takes CUDA tensors")
            return x.clone()
        if not isinstance(x, int):
            raise TypeError(f"captured step: an input is a tensor or an "
                            f"int, got {type(x).__name__}")
        return torch.full((), x, dtype=torch.int64, device="cuda")

    def _capture(self, inputs) -> None:
        self.inputs = [self._static(x) for x in inputs]
        saved = [t.clone() for t in self.restore]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        _build.warming += 1
        try:
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    self.fn(*self.inputs)
                for t, s in zip(self.restore, saved):
                    t.copy_(s)
        finally:
            _build.warming -= 1
        torch.cuda.current_stream().wait_stream(side)
        del saved
        # the graph's cudaGraph_t is kept (``raw_cuda_graph``) for whoever
        # inspects its nodes and edges
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if _build.capturing is not None:
            raise RuntimeError("captured step: another capture is running")
        _build.capturing = {}
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                # read inside: entering empties the allocator's cache
                reserved = torch.cuda.memory_reserved()
                outputs = self.fn(*self.inputs)
        finally:
            tally, _build.capturing = _build.capturing, None
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        if not all(isinstance(t, torch.Tensor)
                   for t in pytree.tree_leaves(outputs)):
            raise TypeError("captured step: outputs must be tensors")
        graph.instantiate()
        self.graph, self.outputs, self.kernels = graph, outputs, tally


def graphed(fn: Callable, device, *, restore: Sequence = (),
            pool=None) -> Callable:
    """``fn`` as a ``CapturedStep`` on a CUDA device; on the CPU ``fn``
    itself, run eagerly (its outputs are then new tensors at each
    call)."""
    if torch.device(device).type == "cuda":
        return CapturedStep(fn, restore=restore, pool=pool)
    return fn


def leaf_signature(*trees) -> tuple:
    """The addresses, shapes and dtypes of the tensors in ``trees``: a
    captured step stays valid while its tensors keep them."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                 for t in pytree.tree_leaves(trees)
                 if isinstance(t, torch.Tensor))
