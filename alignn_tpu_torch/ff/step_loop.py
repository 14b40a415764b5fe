"""A device-resident step loop, replayed as a CUDA graph on the card.

The on-device MD and relaxation loops (:mod:`~alignn_tpu_torch.ff.md_jit`,
:mod:`~alignn_tpu_torch.ff.relax_jit`) keep their whole state in tensors on
the device and advance it with one step function that reads and writes
those tensors in place.  The JAX package runs a chunk of steps as one
``lax.scan`` inside one ``jit``; here the step is captured once with
``torch.cuda.CUDAGraph`` and replayed once per step of the chunk, so a
step costs one graph launch instead of the ~1,500-2,000 eager launches of
a forward and its gradient.

A captured graph has fixed launch sizes and fixed tensor addresses.  The
segment kernels (K1, K2) size their grids and their ``partial`` buffers by
``Segments.num_items``, which depends on the graph's data: the loops
pad every batch's segments to the most items their bucket can need
(:func:`with_item_capacity`), so that the launch sizes depend on the
bucket alone.  A loop is reused only for a batch whose
:func:`batch_signature` (every tensor's shape and dtype, every integer:
``num``, ``num_items``, ``dense_D``, the windows) equals that of the batch
it was captured with; the new batch's index tensors are then copied into
the captured ones (:meth:`StepLoop.load_batch`).  Otherwise the caller
builds a new loop, which captures again.

Capture follows PyTorch's rules for CUDA graphs: the step runs on a side
stream first (the loop's first :data:`WARMUP_STEPS` steps, real steps of
the run, so the capture costs only its recording), and nothing in it may
synchronise with the host.  A capture error, or a launch error at replay,
raises: nothing falls back to the eager loop.  ``cuda_graph=False`` runs
the same step eagerly, and so does every loop on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

WARMUP_STEPS = 2   # eager steps on a side stream before the capture


def batch_leaves(batch) -> Tuple[List[torch.Tensor], tuple]:
    """(every tensor of a GraphBatch, in field order through its nested
    Incidence and Segments; the batch's signature: each tensor's name,
    shape and dtype and each other field's value)."""
    tensors: List[torch.Tensor] = []
    sig: list = []

    def walk(obj, prefix: str):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            name = prefix + f.name
            if isinstance(v, torch.Tensor):
                tensors.append(v)
                sig.append((name, tuple(v.shape), v.dtype))
            elif dataclasses.is_dataclass(v):
                walk(v, name + ".")
            else:
                sig.append((name, v))

    walk(batch, "")
    return tensors, tuple(sig)


def with_item_capacity(batch):
    """`batch` with every ``Segments`` padded to the most work items its
    length and segment count allow (``Segments.max_items``): the same
    sums, with launch sizes that depend on the bucket only."""
    def stage(inc):
        if inc is None:
            return None
        return dataclasses.replace(
            inc, src_sorted=inc.src_sorted.with_capacity(
                inc.src_sorted.max_items()),
            dst=None if inc.dst is None else inc.dst.with_capacity(
                inc.dst.max_items()))

    return dataclasses.replace(batch, g_index=stage(batch.g_index),
                               lg_index=stage(batch.lg_index))


def batch_signature(batch) -> tuple:
    """What a captured step depends on besides tensor contents."""
    return batch_leaves(batch)[1]


class StepLoop:
    """Runs ``step()`` over static tensors, replayed as a CUDA graph.

    `batch` is the GraphBatch the step reads (its tensors become the
    captured ones); the step reads and writes its state in place.
    `generators` are the random generators the step draws from: each is
    registered with the graph, so that every replay draws fresh numbers.
    """

    captures = 0   # graphs captured in this process (read by chip_smoke)

    def __init__(self, step: Callable[[], None], batch,
                 generators: Sequence[torch.Generator] = (),
                 cuda_graph: bool = True):
        self.step = step
        self.batch = batch
        self._leaves, self.signature = batch_leaves(batch)
        self.generators = list(generators)
        self.device = self._leaves[0].device
        self.use_graph = bool(cuda_graph) and self.device.type == "cuda"
        self.warmed = 0                  # steps run before the capture
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    def load_batch(self, batch):
        """Copy `batch`'s tensors into the loop's own (same signature)."""
        leaves, sig = batch_leaves(batch)
        if sig != self.signature:
            raise ValueError("batch signature differs from the captured "
                             "one: build a new StepLoop")
        for dst, src in zip(self._leaves, leaves):
            dst.copy_(src)

    def _warm_up(self, n: int):
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(n):
                self.step()
        main.wait_stream(side)
        self.warmed += n

    def _capture(self):
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        with torch.cuda.graph(graph):
            self.step()
        self.graph = graph
        StepLoop.captures += 1

    def run(self, n: int):
        """Advance the state by `n` steps."""
        if not self.use_graph:
            for _ in range(n):
                self.step()
            return
        if self.graph is None:
            warm = min(n, WARMUP_STEPS - self.warmed)
            if warm > 0:
                self._warm_up(warm)
                n -= warm
            if n == 0:
                return
            self._capture()
        for _ in range(n):
            self.graph.replay()
