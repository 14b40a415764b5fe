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

:class:`CompiledStep` is the trainer's counterpart of ``jax.jit``'s cache
(``train/state.py``): a step function of one batch, with one
:class:`StepLoop` per batch signature.  The batch's segments are first
padded to their item capacity (:func:`with_item_capacity`), so that its
signature is its bucket's and its gather windows' (which the loader
floors, as JAX's does to bound its recompiles); the batch is then copied
into that signature's own batch; the first :data:`WARMUP_STEPS` sightings of a signature run
eagerly on a side stream, the next captures the graph, and every later
one replays it.  The step's outputs come back copied out of the graph's
static tensors, so a replay of another graph of the same memory pool
cannot overwrite them.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from alignn_tpu_torch import DEVICE_WORK_LOCK
from alignn_tpu_torch.tracing import span

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


def clone_batch(batch):
    """A copy of `batch` with tensors of its own (nested dataclasses
    copied field by field)."""
    def copy(obj):
        if isinstance(obj, torch.Tensor):
            return obj.clone()
        if dataclasses.is_dataclass(obj):
            return dataclasses.replace(obj, **{
                f.name: copy(getattr(obj, f.name))
                for f in dataclasses.fields(obj) if f.init})
        return obj

    return copy(batch)


def map_tensors(fn: Callable[[torch.Tensor], Any], out):
    """`out` (a tensor, or dicts, lists and tuples of them) with `fn`
    applied to each tensor."""
    if isinstance(out, torch.Tensor):
        return fn(out)
    if isinstance(out, dict):
        return {k: map_tensors(fn, v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(map_tensors(fn, v) for v in out)
    return out


_SIDE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    """One side stream per device for every loop's eager warm-up steps
    (each new stream would hold a cuBLAS workspace of its own)."""
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


class StepLoop:
    """Runs ``step()`` over static tensors, replayed as a CUDA graph.

    `batch` is the GraphBatch the step reads (its tensors become the
    captured ones); the step reads and writes its state in place.
    `generators` are the random generators the step draws from: each is
    registered with the graph, so that every replay draws fresh numbers.
    `pool` is a memory pool (``torch.cuda.graph_pool_handle()``) shared
    with other loops' graphs, or None for a pool of the graph's own.
    The step may return outputs (tensors, or dicts, lists and tuples of
    them); :meth:`run` returns those of the last step.  `name` prefixes
    the loop's spans (``<name>.eager``, ``.capture``, ``.replay``;
    :mod:`alignn_tpu_torch.tracing`).
    """

    captures = 0   # graphs captured in this process (read by chip_smoke)

    def __init__(self, step: Callable[[], Any], batch,
                 generators: Sequence[torch.Generator] = (),
                 cuda_graph: bool = True, pool=None,
                 name: str = "step_loop"):
        self.step = step
        self.batch = batch
        self._leaves, self.signature = batch_leaves(batch)
        self.generators = list(generators)
        self.device = self._leaves[0].device
        self.use_graph = bool(cuda_graph) and self.device.type == "cuda"
        self.pool = pool
        self.warmed = 0                  # steps run before the capture
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static_out: Any = None      # the captured step's outputs
        self.capture_ms = 0.0            # host ms the capture took
        self._spans = tuple(f"{name}.{what}"
                            for what in ("eager", "capture", "replay"))

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
        side = _side_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(n):
                out = self.step()
        main.wait_stream(side)
        # the outputs were made on the side stream and are read on main
        map_tensors(lambda t: t.record_stream(main), out)
        self.warmed += n
        return out

    def _capture(self):
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        t = time.perf_counter()
        # no helper thread (the loader's prefetch) issues device work
        # while the graph records; the capture's error mode stays
        # "global", so any that did would raise
        with DEVICE_WORK_LOCK:
            with torch.cuda.graph(graph, pool=self.pool):
                self.static_out = self.step()
        self.capture_ms = (time.perf_counter() - t) * 1e3
        self.graph = graph
        StepLoop.captures += 1

    def run(self, n: int):
        """Advance the state by `n` steps; returns the last step's
        outputs (a replay's copied out of the graph's static tensors)."""
        eager, capture, replay = self._spans
        if not self.use_graph:
            out = None
            with span(eager):
                for _ in range(n):
                    out = self.step()
            return out
        if self.graph is None:
            warm = min(n, WARMUP_STEPS - self.warmed)
            out = None
            if warm > 0:
                with span(eager):
                    out = self._warm_up(warm)
                n -= warm
            if n == 0:
                return out
            with span(capture):
                self._capture()
        with span(replay):
            for _ in range(n):
                self.graph.replay()
            return map_tensors(torch.clone, self.static_out)


_POOLS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class CompiledStep:
    """``fn(batch) -> outputs`` compiled per batch signature, the
    counterpart of ``jax.jit``'s cache: one :class:`StepLoop` per
    signature of :func:`with_item_capacity`, each over a batch of its own that
    every later batch of the signature is copied into.

    The graphs of every CompiledStep made with the same `pool_key` (the
    train and eval steps of one model) share one memory pool.  On the
    CPU the loops run `fn` eagerly over the same static batches.  `name`
    prefixes the spans of the step and its loops (``<name>.prepare``, and
    :class:`StepLoop`'s).
    """

    def __init__(self, fn: Callable[[Any], Any], pool_key: Any = None,
                 name: str = "step"):
        self.fn = fn
        self.pool_key = pool_key
        self.name = name
        self._prepare_span = f"{name}.prepare"
        self.loops: Dict[tuple, StepLoop] = {}

    def _pool(self, device: torch.device):
        if device.type != "cuda" or self.pool_key is None:
            return None
        pool = _POOLS.get(self.pool_key)
        if pool is None:
            pool = _POOLS[self.pool_key] = torch.cuda.graph_pool_handle()
        return pool

    def clear(self):
        """Drop every signature's loop and graph."""
        self.loops.clear()

    @property
    def captures(self) -> int:
        return sum(loop.graph is not None for loop in self.loops.values())

    def __call__(self, batch):
        with span(self._prepare_span):
            batch = with_item_capacity(batch)
            sig = batch_signature(batch)
            loop = self.loops.get(sig)
            if loop is None:
                # the loop's step holds no reference back to this object,
                # so that dropping the step frees its graphs at once
                fn, own = self.fn, clone_batch(batch)
                loop = StepLoop(lambda: fn(own), own,
                                pool=self._pool(own.z.device),
                                name=self.name)
                self.loops[sig] = loop
            else:
                loop.load_batch(batch)
        return loop.run(1)
