"""Wrappers the benchmark lays around what the program's own loops call.

Each wraps a callable where its caller looks it up (a module attribute,
a class attribute, or an argument the caller is handed) and restores it
on exit.  They record what a check or a metric needs and time spans; the
program's code is not touched.  ``Taps.close`` undoes every patch.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch


class Taps:
    """A set of patches, undone by :meth:`close`."""

    def __init__(self):
        self._undo: List[Callable[[], None]] = []

    def patch(self, owner: Any, name: str, make: Callable[[Any], Any]):
        """Replace ``owner.name`` by ``make(original)``."""
        original = getattr(owner, name)
        setattr(owner, name, make(original))
        self._undo.append(lambda: setattr(owner, name, original))
        return original

    def close(self):
        while self._undo:
            self._undo.pop()()


def record_kernel_launches(taps: Taps, tracer):
    """Record each K1/K2 launch's shape (rows, segments, features, bytes
    an element) with the tracer, and count CUDA graph captures and
    replays, so that the launches of the profiled part are known."""
    from alignn_tpu_torch.ops import eggc

    def launcher(kind):
        def make(original):
            def wrapped(x, *args):
                seg = args[-1]
                tracer.record_launch(kind, int(x.shape[0]), int(seg.num),
                                     int(x.shape[1]), x.element_size())
                return original(x, *args)
            wrapped.launches = original.launches
            return wrapped
        return make

    taps.patch(eggc, "gated_aggregate_cuda", launcher("K1"))
    taps.patch(eggc, "sorted_segment_sum_cuda", launcher("K2"))
    graph_cls = torch.cuda.CUDAGraph

    def begin(original):
        def wrapped(self, *a, **kw):
            tracer.capturing = id(self)
            tracer.graph_records[id(self)] = []
            return original(self, *a, **kw)
        return wrapped

    def end(original):
        def wrapped(self, *a, **kw):
            out = original(self, *a, **kw)
            tracer.capturing = None
            return out
        return wrapped

    def replay(original):
        def wrapped(self, *a, **kw):
            if tracer.profiling:
                tracer.replays[id(self)] += 1
            return original(self, *a, **kw)
        return wrapped

    taps.patch(graph_cls, "capture_begin", begin)
    taps.patch(graph_cls, "capture_end", end)
    taps.patch(graph_cls, "replay", replay)


class LoaderTap:
    """A training loader as ``train_model`` sees it, with hooks: each
    ``next()`` is timed as the span `span` (batch wait), ``set_epoch`` and
    the end of a whole pass call back.  Everything else is the loader's."""

    def __init__(self, loader, tracer, span: str,
                 on_epoch=None, on_pass_end=None):
        self._loader = loader
        self._tracer = tracer
        self._span = span
        self._on_epoch = on_epoch
        self._on_pass_end = on_pass_end

    def __getattr__(self, name):
        return getattr(self._loader, name)

    def __len__(self):
        return len(self._loader)

    def set_epoch(self, epoch: int):
        self._loader.set_epoch(epoch)
        if self._on_epoch is not None:
            self._on_epoch(epoch)

    def __iter__(self):
        inner = iter(self._loader)
        try:
            while True:
                with self._tracer.span(self._span):
                    try:
                        batch = next(inner)
                    except StopIteration:
                        break
                yield batch
            if self._on_pass_end is not None:
                self._on_pass_end()
        finally:
            close = getattr(inner, "close", None)
            if close is not None:
                close()
