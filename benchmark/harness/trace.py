"""Spans, counters and the device trace of a ``--trace 1`` run.

Spans are opened by the benchmark's own wrappers around what the
program's loops call (``taps.py``); each is timed on the host clock and,
while the profiler runs, also recorded as a ``record_function`` range so
that it lies on the profiler's clock beside the device's operations.

The device trace is ``torch.profiler`` (CUPTI) over a stated steady part
of the window.  It starts and ends with the device idle, and its length
is measured on the device's own clock, from its first device event to
its last (the host's clock meets the device's only to within
milliseconds).  From the trace: every kernel, copy and fill on the
device, their union (busy seconds), the idle gaps between them named by
the innermost benchmark span the host was in, and the launches of the
program's K1 and K2 (``segment_kernel<..., true>`` / ``<...,
false>``).

K1/K2 launch shapes come from wrappers of the program's launchers,
``ops.eggc.gated_aggregate_cuda`` and ``sorted_segment_sum_cuda``: a call
made while a CUDA graph is being captured belongs to that graph and is
repeated by each of its replays, which the wrapped
``torch.cuda.CUDAGraph.replay`` counts; a call made eagerly while the
profiler runs is one launch.
"""

from __future__ import annotations

import re
import time
from collections import Counter, defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import torch

K_PATTERNS = (("K1", re.compile(r"segment_kernel<[^>]*, true>")),
              ("K2", re.compile(r"segment_kernel<[^>]*, false>")))
SPAN_NAMES = ("graph_rebuild", "batch_wait", "step_call", "loss_fetch",
              "validation", "chunk_run")


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()




def kernel_kind(name: str) -> Optional[str]:
    for kind, pat in K_PATTERNS:
        if pat.search(name):
            return kind
    return None


class Tracer:
    """Host spans and counters always; the profiler and the launch
    records only where ``traced``."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.spans: Dict[str, float] = defaultdict(float)   # name -> s
        self.profiling = False
        self.prof = None
        self.window_ns: Tuple[int, int] = (0, 0)
        self.device_ops: List[Tuple[str, int, int]] = []
        self.annotations: List[Tuple[str, int, int]] = []
        # K1/K2 launch records
        self.graph_records: Dict[int, list] = defaultdict(list)
        self.capturing: Optional[int] = None
        self.replays: Counter = Counter()
        self.eager_records: list = []
        self.profiled_captures = 0

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        if self.profiling:
            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self.spans[name] += time.perf_counter() - t0

    # --- the profiler ------------------------------------------------------
    def warm_up(self):
        """Start and stop the profiler once in set-up, so that its one-time
        start (CUPTI's) does not fall into the profiled part."""
        if self.traced:
            self.start()
            self.stop()
            self.device_ops.clear()
            self.annotations.clear()

    def start(self):
        if not self.traced or self.profiling:
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        _sync()
        self.prof = profile(activities=activities)
        self.prof.start()
        _sync()
        self.window_ns = (time.time_ns(), 0)
        self.profiling = True

    def stop(self):
        if not self.profiling:
            return
        _sync()
        self.window_ns = (self.window_ns[0], time.time_ns())
        self.profiling = False
        self.prof.stop()
        for ev in self.prof.profiler.kineto_results.events():
            start, end = ev.start_ns(), ev.end_ns()
            on_device = ev.device_type() == torch.autograd.DeviceType.CUDA
            if ev.is_user_annotation():
                # a span's range; the profiler mirrors it on the device's
                # timeline too, where it is no operation
                if not on_device and ev.name() in SPAN_NAMES:
                    self.annotations.append((ev.name(), start, end))
            elif on_device:
                self.device_ops.append((ev.name(), start, end))
        self.prof = None
        if self.device_ops:
            # the profiled part on the device's clock
            self.window_ns = (min(s for _n, s, _e in self.device_ops),
                              max(e for _n, _s, e in self.device_ops))

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for _name, s, e in sorted(self.device_ops, key=lambda x: x[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Every idle gap of the profiled part, longest first, named by
        the innermost benchmark span around its middle ("outside" where
        none is)."""
        busy = self.busy_intervals()
        lo, hi = self.window_ns
        edges = [lo]
        for s, e in busy:
            edges += [s, e]
        edges.append(hi)
        gaps = []
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            mid = (s + e) // 2
            inner = [(a_e - a_s, n) for n, a_s, a_e in self.annotations
                     if a_s <= mid <= a_e]
            gaps.append((min(inner)[1] if inner else "outside",
                         (e - s) / 1e9))
        return sorted(gaps, key=lambda g: -g[1])

    def top_device_ops(self, k: int = 10) -> List[Tuple[str, float]]:
        total: Dict[str, float] = defaultdict(float)
        for name, s, e in self.device_ops:
            total[name] += (e - s) / 1e9
        return sorted(total.items(), key=lambda x: -x[1])[:k]

    def breakdown(self) -> dict:
        return {"device_ops": [[n, s] for n, s in self.top_device_ops()],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps()[:10]]}

    # --- K1/K2 launches ----------------------------------------------------
    def record_launch(self, kind: str, rows: int, segments: int,
                      features: int, itemsize: int):
        rec = (kind, rows, segments, features, itemsize)
        if self.capturing is not None:
            if self.profiling and not self.graph_records[self.capturing]:
                self.profiled_captures += 1
            self.graph_records[self.capturing].append(rec)
        elif self.profiling:
            self.eager_records.append(rec)

    def expected_launches(self) -> list:
        """The K1/K2 launches of the profiled part, from the records."""
        out = list(self.eager_records)
        for graph, n in self.replays.items():
            out += self.graph_records.get(graph, []) * n
        return out

    def launch_summary(self) -> str:
        """The records behind a prediction, for a message."""
        eager = Counter(r[0] for r in self.eager_records)
        graphs = {g: (dict(Counter(r[0] for r in self.graph_records[g])), n)
                  for g, n in self.replays.items()}
        return (f"eager {dict(eager)}; graphs replayed (launches a replay, "
                f"replays): {list(graphs.values())}; captured while "
                f"profiling {self.profiled_captures}")

    def profiled_kernels(self) -> Dict[str, List[float]]:
        """{K1/K2: [device seconds of each launch]} in the profiled part."""
        out: Dict[str, List[float]] = {"K1": [], "K2": []}
        for name, s, e in self.device_ops:
            kind = kernel_kind(name)
            if kind:
                out[kind].append((e - s) / 1e9)
        return out
