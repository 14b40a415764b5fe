"""The arithmetic of the metrics that read the program's own spans.

The program records a span's interval (``alignn_tpu_torch.tracing``)
while a profiler session records, stamped with ``time.time_ns()``: the
clock of the profiler's events.  So the intervals lie over the device's
operations of the profiled part (``trace.Tracer.device_ops``, clipped to
``Tracer.window_ns``) as they are.  Device idle is the profiled part
minus the union of those operations.

A program without the spans (no ``tracing`` module, or nothing recorded)
gives None, and the harness then leaves the metric out.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from harness.cell import Outcome

Span = Tuple[int, int]   # (start_ns, end_ns)

STEP_CHILDREN = ("train_step.eager", "train_step.capture",
                 "train_step.replay")


def program_intervals() -> list:
    """The program's recorded spans, (name, thread, start_ns, end_ns)."""
    try:
        from alignn_tpu_torch import tracing
    except ImportError:
        return []
    return tracing.recorder.intervals()


def union(spans: Iterable[Span]) -> List[Span]:
    merged: List[List[int]] = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def minus(a: List[Span], b: List[Span]) -> List[Span]:
    """The parts of `a` outside `b` (both sorted and disjoint)."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while s < e and k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append((s, e))
    return out


def overlap_ns(a: List[Span], b: List[Span]) -> int:
    """The length of the intersection of `a` and `b` (both sorted and
    disjoint)."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_idle(tracer) -> List[Span]:
    """The idle stretches of the profiled part, on the device's clock."""
    return minus([tracer.window_ns], tracer.busy_intervals())


def _named(spans: list, names: Tuple[str, ...]) -> List[Span]:
    return union((s, e) for n, _t, s, e in spans if n in names)


def idle_ms_per_step(run: Outcome, inside: Tuple[str, ...],
                     outside: Tuple[str, ...] = ()) -> Optional[float]:
    """Device-idle ms inside the spans named `inside` and outside those
    named `outside`, over the profiled part's train steps."""
    spans, t = program_intervals(), run.tracer
    steps = run.counters.get("profiled_steps")
    if not spans or t is None or not t.device_ops or not steps:
        return None
    region = minus(_named(spans, inside), _named(spans, outside))
    return overlap_ns(device_idle(t), region) / 1e6 / steps


def step_prep_idle_ms(run: Outcome) -> Optional[float]:
    """Device-idle ms a train step spends in the program's host work
    around its graph: in ``train_step`` but not in its eager steps,
    capture or replay."""
    return idle_ms_per_step(run, ("train_step",), STEP_CHILDREN)


def loss_fetch_idle_ms(run: Outcome) -> Optional[float]:
    """Device-idle ms a train step spends fetching its losses."""
    return idle_ms_per_step(run, ("trainer.loss_fetch",))


def batch_build_ms(run: Outcome) -> Optional[float]:
    """Host ms the train loader takes to build a batch, its wait for the
    device-work lock included, over the builds that overlap the profiled
    part."""
    spans, t = program_intervals(), run.tracer
    if not spans or t is None or t.window_s <= 0:
        return None
    lo, hi = t.window_ns
    builds = [e - s for n, _t, s, e in spans
              if n == "train_loader.build" and s < hi and e > lo]
    if not builds:
        return None
    return sum(builds) / len(builds) / 1e6
