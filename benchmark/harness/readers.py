"""The arithmetic of the per-layer metrics; each ``metrics/<name>.py``
binds one of these to its name.  A reader returns None where it finds
nothing to read, and the harness then leaves the metric out."""

from __future__ import annotations

from typing import Optional

from harness.cell import Outcome, warn
from harness.peaks import H100_F32_FLOP_PER_S, eggc_least_seconds


def device_idle(run: Outcome) -> Optional[float]:
    """Share of the profiled part in which no kernel, copy or fill ran."""
    t = run.tracer
    if t is None or t.window_s <= 0 or not t.device_ops:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


def eggc_roofline(run: Outcome) -> Optional[float]:
    """Sum of K1/K2 least times over the sum of their device times, over
    every K1/K2 launch of the profiled part.  The launches the profiler
    saw must be those the records predict, kind by kind."""
    t = run.tracer
    if t is None:
        return None
    seen = t.profiled_kernels()
    expected = t.expected_launches()
    for kind in ("K1", "K2"):
        n_exp = sum(1 for r in expected if r[0] == kind)
        if n_exp != len(seen[kind]):
            warn(f"eggc_roofline: the trace holds {len(seen[kind])} {kind} "
                 f"launches, the launch records predict {n_exp} "
                 f"({t.launch_summary()})")
            return None
    device_s = sum(sum(v) for v in seen.values())
    if device_s <= 0:
        return None
    least = sum(eggc_least_seconds(*r) for r in expected)
    return 100.0 * least / device_s


def mfu(run: Outcome) -> Optional[float]:
    """Model FLOPs of the profiled part over its seconds at the card's
    f32 peak (67 TFLOP/s; the cells run f32 with TF32 off)."""
    c = run.counters
    if not c.get("profiled_flops") or not c.get("profiled_s"):
        return None
    return 100.0 * c["profiled_flops"] / (c["profiled_s"]
                                          * H100_F32_FLOP_PER_S)


def batch_wait_ms(run: Outcome) -> Optional[float]:
    """Host ms a train step waited on the train loader, over the
    window."""
    c = run.counters
    if not c.get("steps"):
        return None
    return 1e3 * c.get("batch_wait_s", 0.0) / c["steps"]
