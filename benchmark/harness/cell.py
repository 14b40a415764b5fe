"""What an entry is handed (:class:`Cell`) and what it hands back
(:class:`Outcome`), and the numbers a check compares."""

from __future__ import annotations

import sys
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np


@dataclass
class Cell:
    """One run of one cell: its configuration, traffic and arguments."""

    name: str
    config: Dict[str, Any]          # configs/<config>.json
    traffic: Dict[str, Any]         # workloads/<traffic>.json
    limits: Dict[str, float]        # limits/<cell>.json
    seed: int
    seconds: float
    traced: bool
    device: str                     # "cuda" on the card; "cpu" in tests
    t_process: float                # process start on the host clock
    work_dir: str                   # scratch space under the run's TMPDIR

    @property
    def model_cfg(self) -> Dict[str, Any]:
        return self.config["model"]


@dataclass
class Check:
    """One number compared with the reference, beside its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


@dataclass
class Outcome:
    """What a run measured and whether its output held."""

    end_to_end: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    checks: List[Check] = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    tracer: Any = None

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


def leaf_gaps(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
              counted: List[str], what: str = "") -> Dict[str, float]:
    """Each counted leaf's gap between the two sides' norms, against the
    larger of the reference leaf's norm and the median leaf's; the worst
    leaf is named on standard error."""
    norms = {k: float(np.linalg.norm(ref[k])) for k in counted}
    median = float(np.median(list(norms.values())))
    gaps = {k: abs(float(np.linalg.norm(prog[k])) - norms[k])
            / max(norms[k], median) for k in counted}
    worst = max(gaps, key=gaps.get)
    warn(f"{what}: worst leaf {worst} {gaps[worst]!r} (its norm "
         f"{norms[worst]!r}, the median leaf's {median!r}); median gap "
         f"{float(np.median(list(gaps.values())))!r}")
    return gaps


def memory_peak(cell: Cell) -> int:
    """The most device memory the run held: the caching allocator's peak
    reservation, which counts the CUDA graphs' private pools (their
    replays allocate nothing the allocated-bytes peak would see)."""
    if cell.device != "cuda":
        return 0
    import torch

    return int(torch.cuda.max_memory_reserved())


@contextmanager
def tf32_products(device: str, on: bool):
    """Matrix products in TF32 (`on`) or in f32 inside the block: TF32 is
    the control's precision, one below the cells' f32."""
    import torch

    if device != "cuda":
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
        torch.backends.cudnn.allow_tf32 = prev


def warn(msg: str):
    print(msg, file=sys.stderr, flush=True)
