"""Profiling: a torch.profiler trace of the train step, and its throughput.

Counterpart of ``alignn_tpu/profiler.py``, which replaces the reference's
torch.profiler wrapper (``alignn/profiler.py``: wait 2, warm-up 2, active
6) with ``jax.profiler`` traces.  Here the trace is ``torch.profiler``'s
(CPU operations, and the CUDA kernels and copies where a device is
present), exported as a Chrome trace (``trace.json``) that
chrome://tracing, Perfetto and TensorBoard's profile plugin read, beside
a step timer that reports edges/s, the framework's headline throughput.

    python -m alignn_tpu_torch.cli.train --root_dir DATA \\
        --config_name config.json --profile DIR

profiles one compiled train step on the first training batch.

The trainer's own spans (:mod:`alignn_tpu_torch.tracing`: the loaders'
batch builds and waits, each train and eval step with its preparation,
eager steps, capture and replay, the loss fetch, validation and the
epoch's end) record whenever a profiler session does.  To see them in
the Chrome trace beside the kernels, run ``train_model`` inside
:func:`trace`::

    with trace("DIR"):
        train_model(config, train_loader, val_loader)

Their intervals, on the clock of the trace's events, are also in
``tracing.recorder.intervals()``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional

import torch

TRACE_FILE = "trace.json"


def _synchronize(tree) -> None:
    """Wait for the device of every CUDA tensor in `tree`."""
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(tree)
    for d in devices:
        torch.cuda.synchronize(d)


@contextlib.contextmanager
def trace(logdir: str = "./torch_trace"):
    """Record CPU and CUDA activity around a block, on every thread (the
    loaders' prefetch threads too), and write it to ``logdir/trace.json``;
    yields the ``torch.profiler.profile``."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities, experimental_config=(
        _ExperimentalConfig(profile_all_threads=True)))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def profile_step(step_fn: Callable, state, batch,
                 wait: int = 2, warmup: int = 2, active: int = 6,
                 logdir: Optional[str] = "./torch_trace",
                 edges_per_batch: Optional[int] = None) -> Dict:
    """Profile a train step with the reference's schedule.

    Runs `wait` untimed steps, `warmup` timed-but-discarded steps, then
    `active` traced and timed steps; the device is synchronised before
    the clock is read.  With a compiled step on the card the wait steps
    are its eager sightings and the first warm-up step captures the
    graph, so the active steps are replays.  Returns {"step_time_s",
    "trace_dir", "edges_per_s"} (the last with `edges_per_batch`).  The
    steps train `state` in place.
    """
    if active < 1:
        raise ValueError("profile_step requires active >= 1")
    out = None
    for _ in range(wait):
        state, out = step_fn(state, batch)
    _synchronize(out)
    for _ in range(warmup):
        state, out = step_fn(state, batch)
    _synchronize(out)

    ctx = trace(logdir) if logdir else contextlib.nullcontext()
    with ctx:
        t0 = time.perf_counter()
        for _ in range(active):
            state, out = step_fn(state, batch)
        _synchronize(out)
        dt = (time.perf_counter() - t0) / active
    result = {"step_time_s": dt, "trace_dir": logdir}
    if edges_per_batch:
        result["edges_per_s"] = edges_per_batch / dt
    return result
