"""Spans of the port's host work, on the profiler's clock.

``with span("train_step"): ...`` marks a stretch of host work.  A span
records only while a ``torch.profiler`` session records (for example
:func:`alignn_tpu_torch.profiler.trace` around ``train_model``);
otherwise ``span`` returns a shared empty context at the cost of one
flag check.  While recording, a span

- opens a ``record_function`` range of its name (a user annotation of
  the profiler), so that it lies in the Chrome trace beside the device's
  kernels, and
- appends ``(name, thread, start_ns, end_ns)`` to :data:`recorder`,
  stamped with ``time.time_ns()``: the clock the profiler's events carry,
  so that a reader can lay the intervals over the device's operations.

Spans may be recorded from any thread (the loaders' prefetch thread
records its batch builds); ``thread`` is ``threading.get_ident()``.

The spans the program records (a name a line; ``<split>`` is a loader's
name, ``<step>`` a compiled step's):

- ``<split>_loader.build``: the prefetch thread builds one batch;
- ``<split>_loader.wait``: the consumer gets the next batch;
- ``train_step``, ``eval_step``: a whole call of the trainer's steps;
- ``<step>.prepare``: a compiled step pads, signs and copies its batch;
- ``<step>.eager``, ``<step>.capture``, ``<step>.replay``: a step loop's
  eager steps, its CUDA-graph capture, its replay with the outputs' copy;
- ``trainer.loss_fetch``, ``trainer.validation``, ``trainer.epoch_end``:
  the train step's loss to the host, the validation pass, and history,
  checkpoints and early stopping.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import List, Tuple

from torch._C._autograd import (_record_function_with_args_enter,
                                _record_function_with_args_exit)
from torch.autograd import profiler as _profiler

Interval = Tuple[str, int, int, int]   # (name, thread, start_ns, end_ns)


class Recorder:
    """The intervals of every span recorded in this process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._intervals: List[Interval] = []

    def intervals(self) -> List[Interval]:
        """A copy of the intervals, in the order their spans ended."""
        with self._lock:
            return list(self._intervals)

    def clear(self):
        with self._lock:
            self._intervals.clear()


recorder = Recorder()
_OFF = contextlib.nullcontext()


class _Span:
    # The range is the user annotation ``torch.profiler.record_function``
    # opens, through torch's direct bindings: ``record_function`` goes
    # through the dispatcher, whose call lets go of the interpreter lock,
    # so that each exit would wait to take it back (up to the switch
    # interval, 5 ms, while the prefetch thread runs Python), stalling the
    # traced thread and stamping the end late.  The interval holds the
    # range's own enter and exit, so that it encloses the range the
    # profiler records.
    __slots__ = ("name", "_range", "_start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._start = time.time_ns()
        self._range = _record_function_with_args_enter(self.name)
        return self

    def __exit__(self, *exc):
        _record_function_with_args_exit(self._range)
        end = time.time_ns()
        with recorder._lock:
            recorder._intervals.append(
                (self.name, threading.get_ident(), self._start, end))
        return False


def span(name: str):
    """A context that records `name`'s interval while a profiler session
    records, and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)
