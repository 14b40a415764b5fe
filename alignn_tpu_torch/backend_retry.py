"""Retry of transient failures at the card's start-up and at the
rendezvous (counterpart of ``alignn_tpu/backend_retry.py``).

Usage::

    from alignn_tpu_torch.backend_retry import (probe_devices_subprocess,
                                                retry_transient)

    retry_transient(probe_devices_subprocess, timeout_s=120)   # the card
    retry_transient(initialize_distributed, addr, n, rank)     # rendezvous

Only errors that look transient are retried: a busy or unavailable device
at CUDA initialisation, NCCL's ``unhandled system error`` and remote
process errors, and the TCPStore rendezvous's refused, reset or closed
connections and its timeouts.  Real errors (an out-of-memory error, an
illegal address, a ``ValueError``) propagate at once.

JAX clears its cached backends between attempts.  torch has no
counterpart: it caches a failed lazy CUDA initialisation (every later
call re-raises it), and a CUDA context that has hit an error is sticky.
So a device probe retries in a fresh subprocess
(:func:`probe_devices_subprocess`, which also bounds a hung start-up),
and an in-process retry (:func:`retry_transient` around a function that
touches no CUDA state) is for the rendezvous only.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

_TRANSIENT_MARKERS = (
    # CUDA initialisation on a device that another process holds
    "busy or unavailable",
    "cudaErrorDevicesUnavailable",
    # NCCL
    "unhandled system error",
    "remote process exited or there was a network error",
    "ncclRemoteError",
    # the TCPStore rendezvous and gloo's sockets
    "Connection refused",
    "Connection reset",
    "Connection closed by peer",
    "Socket closed",
    "Socket Timeout",
    "client socket has timed out",
    "server socket has timed out",
    "DistNetworkError",
)


class BackendHang(RuntimeError):
    """A device probe exceeded its deadline (treated as transient)."""


class ProbesExhausted(RuntimeError):
    """A full probe retry cycle failed: do not retry again.

    Raised by a caller after ``retry_transient(probe_...)`` gives up, so
    that an outer retry loop does not multiply the (already long) probe
    schedule.  :func:`is_transient` returns False for it even though the
    cause was transient."""


def is_transient(exc: BaseException) -> bool:
    if isinstance(exc, ProbesExhausted):
        return False   # already retried a full cycle: don't multiply
    if isinstance(exc, BackendHang):
        return True
    msg = f"{type(exc).__name__}: {exc}"
    return any(m in msg for m in _TRANSIENT_MARKERS)


def probe_devices(device=None):
    """Touch the device end to end (initialisation, a launch, a fetch);
    returns the devices of its type.  In-process: a failure here sticks
    to this process (see the module docstring)."""
    import torch

    from alignn_tpu_torch import resolve_device

    device = resolve_device(device)
    x = torch.ones((8, 8), dtype=torch.float32, device=device)
    float(x.sum().item())
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def _probe_command(device: str) -> list:
    import sys

    code = ("import torch; "
            f"x = torch.ones((8, 8), device={device!r}); "
            "float(x.sum().item())")
    return [sys.executable, "-c", code]


def probe_devices_subprocess(timeout_s: float = 600.0,
                             extra_env: Optional[dict] = None,
                             device: str = "cuda",
                             command: Optional[Sequence[str]] = None
                             ) -> None:
    """Probe the device in a killable subprocess with a deadline.

    A fresh process holds no cached initialisation failure, and a hung
    start-up is bounded: on timeout :class:`BackendHang` is raised, which
    :func:`is_transient` matches, so :func:`retry_transient` backs off
    and probes again.  A failed probe raises ``RuntimeError`` with the
    child's last line, transient where that line is.  `command` replaces
    the probe (a test's stand-in)."""
    import os
    import subprocess

    env = dict(os.environ)
    env.update(extra_env or {})
    cmd = list(command) if command is not None else _probe_command(device)
    try:
        res = subprocess.run(cmd, timeout=timeout_s, capture_output=True,
                             text=True, env=env)
    except subprocess.TimeoutExpired:
        raise BackendHang(
            f"device probe exceeded {timeout_s:.0f}s (hung start-up)"
        ) from None
    if res.returncode != 0:
        tail = (res.stderr or res.stdout or "").strip().splitlines()
        raise RuntimeError("device probe failed: "
                           + (tail[-1] if tail else "no output"))


def retry_transient(fn, *args, attempts: int = 5,
                    backoffs=(30, 45, 60, 60), log=None, **kwargs):
    """Run ``fn``; on a transient error back off and retry (up to
    ``attempts`` tries in all).  Non-transient errors and the last
    transient error propagate.  ``log`` receives one line a retry."""
    last = None
    for i in range(attempts):
        try:
            return fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 - filtered by is_transient
            if not is_transient(e):
                raise
            last = e
            if i == attempts - 1:
                break
            delay = backoffs[min(i, len(backoffs) - 1)]
            if log is not None:
                log(f"transient error (attempt {i + 1}/{attempts}, "
                    f"retrying in {delay}s): {e}")
            time.sleep(delay)
    raise last
