"""alignn_tpu_torch/backend_retry.py: the counterparts of the eight cases
of tests/test_backend_retry.py, with the port's transient markers (a busy
device, NCCL's system and remote errors, the rendezvous's sockets) and a
stand-in probe command for the subprocess cases, and ``is_transient`` held
against alignn_tpu's on the messages both packages know.
"""

import sys

import pytest

from alignn_tpu_torch.backend_retry import (BackendHang, ProbesExhausted,
                                            is_transient, probe_devices,
                                            probe_devices_subprocess,
                                            retry_transient)


def test_is_transient_classification():
    assert is_transient(RuntimeError(
        "CUDA error: CUDA-capable device(s) is/are busy or unavailable"))
    assert is_transient(RuntimeError(
        "NCCL error in: ProcessGroupNCCL.cpp:1970, unhandled system "
        "error (run with NCCL_DEBUG=INFO for details)"))
    assert is_transient(RuntimeError(
        "NCCL error: remote process exited or there was a network error"))
    assert is_transient(RuntimeError(
        "The client socket has failed to connect to [localhost]:29500 "
        "(errno: 111 - Connection refused)."))
    assert is_transient(RuntimeError("Connection reset by peer"))
    assert is_transient(RuntimeError("Socket Timeout"))
    assert is_transient(BackendHang("device probe exceeded 60s"))
    assert not is_transient(ValueError("shape mismatch"))
    assert not is_transient(AssertionError("loss is NaN"))
    assert not is_transient(RuntimeError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert not is_transient(RuntimeError(
        "CUDA error: an illegal memory access was encountered"))


def test_retry_recovers_after_transients():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("Connection refused")
        return "ok"

    logged = []
    assert retry_transient(flaky, backoffs=(0, 0, 0, 0),
                           log=logged.append) == "ok"
    assert len(calls) == 3
    assert len(logged) == 2 and "attempt 1/5" in logged[0]


def test_retry_propagates_non_transient_immediately():
    calls = []

    def buggy():
        calls.append(1)
        raise ValueError("real bug")

    with pytest.raises(ValueError):
        retry_transient(buggy, backoffs=(0,))
    assert len(calls) == 1


def test_retry_exhausts_and_raises_last_transient():
    def always_down():
        raise RuntimeError("busy or unavailable: still down")

    with pytest.raises(RuntimeError, match="still down"):
        retry_transient(always_down, attempts=3, backoffs=(0, 0))


def test_probe_devices_cpu():
    # the in-process probe on the CPU, asked for explicitly
    devs = probe_devices("cpu")
    assert [d.type for d in devs] == ["cpu"]


def test_probe_subprocess_happy_path():
    # the probe's own command on the CPU, then a stand-in that fails
    # transiently (retried) and one that fails for real (not)
    probe_devices_subprocess(timeout_s=300.0, device="cpu")
    busy = [sys.executable, "-c",
            "raise SystemExit('CUDA error: CUDA-capable device(s) is/are "
            "busy or unavailable')"]
    with pytest.raises(RuntimeError, match="busy or unavailable") as ei:
        probe_devices_subprocess(timeout_s=60.0, command=busy)
    assert is_transient(ei.value)
    broken = [sys.executable, "-c", "raise SystemExit('ImportError: x')"]
    with pytest.raises(RuntimeError, match="ImportError") as ei:
        probe_devices_subprocess(timeout_s=60.0, command=broken)
    assert not is_transient(ei.value)


def test_probe_subprocess_timeout_raises_transient_hang():
    hang = [sys.executable, "-c", "import time; time.sleep(30)"]
    with pytest.raises(BackendHang) as ei:
        probe_devices_subprocess(timeout_s=0.5, command=hang)
    assert is_transient(ei.value)


def test_probes_exhausted_not_retried():
    """ProbesExhausted short-circuits outer retry loops (no attempts^2
    probes)."""
    e = ProbesExhausted("device unavailable after a full probe retry "
                        "cycle: BackendHang: busy or unavailable")
    assert not is_transient(e)   # despite the marker in the message

    calls = []

    def probe_phase():
        calls.append(1)
        raise ProbesExhausted("busy or unavailable: still down")

    with pytest.raises(ProbesExhausted):
        retry_transient(probe_phase, attempts=3, backoffs=(0, 0))
    assert len(calls) == 1


@pytest.mark.parametrize("message,transient", [
    ("Connection reset by peer", True),
    ("Socket closed", True),
    ("shape mismatch", False),
    ("CUDA out of memory", False),
])
def test_is_transient_agrees_with_jax_on_shared_markers(message, transient):
    """The markers both packages hold (the sockets' resets and closes) and
    real errors classify alike; alignn_tpu's own XLA status codes and the
    port's CUDA and NCCL markers are each package's own."""
    from alignn_tpu.backend_retry import ProbesExhausted as JaxExhausted
    from alignn_tpu.backend_retry import is_transient as jax_is_transient

    assert is_transient(RuntimeError(message)) \
        == jax_is_transient(RuntimeError(message)) == transient
    assert is_transient(ProbesExhausted(message)) \
        == jax_is_transient(JaxExhausted(message)) is False
