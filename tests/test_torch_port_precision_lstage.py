"""alignn_tpu_torch's bf16 train step against alignn_tpu's on the fused
dense L-stage (``ALIGNN_TPU_FUSED_LSTAGE``) and the windowed sparse path
(``ALIGNN_TPU_ENABLE_WGATHER``, width 128): the limits and the method of
``test_torch_port_precision.py``, which holds the helpers."""

import pytest

from test_torch_port_precision import (_two_threads,  # noqa: F401
                                       check_bf16_path, run_path)

HERE = ("fused", "windowed")


@pytest.fixture(scope="module")
def steps():
    return {path: run_path(path, ("float32", "bfloat16")) for path in HERE}


@pytest.mark.parametrize("path", HERE)
def test_bf16_step_matches_jax(steps, path):
    """The port's bf16 train step against JAX's bf16 step, and bf16's
    distance from f32 of JAX's size."""
    check_bf16_path(steps[path])


def test_windowed_path_took_the_windows(steps):
    """The windowed batch carries gather windows, so the switch routes
    its gathers through the window path (K8's plain version here)."""
    tb = steps["windowed"]["batch"]
    assert tb.win_src > 0 and tb.win_lg_src > 0
