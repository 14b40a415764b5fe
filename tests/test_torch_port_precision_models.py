"""alignn_tpu_torch's bf16 train step against alignn_tpu's for the
envelope-weighted force field (width 128), the property model (BatchNorm,
its running statistics after the step included) and eALIGNN: the limits
and the method of ``test_torch_port_precision.py``, which holds the
helpers."""

import pytest

from test_torch_port_precision import (_two_threads,  # noqa: F401
                                       check_bf16_path, run_path)

HERE = ("envelope", "property", "ealignn")


@pytest.fixture(scope="module")
def steps():
    return {path: run_path(path, ("float32", "bfloat16")) for path in HERE}


@pytest.mark.parametrize("path", HERE)
def test_bf16_step_matches_jax(steps, path):
    """The port's bf16 train step against JAX's bf16 step, and bf16's
    distance from f32 of JAX's size."""
    check_bf16_path(steps[path])


def test_property_step_moved_the_running_statistics(steps):
    """The property model's train step moves its BatchNorm statistics in
    both packages (compared in check_bf16_path)."""
    r = steps["property"]["bfloat16"]
    assert r["jax"]["stats"] and set(r["jax"]["stats"]) == \
        set(r["port"]["stats"])
    assert any(abs(float(v.max())) > 0 for k, v in r["port"]["stats"].items()
               if k.endswith(".mean"))
