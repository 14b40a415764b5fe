"""On the card (marker ``cuda``): the control of each cell comes out not
correct, and a compiled step fed a stale batch is caught in the window.

The control is the reference put in the program's place, in TF32, at
the cell's own sizes; it fails one of the cell's limits.  The stale
batch (``StepLoop.load_batch`` copies nothing) is planted under the
small cells of ``benchcells`` run on the card, whose window steps are
replays of captured CUDA graphs."""

import pytest

import control
import run as brun
from benchcells import run_small

CELLS = ["ff_train_si64", "prop_train_jarvis"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(card, name):
    args = brun.parse(["--workload", name, "--seed", "0", "--seconds", "1"])
    _bench, _w, cell = brun.make_cell(args, "cuda", "")
    readings = control.train_readings(cell, 2**31 + 77, "tf32")
    assert any(readings[k] > cell.limits[k] for k in readings), readings


@pytest.mark.cuda
@pytest.mark.parametrize("stale", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_a_stale_batch_in_the_window_is_not_correct(card, name, stale,
                                                    monkeypatch):
    from alignn_tpu_torch.ff.step_loop import StepLoop

    if stale:
        monkeypatch.setattr(StepLoop, "load_batch", lambda self, b: None)
    result, outcome = run_small(name, device="cuda")
    assert outcome.counters["window_checked_replays"] == 3
    window = {k: v for k, v in result["checks"].items()
              if k.startswith("window_")}
    assert all(v["value"] <= v["limit"] for v in window.values()) \
        is not stale, window
    assert result["correct"] is not stale, result["checks"]
