"""The port's spans (``alignn_tpu_torch/tracing.py``) in the trainer, its
compiled steps and its loaders.

On the CPU: a small property model trains for 2 epochs with and without
a profiler session around ``train_model``; the spans change no loss and
no weight, record nothing without a session, and under one record each
piece of work once, nested as the program nests it, each mirrored by a
``record_function`` event of the profiler.  On the card (``cuda``), the
recorder's clock against the profiler's over a captured step loop.

This file imports torch and the port only, so on the card run it without
the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_port_tracing.py
"""

import statistics
import threading
from collections import Counter

import pytest
import torch

from alignn_tpu_torch import tracing
from torch_port_threads import _two_threads  # noqa: E402,F401

RUN = {"epochs": 2, "batch_size": 4, "n_train": 8, "n_val": 4, "n_test": 0,
       "learning_rate": 1e-3, "criterion": "l1", "num_workers": 0,
       "write_checkpoint": False, "write_predictions": False,
       "store_outputs": False, "progress": False,
       "model": {"name": "alignn", "alignn_layers": 1, "gcn_layers": 1,
                 "hidden_features": 32, "embedding_features": 16}}


def _records(n: int, seed: int = 0) -> list:
    from alignn_tpu_torch.graph.build import rocksalt_cells

    return [{"jid": f"c{i}", "atoms": atoms.to_dict(), "target": target}
            for i, (atoms, target, _f) in enumerate(rocksalt_cells(n, seed))]


def _train(tmp_path, name: str, device: str = "cpu", epochs: int = 2):
    """(summary, the train loader's batches built) of one run."""
    from alignn_tpu_torch.config import TrainingConfig
    from alignn_tpu_torch.data.loader import get_train_val_loaders
    from alignn_tpu_torch.train.trainer import train_model

    cfg = TrainingConfig.from_dict({**RUN, "epochs": epochs,
                                    "output_dir": str(tmp_path / name)})
    tr, va, _te, _mad = get_train_val_loaders(
        _records(12), batch_size=4, n_train=8, n_val=4, n_test=0,
        output_dir=str(tmp_path / name), device=device)
    return train_model(cfg, tr, va), cfg.epochs * len(tr)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same run without a session, then inside
    ``profiler.trace``; the recorder's intervals after each."""
    from alignn_tpu_torch.profiler import trace

    tmp = tmp_path_factory.mktemp("tracing")
    tracing.recorder.clear()
    plain, _ = _train(tmp, "plain")
    plain_intervals = tracing.recorder.intervals()
    with trace(str(tmp / "trace")) as prof:
        traced, built = _train(tmp, "traced")
    intervals = tracing.recorder.intervals()
    tracing.recorder.clear()
    events = [(ev.name(), ev.start_ns(), ev.end_ns())
              for ev in prof.profiler.kineto_results.events()
              if ev.is_user_annotation()]
    return dict(plain=plain, traced=traced, built=built,
                plain_intervals=plain_intervals, intervals=intervals,
                events=events)


def test_spans_leave_training_unchanged(runs):
    """Step losses and final weights bit for bit with and without a
    profiler session; without one the recorder stays empty."""
    a, b = runs["plain"], runs["traced"]
    assert a["step_losses"] == b["step_losses"]
    sa, sb = a["state"].model.state_dict(), b["state"].model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert runs["plain_intervals"] == []


def test_span_counts(runs):
    """Under a session: a train step's prepare and loss fetch once a
    step, validation once an epoch, a batch build once a batch the train
    loader built, from its prefetch thread."""
    steps = sum(len(e) for e in runs["traced"]["step_losses"])
    n = Counter(name for name, *_ in runs["intervals"])
    assert steps == 4
    assert n["train_step"] == n["train_step.prepare"] == steps
    assert n["trainer.loss_fetch"] == steps
    assert n["trainer.validation"] == n["trainer.epoch_end"] == 2
    assert n["eval_step"] == n["eval_step.prepare"] == 2
    assert n["train_loader.build"] == runs["built"]
    threads = {t for name, t, *_ in runs["intervals"]
               if name == "train_loader.build"}
    assert threads and threading.main_thread().ident not in threads


def test_prepare_lies_inside_its_step(runs):
    steps = [(t, s, e) for name, t, s, e in runs["intervals"]
             if name == "train_step"]
    for name, t, s, e in runs["intervals"]:
        if name == "train_step.prepare":
            assert any(t == st and ss <= s and e <= se
                       for st, ss, se in steps)


def test_intervals_match_record_function_events(runs):
    """Each interval has a ``record_function`` event of its name that
    ends within 1 ms of it."""
    ends = {}
    for name, _s, e in runs["events"]:
        ends.setdefault(name, []).append(e)
    for name, _t, _s, e in runs["intervals"]:
        gaps = [abs(e - ee) for ee in ends.get(name, [])]
        assert gaps and min(gaps) <= 1_000_000, (name, gaps)


@pytest.mark.cuda
def test_recorder_shares_the_profilers_clock_on_the_card(tmp_path):
    """Four epochs of the small model on the card (each bucket's steps
    eager, captured, then replayed) inside ``profiler.trace``: every
    recorded interval ends within 20 us of its ``record_function`` event
    at the median and 100 us at worst."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from alignn_tpu_torch.profiler import trace

    _train(tmp_path, "warm", device="cuda", epochs=4)   # builds the kernels
    tracing.recorder.clear()
    with trace(str(tmp_path / "trace")) as prof:
        _train(tmp_path, "traced", device="cuda", epochs=4)
    intervals = tracing.recorder.intervals()
    tracing.recorder.clear()
    ends = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.is_user_annotation() and \
                ev.device_type() != torch.autograd.DeviceType.CUDA:
            ends.setdefault(ev.name(), []).append(ev.end_ns())
    gaps = [min(abs(e - end) for end in ends[name])
            for name, _t, _s, e in intervals]
    print("spans", dict(Counter(name for name, *_ in intervals)),
          "end gap us: median", statistics.median(gaps) / 1e3, "worst",
          max(gaps) / 1e3)
    assert any(name == "train_step.replay" for name, *_ in intervals)
    assert statistics.median(gaps) <= 20_000
    assert max(gaps) <= 100_000
