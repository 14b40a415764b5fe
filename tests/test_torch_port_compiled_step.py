"""The compiled train and eval steps, the profiler and the plots.

On the CPU (against alignn_tpu where it has a counterpart):

- the compiled step's static-batch path (segments at their item
  capacity, each batch copied into its signature's own) equals ``cuda_graph=False`` bit for bit over two
  epochs, with a learning-rate change between them, a resume from
  ``restart.mpk`` and the eval step, for the property and the FF model;
  one signature serves every batch of the bucket; a restore into an
  optimizer that has taken a step raises;
- ``profile_step``'s result has the keys and types of JAX's, and
  ``cli.train --profile`` writes a trace and trains nothing;
- ``plot_learning_curve`` reads the histories JAX's reads and writes
  ``learning_curve.png``; ``plot_ff_training`` writes its two figures;
- the new modules are among those ``test_port_imports_no_jax`` imports.

On the card (marked ``cuda``; skipped here): captured and eager steps
give bit-identical losses and parameters over 12 steps under torch's
deterministic algorithms (``index_add`` adds by atomics otherwise, and
no two runs agree in their last bits); a new signature
captures again and one seen twice does not; a host sync inside a step
raises instead of running eagerly.  This file imports no JAX at module
level, so on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_port_compiled_step.py
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"alignn_layers": 1, "gcn_layers": 1, "hidden_features": 32,
         "embedding_features": 16}
FF = {**SMALL, "gradwise_weight": 1.0, "stresswise_weight": 0.1}


def _model(kind: str, seed: int = 0):
    from alignn_tpu_torch.nn.models import (ALIGNN, ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig,
                                            ALIGNNConfig, init_parameters)

    model = ALIGNN(ALIGNNConfig(**SMALL)) if kind == "property" else \
        ALIGNNAtomWise(ALIGNNAtomWiseConfig(**FF))
    return init_parameters(model, torch.Generator().manual_seed(seed))


def _loader(device, n: int = 8, batch_size: int = 3, seed: int = 0):
    """Shuffled rocksalt batches of one bucket; the last batch of an epoch
    is partial (drop_last False), so the batches' item counts differ."""
    from alignn_tpu_torch.data.dataset import GraphDataset
    from alignn_tpu_torch.data.loader import BucketedLoader
    from alignn_tpu_torch.graph.build import rocksalt_graphs

    graphs = rocksalt_graphs(n, seed=seed)
    return BucketedLoader(GraphDataset(graphs, [str(i) for i in range(n)]),
                          batch_size, shuffle=True, device=device)


def _run(kind: str, device, cuda_graph: bool, tmp_path=None,
         epochs=(1e-3, 5e-4), steps: int = 0, n: int = 8):
    """Train `kind` over the loader's epochs (one learning rate each),
    resuming from restart.mpk between epochs when `tmp_path` is given;
    evaluate the first batch after each epoch.  With `steps`, run that
    many steps over the first epoch's batches instead.  Returns (train
    losses, eval outputs, final parameters and buffers, train step)."""
    from alignn_tpu_torch.train.checkpoint import (load_train_state,
                                                   save_train_state)
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import (create_train_state,
                                              make_eval_step,
                                              make_train_step)

    loader = _loader(device, n=n)
    batches = list(loader)

    def fresh():
        model = _model(kind)
        state = create_train_state(model, batches[0], build_optimizer(
            "adamw", 1e-3, 1e-5, model=model))
        return (model, state,
                make_train_step(model, "l1", cuda_graph=cuda_graph),
                make_eval_step(model, "l1", cuda_graph=cuda_graph))

    model, state, train_step, eval_step = fresh()
    losses, evals = [], []
    if steps:
        for i in range(steps):
            if i == steps // 2:
                state.set_lr(epochs[1])
            state, out = train_step(state, batches[i % len(batches)])
            losses.append(out)
        return losses, evals, _tensors(model), train_step
    for epoch, lr in enumerate(epochs):
        if epoch and tmp_path is not None:
            path = str(tmp_path / f"restart_{cuda_graph}.mpk")
            save_train_state(path, state, epoch)
            model, state, train_step, eval_step = fresh()
            state, start = load_train_state(path, state)
            assert start == epoch
        loader.set_epoch(epoch)
        state.set_lr(lr)
        for batch in loader:
            state, out = train_step(state, batch)
            losses.append(out)
        evals.append(eval_step(state, batches[0]))
    return losses, evals, _tensors(model), train_step


def _tensors(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _assert_bitwise(a, b, what):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert torch.equal(a, b), (what, (a - b).abs().max())
    elif isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _assert_bitwise(a[k], b[k], f"{what}.{k}")
    else:
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bitwise(x, y, f"{what}[{i}]")


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["property", "ff"])
def test_static_batch_path_equals_eager(kind, tmp_path):
    """Two epochs (lr 1e-3, then 5e-4 after a resume from restart.mpk),
    the eval step after each: the compiled step equals the eager one bit
    for bit, and one signature served the shuffled epochs."""
    torch.set_num_threads(2)
    cpu = torch.device("cpu")
    got = _run(kind, cpu, True, tmp_path, n=5)
    ref = _run(kind, cpu, False, tmp_path, n=5)
    for i, what in enumerate(("losses", "evals", "parameters")):
        _assert_bitwise(got[i], ref[i], what)
    assert len(got[0]) == 4 and len(got[1]) == 2
    assert len(got[3].compiled.loops) == 1 and got[3].compiled.captures == 0
    assert ref[3].compiled is None


def test_restore_refuses_a_stepped_optimizer(tmp_path):
    """load_train_state restores into an optimizer that has taken no
    step (a captured step reads its state tensors, which
    load_state_dict replaces); one that holds state raises."""
    from alignn_tpu_torch.train.checkpoint import (load_train_state,
                                                   save_train_state)
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    torch.set_num_threads(2)
    batch = next(iter(_loader(torch.device("cpu"), n=3)))
    model = _model("property")
    state = create_train_state(model, batch, build_optimizer(
        "adamw", 1e-3, 1e-5, model=model))
    path = str(tmp_path / "restart.mpk")
    save_train_state(path, state, 0)
    state, _ = make_train_step(model, "l1")(state, batch)
    with pytest.raises(ValueError, match="before the first train step"):
        load_train_state(path, state)


def test_static_batch_keeps_the_sums():
    """with_item_capacity pads the segments to their capacity: the
    loader's batches of one bucket (their windows at the loader's floor)
    then share one signature, and the sums and the windowed gather's
    plain version read the same rows."""
    from alignn_tpu_torch.ff.step_loop import (batch_signature,
                                               with_item_capacity)
    from alignn_tpu_torch.graph.batch import WIN_FIELDS
    from alignn_tpu_torch.ops.eggc import sorted_segment_sum
    from alignn_tpu_torch.ops.gather import windowed_gather_plain

    batches = list(_loader(torch.device("cpu")))
    sigs = {batch_signature(b) for b in batches}
    static = [with_item_capacity(b) for b in batches]
    assert len(sigs) > 1 and len({batch_signature(b) for b in static}) == 1
    x = torch.randn(batches[0].r.shape[0], 128,
                    generator=torch.Generator().manual_seed(0))
    y = torch.randn(batches[0].z.shape[0], 128,
                    generator=torch.Generator().manual_seed(1))
    for b, s in zip(batches, static):
        for name in WIN_FIELDS:
            assert getattr(s, name) == getattr(b, name) > 0
        assert s.g_index.dst.num_items == s.g_index.dst.max_items()
        assert torch.equal(sorted_segment_sum(x, s.g_index.dst),
                           sorted_segment_sum(x, b.g_index.dst))
        assert torch.equal(windowed_gather_plain(y, s.src, s.win_src),
                           windowed_gather_plain(y, b.src, b.win_src))


def test_profile_step_matches_jax(tmp_path):
    """The port's profile_step on the small property model's train step
    returns the keys of JAX's profile_step with the same types (float
    seconds and edges/s, the trace directory), and writes its Chrome
    trace.  JAX's runs a jitted step of a small state: its result does
    not depend on what the step computes."""
    import jax
    import jax.numpy as jnp

    from alignn_tpu.profiler import profile_step as jprofile
    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.graph.build import rocksalt_graphs
    from alignn_tpu_torch.profiler import TRACE_FILE, memory_stats, \
        profile_step
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    jstep = jax.jit(lambda s, b: (s + 1, {"loss": jnp.sum(b * s)}))
    ref = jprofile(jstep, jnp.ones(4), jnp.arange(4.0), wait=1, warmup=1,
                   active=2, logdir=str(tmp_path / "jax"),
                   edges_per_batch=1000)
    graphs = rocksalt_graphs(2)
    batch = batch_graphs(graphs, BucketSpec.tight_for_batch(graphs),
                         torch.device("cpu"))
    model = _model("property")
    state = create_train_state(model, batch,
                               build_optimizer("adamw", 1e-3))
    got = profile_step(make_train_step(model), state, batch, wait=1,
                       warmup=1, active=2, logdir=str(tmp_path / "torch"),
                       edges_per_batch=1000)
    assert {k: type(v) for k, v in got.items()} == \
        {k: type(v) for k, v in ref.items()}
    assert got["trace_dir"] == str(tmp_path / "torch")
    assert got["edges_per_s"] == pytest.approx(1000 / got["step_time_s"])
    assert state.step == 4
    with open(os.path.join(got["trace_dir"], TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert memory_stats() == {}       # no CUDA device here


def test_cli_train_profile_writes_trace(tmp_path, capsys):
    """``cli.train --profile DIR --device cpu`` profiles one step on the
    first training batch: it prints and returns profile_step's keys,
    writes DIR/trace.json and trains nothing."""
    from alignn_tpu_torch.cli import train
    from test_torch_port_trainer import write_config, write_folder

    root = write_folder(tmp_path / "d", 8, seed=3)
    config = write_config(tmp_path / "c.json", epochs=1, n_train=4,
                          n_val=2, n_test=2)
    out, trace = str(tmp_path / "out"), str(tmp_path / "trace")
    result = train.main(["--root_dir", root, "--config_name", config,
                         "--output_dir", out, "--profile", trace,
                         "--device", "cpu"])
    assert set(result) == {"step_time_s", "trace_dir", "edges_per_s"}
    assert result["trace_dir"] == trace and result["step_time_s"] > 0
    assert os.path.getsize(os.path.join(trace, "trace.json")) > 0
    assert "step_time_s" in capsys.readouterr().out.splitlines()[-1]
    assert not os.path.exists(os.path.join(out, "history_train.json"))


def test_plots_match_jax(tmp_path):
    """plot_learning_curve on one run directory's histories: the port's
    returns JAX's (train, val) and both write learning_curve.png;
    plot_ff_training writes history.png and parity.png."""
    from alignn_tpu.train.plots import plot_learning_curve as jplot
    from alignn_tpu_torch.train.plots import (plot_ff_training,
                                              plot_learning_curve)

    rng = np.random.default_rng(0)
    dirs = {}
    for who in ("jax", "port"):
        d = tmp_path / who
        d.mkdir()
        for name in ("history_train.json", "history_val.json"):
            (d / name).write_text(json.dumps(
                np.round(rng.random((4, 6)), 6).tolist()
                if who == "jax" else
                json.loads((tmp_path / "jax" / name).read_text())))
        (d / "Val_results.json").write_text(json.dumps([
            {"target": [0.1], "predictions": [0.2],
             "target_grad": [[0.0, 1.0, 2.0]],
             "pred_grad": [[0.1, 0.9, 2.2]]}]))
        dirs[who] = str(d)
    ref = jplot(dirs["jax"], key="loss", plot_train=True)
    got = plot_learning_curve(dirs["port"], key="loss", plot_train=True)
    assert got == ref
    plot_ff_training(dirs["port"])
    for name in ("learning_curve.png", "history.png", "parity.png"):
        assert os.path.getsize(os.path.join(dirs["port"], name)) > 0
    assert os.path.getsize(os.path.join(dirs["jax"],
                                        "learning_curve.png")) > 0


def test_new_modules_are_walked():
    """``test_port_imports_no_jax`` imports every module that
    ``pkgutil.walk_packages`` finds in the port, in a process of its own,
    and fails on any JAX module: the profiler, the plots and the step
    loop are among them."""
    import pkgutil

    import alignn_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(
        alignn_tpu_torch.__path__, "alignn_tpu_torch.")}
    assert {"alignn_tpu_torch.profiler", "alignn_tpu_torch.train.plots",
            "alignn_tpu_torch.ff.step_loop",
            "alignn_tpu_torch.cli.train"} <= names


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def deterministic():
    """torch's deterministic algorithms (warn only), restored after:
    ``index_add`` (the segment sums of ``ops/segment.py`` and the
    transpose of ``x[idx]``) otherwise adds by CUDA atomics, in an order
    that varies from run to run, so that no two runs, captured or eager,
    agree in their last bits."""
    previous = (torch.are_deterministic_algorithms_enabled(),
                torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(previous[0], warn_only=previous[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["property", "ff"])
def test_captured_equals_eager_on_the_card(kind, cuda, deterministic):
    """12 steps over the loader's batches (a learning-rate change after
    the sixth): the captured step's losses and final parameters equal the
    eager step's bit for bit, one graph captured."""
    from alignn_tpu_torch.ff.step_loop import StepLoop

    c0 = StepLoop.captures
    got = _run(kind, cuda, True, steps=12)
    assert StepLoop.captures - c0 == 1
    ref = _run(kind, cuda, False, steps=12)
    assert StepLoop.captures - c0 == 1
    _assert_bitwise(got[0], ref[0], "losses")
    _assert_bitwise(got[2], ref[2], "parameters")


@pytest.mark.cuda
def test_signatures_capture_once_seen_thrice(cuda):
    """A signature seen twice runs eagerly (no capture); its third
    sighting captures; a second bucket captures again on its own third
    sighting; the eval step shares the model's pool and captures too."""
    from alignn_tpu_torch.ff.step_loop import WARMUP_STEPS, StepLoop
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import (create_train_state,
                                              make_eval_step,
                                              make_train_step)

    a = list(_loader(cuda, batch_size=3))
    b = list(_loader(cuda, n=8, batch_size=4))
    model = _model("property")
    state = create_train_state(model, a[0], build_optimizer("adamw", 1e-3))
    step, ev = make_train_step(model), make_eval_step(model)
    c0 = StepLoop.captures
    for i in range(WARMUP_STEPS):
        step(state, a[i % len(a)])
        step(state, b[i % len(b)])
    assert StepLoop.captures == c0
    step(state, a[0])
    assert StepLoop.captures == c0 + 1
    step(state, b[1])
    assert StepLoop.captures == c0 + 2
    for _ in range(WARMUP_STEPS + 2):
        losses, res = ev(state, a[1])
    assert StepLoop.captures == c0 + 3
    assert torch.isfinite(losses["loss"]) and res["out"].is_cuda
    assert len(step.compiled.loops) == 2 and step.compiled.captures == 2


SYNC_IN_STEP = """
import torch
from alignn_tpu_torch.ff.step_loop import CompiledStep, WARMUP_STEPS
from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
from alignn_tpu_torch.graph.build import rocksalt_graphs

gs = rocksalt_graphs(2)
batch = batch_graphs(gs, BucketSpec.tight_for_batch(gs), torch.device("cuda"))
calls = []

def fn(b):
    calls.append(1)
    return {"x": b.r * float(b.r.sum().item())}   # a host sync

step = CompiledStep(fn)
for _ in range(WARMUP_STEPS):
    step(batch)
try:
    step(batch)
except RuntimeError as exc:
    print("raised", len(calls), type(exc).__name__)
else:
    print("ran", len(calls))
"""


@pytest.mark.cuda
def test_host_sync_in_step_raises(cuda):
    """A step that syncs with the host runs its eager sightings, then its
    capture raises (in a process of its own: a failed capture may leave
    the context unusable); nothing runs it eagerly instead."""
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", SYNC_IN_STEP], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[:2] == ["raised", "3"], proc.stdout
