"""alignn_tpu_torch's remat_layers, fp8 L-tables and training dtypes
against alignn_tpu on the CPU.

(a) ``TrainingConfig.dtype``: an unknown name raises KeyError in both
packages; a bf16 and an f16 run train through ``cli.train``, and a run
directory trained in bf16 serves in f32 in both packages (``zoo``,
``Calculator``, ``iCalculator``, ``cli.predict``); (b) the two switches
that raised before this port had them, ``remat_layers`` and
``ALIGNN_TPU_FP8_LTABLES``, build every model family and give JAX's
forward; (c) ``remat_layers``: the train step equals the port's step
without it on every path (the force loss's gradient of a gradient goes
through the recomputed layers) and JAX's remat step, BatchNorm
statistics included; (d) the fp8 L-tables: ``quantize_e4m3`` bit for bit
against JAX's, zero rows, the straight-through gradient at two orders,
a dense train step and a sparse forward against JAX's (mirrors of
``tests/test_fp8.py``, the sparse forward within the switches' test).
Models are 2+1 layers of width 32 where a switch acts between ALIGNN
layers, else 1+1.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_precision import (FF, LIMITS, PATHS,  # noqa: F401
                                       SMALL, _np, _two_threads,
                                       batches_for, deviation, graphs_for,
                                       jax_step, numpy_variables, port_model,
                                       port_step)
from test_torch_port_trainer import write_config, write_folder

TWO = dict(SMALL, alignn_layers=2)   # a switch acting between ALIGNN layers
SPLIT = dict(n_train=4, n_val=2, n_test=2, batch_size=2)
FAMILY = {"alignn": dict(name="alignn", **TWO),
          "alignn_atomwise": dict(FF, **TWO),
          "ealignn_atomwise": dict(name="ealignn_atomwise", **TWO,
                                   stresswise_weight=0.1, inner_cutoff=2.5)}


def _jax_model(cfg: dict):
    from alignn_tpu.config import model_config_from_dict as jcfg
    from alignn_tpu.train.trainer import build_model as jbuild

    return jbuild(jcfg(cfg))


def forward_pair(cfg: dict, layout: str = "sparse", jax_too: bool = True):
    """The eval-mode forward of the port and of JAX on the same numpy
    weights and batch: E/F/S for a force field, the output for the
    property model; (port, jax) dicts of numpy arrays (jax None without
    `jax_too`)."""
    from alignn_tpu.nn.ealignn import ealignn_forward as jeal
    from alignn_tpu.nn.models import atomwise_forward as jatom
    from alignn_tpu_torch.nn.ealignn import ealignn_forward
    from alignn_tpu_torch.nn.models import atomwise_forward

    tb, jb = batches_for(graphs_for("knn"), layout)
    jm = _jax_model(cfg)
    v = numpy_variables(jm, jb)
    model = port_model(cfg, "float32", v).eval()
    keys = ("en_out", "grad", "stresses")
    if cfg["name"] == "alignn":
        port = {"out": model(tb)}
        jfn = lambda b: {"out": jm.apply(v, b, train=False)}  # noqa: E731
    else:
        fwd, jfwd = (ealignn_forward, jeal) \
            if cfg["name"] == "ealignn_atomwise" else (atomwise_forward, jatom)
        port = {k: fwd(model, tb)[k] for k in keys}
        jfn = lambda b: {k: jfwd(jm, v, b, train=False)[k]  # noqa: E731
                         for k in keys}
    ref = {k: np.asarray(x, np.float64)
           for k, x in jax.jit(jfn)(jb).items()} if jax_too else None
    return {k: _np(x) for k, x in port.items()}, ref


def _close(got: dict, ref: dict, rel: float):
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], r, rtol=0,
                                   atol=rel * (np.abs(r).max() + 1e-12),
                                   err_msg=k)


# ---------------------------------------------------------------------------
# (a) the training dtype
# ---------------------------------------------------------------------------


def test_unknown_dtype_raises_as_jax(tmp_path):
    """``dtype`` names outside {float32, bfloat16, float16, float64} raise
    KeyError at the start of ``train_model`` in both packages, before a
    loader is read."""
    from alignn_tpu.config import TrainingConfig as JConfig
    from alignn_tpu.train.trainer import train_model as jtrain
    from alignn_tpu_torch.config import TrainingConfig
    from alignn_tpu_torch.train.trainer import COMPUTE_DTYPES, train_model

    assert set(COMPUTE_DTYPES) == {"float32", "bfloat16", "float16",
                                   "float64"}
    for cls, fn, out in ((TrainingConfig, train_model, "p"),
                         (JConfig, jtrain, "j")):
        cfg = cls.from_dict({"dtype": "float8",
                             "output_dir": str(tmp_path / out)})
        with pytest.raises(KeyError, match="float8"):
            fn(cfg, None, None)


@pytest.fixture(scope="module")
def bf16_run(tmp_path_factory):
    """A force field (1+1/32, forces and stresses in the loss) trained in
    bf16 by ``cli.train`` on the CPU: 8 rocksalt cells in id_prop.json
    (4/2/2), one epoch."""
    from alignn_tpu_torch.cli.train import train_for_folder

    d = tmp_path_factory.mktemp("bf16")
    root = write_folder(d / "data", 8, seed=21, kind="json")
    ff = {k: v for k, v in FF.items() if k != "graphwise_weight"}
    config = write_config(d / "config.json", model=ff, epochs=1,
                          dtype="bfloat16", **SPLIT)
    out = str(d / "out")
    summary = train_for_folder(root_dir=root, config_name=config,
                               output_dir=out, target_key="total_energy",
                               device="cpu")
    return root, out, summary


def test_bf16_and_f16_runs_train_through_cli(bf16_run, tmp_path):
    """The bf16 run's model computes in bf16 and its losses are finite;
    an f16 run of the property model through ``cli.train.main`` gives
    finite losses and its test predictions."""
    from alignn_tpu_torch.cli import train

    _root, out, summary = bf16_run
    model = summary["state"].model
    assert model.dtype == torch.bfloat16
    assert model.trunk.gcn_layers_0.src_gate.dtype == torch.bfloat16
    assert model.fc.dtype is None          # the head promotes to f32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert np.isfinite(summary["step_losses"]).all()
    assert json.load(open(os.path.join(out, "config.json")))["dtype"] == \
        "bfloat16"
    root = write_folder(tmp_path / "d", 8, seed=22)
    config = write_config(tmp_path / "c.json", epochs=1, dtype="float16",
                          **SPLIT)
    f16 = train.main(["--root_dir", root, "--config_name", config,
                      "--output_dir", str(tmp_path / "o"), "--device",
                      "cpu"])
    assert f16["state"].model.dtype == torch.float16
    assert np.isfinite(f16["step_losses"]).all()
    rows = json.load(open(tmp_path / "o" / "Test_results.json"))
    assert rows and all(np.isfinite(r["predictions"]) for r in rows)


def test_bf16_run_serves_in_f32_in_both_packages(bf16_run, capsys):
    """Serving builds an f32 model whatever dtype the run's config.json
    names: the port's ``load_model_dir``, ``Calculator``, ``iCalculator``
    and ``cli.predict``, and JAX's ``load_model_dir`` and ``Calculator``;
    the two packages' energies of one structure agree within 1e-5
    relative."""
    from alignn_tpu.chem.atoms import Atoms as JAtoms
    from alignn_tpu.ff.calculator import Calculator as JCalculator
    from alignn_tpu.zoo import load_model_dir as jload
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.cli import predict
    from alignn_tpu_torch.ff.calculator import Calculator, iCalculator
    from alignn_tpu_torch.nn.layers import Dense
    from alignn_tpu_torch.zoo import load_model_dir

    root, out, _s = bf16_run
    entry = json.load(open(os.path.join(root, "id_prop.json")))[0]
    model, _cfg = load_model_dir(out, device="cpu")
    models = [model, Calculator(path=out, device="cpu").model,
              iCalculator(ff_path=out, prop_path=out, device="cpu")
              ._prop_calc.model]
    for m in models:
        assert m.dtype is None
        assert all(d.dtype is None for d in m.modules()
                   if isinstance(d, Dense))
    jm, _v, _c = jload(out)
    assert jm.dtype is None
    jcalc = JCalculator(path=out)
    assert jcalc.model.dtype is None
    atoms = Atoms.from_dict(entry["atoms"])
    got = Calculator(path=out, device="cpu").calculate(atoms)["energy"]
    ref = jcalc.calculate(JAtoms.from_dict(entry["atoms"]))["energy"]
    assert abs(got - ref) <= 1e-5 * abs(ref) + 1e-6, (got, ref)
    poscar = os.path.join(out, "probe.vasp")
    with open(poscar, "w") as f:
        f.write(atoms.to_poscar())
    rows = predict.main(["--model_path", out, "--file_path", poscar,
                         "--device", "cpu"])
    capsys.readouterr()
    assert np.isfinite(rows[0]["prediction"]).all()


# ---------------------------------------------------------------------------
# (b) the switches that used to raise
# ---------------------------------------------------------------------------

SWITCHES = [("alignn", "remat_layers"), ("alignn_atomwise", "remat_layers"),
            ("alignn", "fp8"), ("alignn_atomwise", "fp8"),
            ("ealignn_atomwise", "fp8")]


@pytest.mark.parametrize("name,switch", SWITCHES,
                         ids=[f"{n}-{s}" for n, s in SWITCHES])
def test_switches_build_and_match_jax(monkeypatch, name, switch):
    """``remat_layers: true`` and a model built while
    ``ALIGNN_TPU_FP8_LTABLES`` is set (JAX's switch: unset, empty and "0"
    are off) build through ``train.trainer.build_model``.  The remat
    forward equals the forward without it within 1e-6 x the largest value
    (JAX's remat step is held in test_remat_step_matches_jax).  The fp8
    forward gives JAX's with the same switch on the same weights within
    1e-3 (both packages round the same tables through e4m3; a value on a
    rounding boundary may fall either way) and differs from the forward
    with "0", which equals the forward with the switch unset; the fp8
    force field's forward stays within the JAX fp8 test's tolerance
    (outputs 5 %, forces 15 % of the largest) of the forward without it
    (a mirror of ``tests/test_fp8.py``'s sparse forward)."""
    from alignn_tpu_torch.config import model_config_from_dict
    from alignn_tpu_torch.train.trainer import build_model

    cfg = dict(FAMILY[name])
    if switch == "remat_layers":
        plain, _ = forward_pair(cfg, jax_too=False)
        cfg["remat_layers"] = True
        assert build_model(model_config_from_dict(cfg)).trunk.remat
        got, _ = forward_pair(cfg, jax_too=False)
        _close(got, plain, 1e-6)
        return
    monkeypatch.setenv("ALIGNN_TPU_FP8_LTABLES", "0")
    off, _ = forward_pair(cfg, jax_too=False)
    if name == "alignn_atomwise":
        monkeypatch.delenv("ALIGNN_TPU_FP8_LTABLES")
        unset, _ = forward_pair(cfg, jax_too=False)
        for k in off:
            np.testing.assert_array_equal(unset[k], off[k])
    monkeypatch.setenv("ALIGNN_TPU_FP8_LTABLES", "1")
    got, ref = forward_pair(cfg)
    _close(got, ref, 1e-3)
    assert any(np.abs(got[k] - off[k]).max() > 0 for k in got)
    if name == "alignn_atomwise":
        e, f = got["en_out"], got["grad"]
        assert np.abs(e - off["en_out"]).max() <= 0.05 * np.abs(
            off["en_out"]).max() + 5e-3
        assert np.abs(f - off["grad"]).max() <= \
            0.15 * np.abs(off["grad"]).max()


# ---------------------------------------------------------------------------
# (c) remat_layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["sparse", "dense", "fused", "windowed",
                                  "envelope"])
def test_remat_step_equals_step_without(monkeypatch, path):
    """On every path of the E/F/S step the port's remat step (f32, and
    bf16 on the dense path) gives the loss and gradients of its step
    without remat within 1e-6 x the largest gradient: the force loss's
    gradient of a gradient goes through the recomputed layers.  Width 32
    but on the windowed path (K8's windows need 128)."""
    cfg, kind, layout, env = PATHS[path]
    if path != "windowed":
        cfg = {**cfg, "hidden_features": 32, "embedding_features": 16}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    from alignn_tpu.config import model_config_from_dict as jcfg
    from alignn_tpu.train.trainer import build_model as jbuild

    tb, jb = batches_for(graphs_for(kind), layout)
    v = numpy_variables(jbuild(jcfg(cfg)), jb)
    for dtype in ("float32",) + (("bfloat16",) if path == "dense" else ()):
        ref = port_step(cfg, dtype, v, tb)
        got = port_step({**cfg, "remat_layers": True}, dtype, v, tb)
        top = max(float(g.abs().max()) for g in ref["grads"].values())
        assert abs(got["loss"] - ref["loss"]) <= 1e-6 * abs(ref["loss"])
        for k, g in ref["grads"].items():
            assert float((got["grads"][k] - g).abs().max()) <= 1e-6 * top, k


@pytest.fixture(scope="module")
def remat_steps():
    """JAX's remat step and the port's remat step and step without it,
    f32, sparse, for the property model and the force field (1+1/32; one
    JAX jit each)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in ("alignn", "alignn_atomwise"):
            cfg = {**PATHS["property" if name == "alignn" else "sparse"][0],
                   "remat_layers": True}
            tb, jb = batches_for(graphs_for("knn"), "sparse")
            v = numpy_variables(_jax_model(cfg), jb)
            mp.setenv("ALIGNN_TPU_FORCE_PALLAS", "1")
            j = jax_step(cfg, "float32", v, jb)
            mp.delenv("ALIGNN_TPU_FORCE_PALLAS")
            no_remat = {k: val for k, val in cfg.items()
                        if k != "remat_layers"}
            out[name] = {"jax": j, "port": port_step(cfg, "float32", v, tb),
                         "plain": port_step(no_remat, "float32", v, tb)}
    return out


@pytest.mark.parametrize("name", ["alignn", "alignn_atomwise"])
def test_remat_step_matches_jax(remat_steps, name):
    """The remat step against JAX's remat step (``nn.remat`` per layer):
    loss within 1e-4 relative, gradients within 1e-3 x the largest, the
    updated parameters within 1e-6 where the gradient's sign is sure;
    for the property model the BatchNorm statistics after the step equal
    JAX's within 1e-5 and the step without remat's exactly (the recompute
    leaves them alone: they move once)."""
    r = remat_steps[name]
    got, ref = r["port"], r["jax"]
    assert abs(got["loss"] - ref["loss"]) <= 1e-4 * abs(ref["loss"])
    top = max(float(np.abs(_np(g)).max()) for g in ref["grads"].values())
    for k, g in ref["grads"].items():
        g = _np(g)
        diff = np.abs(_np(got["grads"][k]) - g).max()
        assert diff <= 1e-3 * top, (k, diff)
        sure = np.abs(g) > 1e-3 * top
        step = np.abs(_np(got["params"][k]) - _np(ref["params"][k]))
        assert step[sure].max(initial=0.0) <= LIMITS["step_same"], k
    if name == "alignn":
        assert ref["stats"] and set(ref["stats"]) == set(got["stats"])
        for k, s in ref["stats"].items():
            np.testing.assert_allclose(_np(got["stats"][k]), _np(s), rtol=0,
                                       atol=1e-5, err_msg=k)
            assert torch.equal(got["stats"][k], r["plain"]["stats"][k]), k
    assert deviation(got["grads"], r["plain"]["grads"]) <= 1e-6 * top


def test_remat_recomputes_in_the_backward():
    """Under remat_layers each layer runs once in the forward and again in
    each backward that passes it, the force pass's and the step's: three
    times.  Without it once."""
    from alignn_tpu_torch.nn.layers import ALIGNNConv

    cfg, kind, layout, _env = PATHS["sparse"]
    tb, jb = batches_for(graphs_for(kind), layout)
    v = numpy_variables(_jax_model(cfg), jb)
    counts = {}
    for remat in (False, True):
        c = {**cfg, "remat_layers": remat}
        model = port_model(c, "float32", v)
        calls = []
        for m in model.modules():
            if isinstance(m, ALIGNNConv):
                m.forward = (lambda f: lambda *a: calls.append(1) or f(*a))(
                    m.forward)
        from alignn_tpu_torch.train.optim import build_optimizer
        from alignn_tpu_torch.train.state import (create_train_state,
                                                  make_train_step)

        state = create_train_state(model, tb,
                                   build_optimizer("adamw", 1e-3, 0.0))
        make_train_step(model)(state, tb)
        counts[remat] = len(calls)
    assert counts[False] == 1 and counts[True] == 3, counts


# ---------------------------------------------------------------------------
# (d) the fp8 L-tables
# ---------------------------------------------------------------------------


def _fp8_inputs():
    """Rows over six decades of scale, a zero row, a row whose largest
    value quantizes at 448 exactly, rows of mixed signs and of values
    below e4m3's smallest normal after scaling."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 256))
         * np.exp(rng.uniform(-7, 7, (64, 1)))).astype(np.float32)
    x[0] = 0.0
    x[1, :] = np.linspace(-448.0, 448.0, 256, dtype=np.float32)
    x[2, :] = rng.uniform(-1e-3, 1e-3, 256).astype(np.float32)
    x[2, 0] = 1.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_e4m3_bit_for_bit(dtype):
    """``quantize_e4m3`` against JAX's (ml_dtypes' e4m3fn): the same
    payload bytes and the same f32 scales, bit for bit, on f32 and bf16
    inputs; the dequantized rows within e4m3's error envelope (JAX's
    test); ``fp8_round_trip`` gives JAX's values bit for bit."""
    from alignn_tpu.ops.fp8 import fp8_round_trip as jrt
    from alignn_tpu.ops.fp8 import quantize_e4m3 as jq
    from alignn_tpu_torch.ops.fp8 import fp8_round_trip, quantize_e4m3

    x = _fp8_inputs()
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    q, scale = quantize_e4m3(tx)
    jqv, jscale = jq(jx)
    assert q.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(q.view(torch.uint8).numpy(),
                                  np.asarray(jqv).view(np.uint8))
    np.testing.assert_array_equal(scale.numpy().view(np.uint32),
                                  np.asarray(jscale).view(np.uint32))
    back = (q.float() * scale).numpy()
    xf = tx.float().numpy()
    rowmax = np.abs(xf).max(axis=-1, keepdims=True)
    assert (np.abs(back - xf) <= np.maximum(np.abs(xf) * 2.0 ** -3,
                                            rowmax * 2.0 ** -9)).all()
    got = fp8_round_trip(tx)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(
        got.float().numpy().view(np.uint32),
        np.asarray(jrt(jx).astype(jnp.float32)).view(np.uint32))


def test_round_trip_handles_zero_rows():
    from alignn_tpu_torch.ops.fp8 import fp8_round_trip

    out = fp8_round_trip(torch.zeros(4, 8))
    assert float(out.abs().max()) == 0.0 and torch.isfinite(out).all()


def test_straight_through_gradient_matches_jax():
    """The gradient of sum(rt(x)^2) is 2 rt(x) exactly (the identity
    through the round trip), and the Hessian-vector product of the force
    training's second order is JAX's."""
    from alignn_tpu.ops.fp8 import fp8_round_trip as jrt
    from alignn_tpu_torch.ops.fp8 import fp8_round_trip

    x = np.random.default_rng(1).standard_normal((8, 16)).astype(np.float32)

    def jf(v):
        return jnp.sum(jrt(v) ** 2)

    jhvp = jax.grad(lambda v: jnp.vdot(jax.grad(jf)(v), v))(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    (g,) = torch.autograd.grad(torch.sum(fp8_round_trip(tx) ** 2), tx,
                               create_graph=True)
    np.testing.assert_array_equal(_np(g), 2 * _np(fp8_round_trip(tx)))
    (hvp,) = torch.autograd.grad(torch.sum(g * tx), tx)
    assert torch.isfinite(hvp).all()
    np.testing.assert_allclose(_np(hvp), np.asarray(jhvp), rtol=1e-6)


def test_dense_train_step_with_fp8_matches_jax(monkeypatch):
    """The dense E/F/S train step (2+1/32, f32) with the fp8 L-tables on
    (the pair aggregation's saved m2 and the L-stage's edge output in
    e4m3): against JAX's step under the same switch, loss within 1e-4
    relative and gradients within 1e-2 x the largest (an m2 value on an
    e4m3 rounding boundary may round either way in the backward); within
    the JAX fp8 test's tolerance (15 % of the largest) of the step without
    it, and not equal to it."""
    cfg = FAMILY["alignn_atomwise"]
    tb, jb = batches_for(graphs_for("knn"), "dense")
    v = numpy_variables(_jax_model(cfg), jb)
    plain = port_step(cfg, "float32", v, tb)
    monkeypatch.setenv("ALIGNN_TPU_FP8_LTABLES", "1")
    monkeypatch.setenv("ALIGNN_TPU_FORCE_PALLAS", "1")
    ref = jax_step(cfg, "float32", v, jb)
    monkeypatch.delenv("ALIGNN_TPU_FORCE_PALLAS")
    got = port_step(cfg, "float32", v, tb)
    assert np.isfinite(got["loss"])
    assert abs(got["loss"] - ref["loss"]) <= 1e-4 * abs(ref["loss"])
    top = max(float(np.abs(_np(g)).max()) for g in ref["grads"].values())
    for k, g in ref["grads"].items():
        diff = np.abs(_np(got["grads"][k]) - _np(g)).max()
        assert diff <= 1e-2 * top, (k, diff)
    moved = deviation(got["grads"], plain["grads"])
    assert 0 < moved
    for k, g in plain["grads"].items():
        assert float((got["grads"][k] - g).abs().max()) <= 0.15 * top, k
