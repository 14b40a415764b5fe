"""alignn_tpu_torch's compute dtypes against alignn_tpu's on the CPU.

One train step (the E/F/S loss, or the property model's l1 loss; AdamW,
lr 1e-3, wd 1e-5) of the port in bfloat16 against JAX's bfloat16 step, on
the same weights (drawn from numpy) and batch, on seven paths (PATHS):
sparse and dense here, fused dense (``ALIGNN_TPU_FUSED_LSTAGE``) and
windowed sparse (``ALIGNN_TPU_ENABLE_WGATHER``) in
``test_torch_port_precision_lstage.py``, the envelope-weighted model, the
property model (BatchNorm) and eALIGNN in
``test_torch_port_precision_models.py``.  JAX runs with
``ALIGNN_TPU_FORCE_PALLAS=1``: its custom-VJP aggregations and gathers,
with the Pallas kernels in interpret mode where the shapes take them, as
its own tests run them.  The models are 1+1 layers of width 32, but for
two paths at width 128: the windowed one (K8 takes F % 128 == 0) and the
envelope one, whose gather transposes JAX sums in bf16 on its CPU
fallback at width 32 (its K2 sums in f32, as the port's does, at 128).
float16 likewise on the sparse path; on the dense layout JAX's float16
step is NaN (its -1e9 mask shift is -inf in f16), so the port's f16
dense step is held against its own f32 step.

Limits, per path:
- the port's bf16 step against JAX's bf16 step: loss within 2e-2
  relative; each parameter's gradient within 3e-2 x max|grad| over the
  whole model (each package's bf16 gradients sit a few per cent of a
  tensor's own max from its f32 ones, independently, so a tensor's own
  scale is no fixed bound).  Where JAX's own bf16 gradient of a tensor
  is farther than half that from its f32 one (a gradient made of
  cancellations: a bias or weight feeding a BatchNorm over two elements'
  rows), the port's distance from its f32 one is held to 3 x JAX's;
- the port's bf16-vs-f32 gradient difference (L2 over every parameter)
  of the size of JAX's: their ratio within 0.5-2.  The f32 step of
  both is the port's, which the per-path tests hold to JAX's f32 step
  (``test_torch_port_train.py`` sparse and dense, ``_lstage.py`` fused,
  ``_gather.py`` windowed, ``_envelope_model.py``, ``_property.py``,
  ``_families.py`` eALIGNN), so JAX compiles its 16-bit steps only;
- the port's own bf16 (or f16) step against its f32 step, the limits
  ``chip_smoke.py`` holds the card's 16-bit steps to (CARD): loss
  components within 2e-2 relative, the gradients' L2 distance within
  5e-2 of their L2 norm and each parameter's within 0.15 x the model's
  largest gradient (a gradient made of cancellations is rounding noise
  of that size in bf16); for the BatchNorm model, whose gradients are
  mostly such noise in bf16 (JAX's own bf16 step sits about 11 % from
  its f32 one here), 0.2 and 0.3 (CARD_BN);
- the updated parameters: where JAX's gradient is larger than twice
  the gradient limit and both packages' bf16 noise, AdamW's first step
  (lr x sign) is the same, within 1e-6; elsewhere within 2 lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

CPU = torch.device("cpu")
LR = 1e-3
WD = 1e-5
SMALL = dict(alignn_layers=1, gcn_layers=1, hidden_features=32,
             embedding_features=16)
FF = dict(name="alignn_atomwise", **SMALL, gradwise_weight=10.0,
          stresswise_weight=0.1, graphwise_weight=1.0)
# path -> (model config, graph kind, layout, environment)
PATHS = {
    "sparse": (FF, "knn", "sparse", {}),
    "dense": (FF, "knn", "dense", {}),
    "fused": (FF, "knn", "dense", {"ALIGNN_TPU_FUSED_LSTAGE": "1"}),
    "windowed": (dict(FF, hidden_features=128), "knn2", "sparse",
                 {"ALIGNN_TPU_ENABLE_WGATHER": "1"}),
    "envelope": (dict(FF, hidden_features=128, embedding_features=32,
                      envelope_edge_weights=True, envelope_cutoff=4.5),
                 "radius", "sparse", {}),
    "property": (dict(name="alignn", **SMALL), "knn", "sparse", {}),
    "ealignn": (dict(name="ealignn_atomwise", **SMALL, stresswise_weight=0.1,
                     inner_cutoff=2.5), "knn", "sparse", {}),
}
LIMITS = {"loss_rel": 2e-2, "grad_rel": 3e-2, "ratio": (0.5, 2.0),
          "step_same": 1e-6}
CARD = {"loss_rel": 2e-2, "l2_rel": 5e-2, "grad_top": 0.15}
CARD_BN = {"loss_rel": 2e-2, "l2_rel": 0.2, "grad_top": 0.3}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "float16": torch.float16}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads while a precision module runs (the others import
    this fixture): the suite runs its files in parallel workers, whose
    default thread counts would oversubscribe the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _np(x):
    return np.asarray(x.detach().float()) if isinstance(x, torch.Tensor) \
        else np.asarray(x, dtype=np.float64)


def graphs_for(kind: str):
    """bench.py's rattled rocksalt cells: four k-NN graphs, two (the
    windowed path, at width 128), or four radius-4.5 graphs (the envelope
    potentials' graph)."""
    from alignn_tpu_torch.graph.build import rocksalt_graphs

    if kind == "radius":
        return rocksalt_graphs(4, seed=0, neighbor_strategy="radius_graph",
                               cutoff=4.5, use_canonize=False)
    return rocksalt_graphs(2 if kind == "knn2" else 4, seed=0)


def batches_for(graphs, layout: str):
    """(port batch, JAX batch) of `graphs` in `layout`, with the gather
    windows of both packages."""
    from alignn_tpu.graph.batch import BucketSpec as JSpec
    from alignn_tpu.graph.batch import batch_graphs as jbatch
    from alignn_tpu.graph.build import GraphData as JGraph
    from alignn_tpu.graph.dense import dense_batch_graphs as jdense
    from alignn_tpu.graph.dense import dense_spec_for_batch as jdspec
    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.graph.dense import (dense_batch_graphs,
                                              dense_spec_for_batch)

    jgraphs = [JGraph(**vars(g)) for g in graphs]
    if layout == "dense":
        return (dense_batch_graphs(graphs, dense_spec_for_batch(graphs), CPU,
                                   target_width=1),
                jdense(jgraphs, jdspec(jgraphs), target_width=1))
    return (batch_graphs(graphs, BucketSpec.tight_for_batch(graphs), CPU,
                         target_width=1),
            jbatch(jgraphs, JSpec.tight_for_batch(jgraphs), target_width=1))


def numpy_variables(jm, jb, seed: int = 0) -> dict:
    """JAX's variable tree of `jm` with every parameter redrawn from
    numpy: Dense kernels and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    norm scales 1 + 0.1 N(0, 1) and norm biases 0.1 N(0, 1); BatchNorm
    statistics at (0, 1)."""
    from alignn_tpu.nn.ealignn import eALIGNNAtomWise as JEal
    from alignn_tpu.nn.models import ALIGNNAtomWise as JAtomWise

    if isinstance(jm, JEal):
        args = (jb, jb.frac_coords)
    elif isinstance(jm, JAtomWise):
        args = (jb, jb.r)
    else:
        args = (jb,)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args,
                                            train=False))
    rng = np.random.default_rng(seed)

    def draw(node):
        out = {}
        if "kernel" in node:
            bound = 1.0 / np.sqrt(node["kernel"].shape[0])
            for k, leaf in node.items():
                out[k] = rng.uniform(-bound, bound, leaf.shape).astype(
                    np.float32)
            return out
        if "scale" in node:
            return {"scale": (1.0 + 0.1 * rng.standard_normal(
                        node["scale"].shape)).astype(np.float32),
                    "bias": (0.1 * rng.standard_normal(
                        node["bias"].shape)).astype(np.float32)}
        return {k: draw(v) for k, v in node.items()}

    v = {"params": draw(dict(shapes["params"]))}
    if "batch_stats" in shapes:
        v["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, s: (np.ones if p[-1].key == "var" else np.zeros)(
                s.shape, np.float32), dict(shapes["batch_stats"]))
    return v


def jax_step(cfg: dict, dtype: str, v: dict, jb) -> dict:
    """JAX's train step (``make_train_step``'s body, one jit) from
    variables `v`: the losses, the gradients, the updated parameters and
    the new BatchNorm statistics, as port state dicts."""
    import optax
    from flax import core

    from alignn_tpu.config import model_config_from_dict as jcfg
    from alignn_tpu.train.optim import build_optimizer as jbuild
    from alignn_tpu.train.state import _forward_and_loss as jloss
    from alignn_tpu.train.trainer import build_model as jbuild_model
    from alignn_tpu_torch.nn.convert import state_dict_from_flax

    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
           "float16": jnp.float16}[dtype]
    jm = jbuild_model(jcfg(cfg), dtype=jdt)
    tx = jbuild("adamw", LR, WD)
    stats = core.freeze(v.get("batch_stats", {}))

    def step(params, stats):
        grads, (losses, _res, new_stats) = jax.grad(
            lambda p: jloss(jm, p, stats, jb, "l1", False, True),
            has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates), new_stats, losses, grads

    params, new_stats, losses, grads = jax.device_get(
        jax.jit(step)(v["params"], stats))
    tree = lambda t: state_dict_from_flax(jax.tree_util.tree_map(  # noqa
        lambda a: np.asarray(a, np.float32), t))
    out = {"loss": float(losses["loss"]), "grads": tree(grads),
           "params": tree(params)}
    if new_stats:
        out["stats"] = {k: v for k, v in state_dict_from_flax(
            jax.tree_util.tree_map(lambda a: np.asarray(a), params),
            batch_stats=new_stats).items() if k.endswith((".mean", ".var"))}
    return out


def port_model(cfg: dict, dtype: str, v: dict):
    from alignn_tpu_torch.config import model_config_from_dict
    from alignn_tpu_torch.nn.convert import state_dict_from_flax
    from alignn_tpu_torch.train.trainer import build_model

    model = build_model(model_config_from_dict(cfg), dtype=TORCH[dtype])
    model.load_state_dict(state_dict_from_flax(
        v["params"], batch_stats=v.get("batch_stats")))
    return model


def port_step(cfg: dict, dtype: str, v: dict, tb) -> dict:
    """The port's train step from the same variables: as jax_step."""
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    model = port_model(cfg, dtype, v)
    state = create_train_state(model, tb, build_optimizer("adamw", LR, WD))
    state, losses = make_train_step(model, "l1")(state, tb)
    out = {"loss": float(losses["loss"]),
           "grads": {k: p.grad.detach().clone()
                     for k, p in model.named_parameters()},
           "params": {k: p.detach().clone()
                      for k, p in model.named_parameters()}}
    if state.batch_stats:
        out["stats"] = {k: t.detach().clone()
                        for k, t in state.batch_stats.items()}
    return out


def run_path(path: str, dtypes, port_only=()) -> dict:
    """{dtype: {"jax": jax_step, "port": port_step}} of `path`, in each
    of `dtypes` (JAX in the 16-bit ones not in `port_only`), from one
    draw of weights; JAX runs with its Pallas paths forced (interpret
    mode), both under the path's switches."""
    cfg, kind, layout, path_env = PATHS[path]
    tb, jb = batches_for(graphs_for(kind), layout)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for k, val in path_env.items():
            mp.setenv(k, val)
        from alignn_tpu.config import model_config_from_dict as jcfg
        from alignn_tpu.train.trainer import build_model as jbuild_model

        v = numpy_variables(jbuild_model(jcfg(cfg)), jb)
        for dtype in dtypes:
            out[dtype] = {"port": port_step(cfg, dtype, v, tb)}
            if dtype != "float32" and dtype not in port_only:
                mp.setenv("ALIGNN_TPU_FORCE_PALLAS", "1")
                out[dtype]["jax"] = jax_step(cfg, dtype, v, jb)
                mp.delenv("ALIGNN_TPU_FORCE_PALLAS")
    out["batch"] = tb
    return out


def gradient_limit(grads: dict) -> float:
    """grad_rel x the model's largest |grad|."""
    return LIMITS["grad_rel"] * max(float(np.abs(_np(g)).max())
                                    for g in grads.values())


def check_step(got: dict, ref: dict, f32: dict):
    """The port's step (`got`) against JAX's (`ref`) in one 16-bit dtype,
    with the limits of the module docstring; `f32` is the port's f32
    step from the same weights."""
    assert np.isfinite(got["loss"]) and np.isfinite(ref["loss"])
    assert abs(got["loss"] - ref["loss"]) <= \
        LIMITS["loss_rel"] * abs(ref["loss"]), (got["loss"], ref["loss"])
    assert set(got["grads"]) == set(ref["grads"])
    lim = gradient_limit(ref["grads"])
    for k, g in ref["grads"].items():
        g, p = _np(g), _np(got["grads"][k])
        noise_j = np.abs(g - _np(f32["grads"][k])).max()
        noise_p = np.abs(p - _np(f32["grads"][k])).max()
        if noise_j <= lim / 2:
            diff = np.abs(p - g).max()
            assert diff <= lim, (k, diff, lim)
        else:
            assert noise_p <= 3 * noise_j, (k, noise_p, noise_j)
        sure = np.abs(g) > 2 * max(lim, noise_j, noise_p)
        step = np.abs(_np(got["params"][k]) - _np(ref["params"][k]))
        assert step[sure].max(initial=0.0) <= LIMITS["step_same"], k
        assert step.max() <= 2 * LIMITS["step_same"] + 2 * LR, k


def check_against_f32(got: dict, ref: dict, card: dict = CARD):
    """A 16-bit step of the port against its f32 step, at `card`."""
    assert abs(got["loss"] - ref["loss"]) <= card["loss_rel"] * \
        abs(ref["loss"]), (got["loss"], ref["loss"])
    norm = np.sqrt(sum((_np(g) ** 2).sum() for g in ref["grads"].values()))
    assert deviation(got["grads"], ref["grads"]) <= card["l2_rel"] * norm
    top = max(float(np.abs(_np(g)).max()) for g in ref["grads"].values())
    for k, g in ref["grads"].items():
        diff = np.abs(_np(got["grads"][k]) - _np(g)).max()
        assert diff <= card["grad_top"] * top, (k, diff, top)


def deviation(a: dict, b: dict) -> float:
    """L2 distance of two gradient sets over every parameter."""
    return float(np.sqrt(sum(((_np(a[k]) - _np(b[k])) ** 2).sum()
                             for k in b)))


def check_bf16_path(r: dict):
    """A path's bf16 step against JAX's (check_step), its BatchNorm
    statistics after the step within 2e-2 x their max, and bf16's
    distance from f32 of JAX's size: the ratio of the port's and JAX's
    L2 distances from the f32 step in 0.5-2, both nonzero (bf16 did
    run)."""
    f32, r16 = r["float32"]["port"], r["bfloat16"]
    check_step(r16["port"], r16["jax"], f32)
    for k, ref in r16["jax"].get("stats", {}).items():
        np.testing.assert_allclose(_np(r16["port"]["stats"][k]), ref,
                                   rtol=0, atol=2e-2 * np.abs(ref).max(),
                                   err_msg=k)
    d_port = deviation(r16["port"]["grads"], f32["grads"])
    d_jax = deviation(r16["jax"]["grads"], f32["grads"])
    assert d_port > 0 and d_jax > 0
    lo, hi = LIMITS["ratio"]
    assert lo <= d_port / d_jax <= hi, (d_port, d_jax)
    check_against_f32(r16["port"], f32,
                      CARD_BN if "stats" in r16["jax"] else CARD)


HERE = ("sparse", "dense")


@pytest.fixture(scope="module")
def steps():
    """The sparse and dense paths in f32, bf16 and f16, both packages but
    for f16 dense, the port's alone (one JAX jit each; one draw of weights
    a path)."""
    return {path: run_path(path, ("float32", "bfloat16", "float16"),
                           port_only=("float16",) if path == "dense" else ())
            for path in HERE}


@pytest.mark.parametrize("path", HERE)
def test_bf16_step_matches_jax(steps, path):
    """The port's bf16 train step against JAX's bf16 step, and bf16's
    distance from f32 of JAX's size (limits in the module docstring)."""
    check_bf16_path(steps[path])


def test_f16_sparse_step_matches_jax(steps):
    """The port's f16 sparse step against JAX's, with the bf16 limits;
    f16's distance from f32 is JAX's size (0.5-2) and smaller than
    bf16's (f16 keeps 10 mantissa bits, bf16 7)."""
    r = steps["sparse"]
    f32, r16 = r["float32"]["port"], r["float16"]
    check_step(r16["port"], r16["jax"], f32)
    check_against_f32(r16["port"], f32)
    d_port = deviation(r16["port"]["grads"], f32["grads"])
    d_jax = deviation(r16["jax"]["grads"], f32["grads"])
    lo, hi = LIMITS["ratio"]
    assert 0 < d_port and lo <= d_port / d_jax <= hi, (d_port, d_jax)
    assert d_port < deviation(r["bfloat16"]["port"]["grads"], f32["grads"])


def test_f16_dense_step_against_f32(steps):
    """The port's f16 dense step against its own f32 step at CARD (JAX's
    f16 dense step is NaN from two ALIGNN layers on, see
    test_f16_dense_mask_shift_stays_finite), and its distance from f32 of
    the sparse path's size (0.5-2)."""
    r32, r16 = steps["dense"]["float32"], steps["dense"]["float16"]
    got, ref = r16["port"], r32["port"]
    check_against_f32(got, ref)
    sparse = steps["sparse"]
    d_dense = deviation(got["grads"], ref["grads"])
    d_sparse = deviation(sparse["float16"]["port"]["grads"],
                         sparse["float32"]["port"]["grads"])
    lo, hi = LIMITS["ratio"]
    assert lo <= d_dense / d_sparse <= hi, (d_dense, d_sparse)


def test_f16_dense_mask_shift_stays_finite():
    """JAX folds a masked slot into the logits as -1e9 cast to the table's
    dtype: -inf in f16, so the edge tail's LayerNorm of a masked pair row
    is NaN, and with two ALIGNN layers the second reads those rows and
    JAX's f16 dense energy is NaN (a reference quirk).  The port's f16
    shift is 2^12 (a sigmoid of exactly 0 all the same): its f16 energies
    and forces are finite and within 2e-2 of its f32 ones."""
    from alignn_tpu.config import model_config_from_dict as jcfg
    from alignn_tpu.nn.models import atomwise_forward as jforward
    from alignn_tpu.train.trainer import build_model as jbuild
    from alignn_tpu_torch.nn.models import atomwise_forward

    cfg = dict(FF, alignn_layers=2)
    tb, jb = batches_for(graphs_for("knn"), "dense")
    v = numpy_variables(jbuild(jcfg(cfg)), jb)
    jm = jbuild(jcfg(cfg), dtype=jnp.float16)
    jres = jax.jit(lambda b: jforward(jm, v, b, train=False))(jb)
    assert not np.isfinite(np.asarray(jres["en_out"])).all()
    res = {dt: atomwise_forward(port_model(cfg, dt, v).eval(), tb)
           for dt in ("float32", "float16")}
    for k in ("en_out", "grad"):
        got, ref = _np(res["float16"][k]), _np(res["float32"][k])
        assert np.isfinite(got).all()
        assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max(), k
