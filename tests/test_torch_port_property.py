"""alignn_tpu_torch's ALIGNN property model (masked BatchNorm) against
alignn_tpu's, on the CPU.

(a) ``MaskedBatchNorm`` with padded rows, train and eval mode; (b) the
``ALIGNN`` forward in train and eval mode, sparse and dense, with the
identity, log and logit links and as a classifier; (c) one train step's
loss, gradients and running statistics against JAX's step function;
(d) the sparse and dense port models against each other; (e) with
``ALIGNN_TPU_FUSED_LSTAGE=1`` a BatchNorm model keeps the unfused K4
L-stage.  Inputs come from numpy seeds; the JAX weights and batch_stats
reach the port through ``nn/convert.py``.  2+2 layers, hidden 32, four
rattled rocksalt cells.
"""

import jax
import numpy as np
import pytest
import torch
from torch_port_threads import _two_threads  # noqa: E402,F401

CPU = torch.device("cpu")
SMALL = dict(alignn_layers=2, gcn_layers=2, hidden_features=32,
             embedding_features=16)
HEADS = {"identity": dict(link="identity"), "log": dict(link="log"),
         "logit": dict(link="logit"),
         "classification": dict(classification=True)}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _leaves_close(got: dict, ref, tol: float):
    """Every leaf of the nested dict `got` within tol of the flax tree."""
    ref = jax.tree_util.tree_map(np.asarray, ref)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)


@pytest.fixture(scope="module")
def batches():
    """The four cells as port and JAX batches, sparse and dense."""
    from alignn_tpu.graph.batch import BucketSpec as JSpec
    from alignn_tpu.graph.batch import batch_graphs as jbatch
    from alignn_tpu.graph.build import GraphData as JGraph
    from alignn_tpu.graph.dense import dense_batch_graphs as jdense
    from alignn_tpu.graph.dense import dense_spec_for_batch as jdspec
    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.graph.build import rocksalt_graphs
    from alignn_tpu_torch.graph.dense import (dense_batch_graphs,
                                              dense_spec_for_batch)

    graphs = rocksalt_graphs(4, seed=1, rattle=0.03)
    graphs[2].target = np.array([2.5])     # a spread of labels
    jgraphs = [JGraph(**vars(g)) for g in graphs]
    return {
        "sparse": (batch_graphs(graphs, BucketSpec.tight_for_batch(graphs),
                                CPU),
                   jbatch(jgraphs, JSpec.tight_for_batch(jgraphs),
                          gather_windows=False)),
        "dense": (dense_batch_graphs(graphs, dense_spec_for_batch(graphs),
                                     CPU),
                  jdense(jgraphs, jdspec(jgraphs)))}


@pytest.fixture(scope="module")
def jax_variables(batches):
    """{layout: JAX variables of the identity-head model}, with the
    running statistics moved away from their (0, 1) start so that eval
    mode reads them."""
    from alignn_tpu.nn.models import ALIGNN as JModel
    from alignn_tpu.nn.models import ALIGNNConfig as JConfig

    jm = JModel(cfg=JConfig(**SMALL))
    out = {}
    for layout, (_tb, jb) in batches.items():
        v = jax.jit(lambda k, b: jm.init(k, b, train=False))(
            jax.random.PRNGKey(0), jb)
        rng = np.random.default_rng(3)
        stats = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + 0.2 * rng.random(a.shape).astype(
                np.float32), v["batch_stats"])
        out[layout] = {"params": jax.tree_util.tree_map(np.asarray,
                                                        v["params"]),
                       "batch_stats": stats}
    return out


def _models(head: str, variables):
    """(JAX model of `head`, its variables, the port model carrying the
    same weights and statistics).  A classifier's head gets its own
    [hidden, 2] weights from numpy."""
    from alignn_tpu.nn.models import ALIGNN as JModel
    from alignn_tpu.nn.models import ALIGNNConfig as JConfig
    from alignn_tpu_torch.nn.convert import state_dict_from_flax
    from alignn_tpu_torch.nn.models import ALIGNN, ALIGNNConfig

    params = dict(variables["params"])
    if head == "classification":
        rng = np.random.default_rng(4)
        params["fc"] = {
            "kernel": rng.uniform(-0.2, 0.2, (32, 2)).astype(np.float32),
            "bias": rng.uniform(-0.2, 0.2, 2).astype(np.float32)}
    v = {"params": params, "batch_stats": variables["batch_stats"]}
    model = ALIGNN(ALIGNNConfig(**SMALL, **HEADS[head]))
    model.load_state_dict(state_dict_from_flax(
        params, batch_stats=v["batch_stats"]))
    return JModel(cfg=JConfig(**SMALL, **HEADS[head])), v, model


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_masked_batchnorm_matches_jax(train):
    """Output of the real rows within 1e-6 x max|out| (f32 rounding of the
    two packages' rsqrt and sums), and in train mode the updated running
    mean and variance within 1e-6, with padded rows (mask 0, holding large
    values) in the input; the padded rows' outputs within 1e-6
    relative."""
    from alignn_tpu.nn.layers import MaskedBatchNorm as JBN
    from alignn_tpu_torch.nn.layers import MaskedBatchNorm

    rng = np.random.default_rng(0)
    x = rng.standard_normal((37, 16)).astype(np.float32) * 2 + 0.5
    mask = np.ones(37, np.float32)
    mask[-5:] = 0
    x[-5:] = 1e4
    jbn = JBN()
    v = jbn.init(jax.random.PRNGKey(0), x, mask=mask,
                 use_running_average=True)
    stats = {"mean": rng.standard_normal(16).astype(np.float32),
             "var": rng.random(16).astype(np.float32) + 0.5}
    params = {"scale": rng.standard_normal(16).astype(np.float32),
              "bias": rng.standard_normal(16).astype(np.float32)}
    assert set(v["params"]) == set(params)
    ref, upd = jbn.apply({"params": params, "batch_stats": stats}, x,
                         mask=mask, use_running_average=not train,
                         mutable=["batch_stats"])
    bn = MaskedBatchNorm(16)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(params["scale"]))
        bn.bias.copy_(torch.tensor(params["bias"]))
        bn.mean.copy_(torch.tensor(stats["mean"]))
        bn.var.copy_(torch.tensor(stats["var"]))
    bn.train(not train)   # the explicit argument wins over the mode
    got = _np(bn(torch.tensor(x), torch.tensor(mask), train=train))
    ref = np.asarray(ref)
    real = mask > 0
    np.testing.assert_allclose(got[real], ref[real], rtol=0,
                               atol=1e-6 * np.abs(ref[real]).max())
    # the padded rows' outputs are large and only relatively close
    np.testing.assert_allclose(got[~real], ref[~real], rtol=1e-6)
    new = upd["batch_stats"] if train else stats
    np.testing.assert_allclose(_np(bn.mean), np.asarray(new["mean"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(bn.var), np.asarray(new["var"]),
                               rtol=0, atol=1e-6)
    if train:   # the unbiased estimate moved the running variance
        assert not np.allclose(_np(bn.var), stats["var"])


@pytest.mark.parametrize("layout", ["sparse", "dense"])
@pytest.mark.parametrize("head", list(HEADS))
def test_alignn_forward_matches_jax(batches, jax_variables, layout, head):
    """Train mode (batch statistics; running statistics moved once) and
    eval mode (running statistics): the real graphs' outputs within
    1e-5 x max|out|, the moved statistics within 1e-5."""
    from alignn_tpu_torch.nn.convert import flax_from_module

    tb, jb = batches[layout]
    jm, v, model = _models(head, jax_variables[layout])
    (ref_train, upd), ref_eval = jax.jit(lambda vv, b: (
        jm.apply(vv, b, train=True, mutable=["batch_stats"]),
        jm.apply(vv, b, train=False)))(v, jb)
    real = np.asarray(jb.graph_mask) > 0
    model.eval()
    got_eval = _np(model(tb))
    model.train()
    got_train = _np(model(tb))
    for got, ref in ((got_train, ref_train), (got_eval, ref_eval)):
        ref = np.asarray(ref)[real]
        assert got.shape[1] == (2 if head == "classification" else 1)
        np.testing.assert_allclose(got[real], ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    _leaves_close(flax_from_module(model)[1], upd["batch_stats"], 1e-5)


@pytest.mark.parametrize("layout", ["sparse", "dense"])
def test_alignn_train_step_matches_jax(batches, jax_variables, layout):
    """One train step (l1 loss, train mode) against the function JAX's
    ``make_train_step`` differentiates: loss within 1e-4 relative, each
    parameter's gradient within 1e-3 x its max|grad| + 1e-7, the new
    running statistics within 1e-5.  The biases that feed a BatchNorm
    (``linear.bias``, ``src_update.bias``) have a gradient of exactly 0
    in exact arithmetic, so theirs is rounding noise: in both packages it
    stays within 1e-3 x the largest gradient of the model + 1e-7.  The
    port's step then moves the weights."""
    from alignn_tpu.train.state import _forward_and_loss
    from alignn_tpu_torch.nn.convert import (flax_from_module,
                                             state_dict_from_flax)
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    tb, jb = batches[layout]
    jm, v, model = _models("identity", jax_variables[layout])

    def loss_fn(params, bs, b):
        return _forward_and_loss(jm, params, bs, b, "l1", False, train=True)

    (jloss, (_l, _r, jstats)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"], v["batch_stats"], jb)
    state = create_train_state(model, tb, build_optimizer(
        "adamw", 1e-3, 1e-5, model=model))
    before = {k: t.clone() for k, t in model.state_dict().items()}
    grads = {}
    hooks = [p.register_hook(lambda g, n=n: grads.__setitem__(n, g.clone()))
             for n, p in model.named_parameters()]
    state, losses = make_train_step(model, "l1")(state, tb)
    for h in hooks:
        h.remove()
    np.testing.assert_allclose(float(losses["loss"]), float(jloss),
                               rtol=1e-4)
    ref = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    top = max(float(g.abs().max()) for g in ref.values())
    for name, g in ref.items():
        got = grads.get(name, torch.zeros_like(g))
        if name.endswith(("linear.bias", "src_update.bias")):
            for x in (got, g):
                assert float(x.abs().max()) <= 1e-3 * top + 1e-7, name
            continue
        atol = 1e-3 * float(g.abs().max()) + 1e-7
        np.testing.assert_allclose(_np(got), _np(g), rtol=0, atol=atol,
                                   err_msg=name)
    _leaves_close(flax_from_module(model)[1], jstats, 1e-5)
    assert state.step == 1
    assert set(state.batch_stats) == {k for k in before
                                      if k.endswith((".mean", ".var"))}
    moved = [k for k, t in model.state_dict().items()
             if not torch.equal(t, before[k])]
    assert "fc.weight" in moved


def test_sparse_and_dense_port_models_agree(batches):
    """The same port weights on the two layouts: outputs in train and eval
    mode within 1e-5 x max|out|, and the same moved statistics."""
    from alignn_tpu_torch.nn.convert import flax_from_module
    from alignn_tpu_torch.nn.models import ALIGNN, ALIGNNConfig

    outs, stats = {}, {}
    weights = None
    for layout in ("sparse", "dense"):
        model = ALIGNN(ALIGNNConfig(**SMALL))
        if weights is None:
            from alignn_tpu_torch.nn.models import init_parameters

            init_parameters(model, torch.Generator().manual_seed(5))
            weights = {k: t.clone() for k, t in model.state_dict().items()}
        model.load_state_dict(weights)
        tb = batches[layout][0]
        real = tb.graph_mask > 0
        model.eval()
        ev = _np(model(tb)[real])
        model.train()
        outs[layout] = (_np(model(tb)[real]), ev)
        stats[layout] = flax_from_module(model)[1]
    for a, b in zip(outs["dense"], outs["sparse"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())
    _leaves_close(stats["dense"], stats["sparse"], 1e-5)


def test_batchnorm_model_keeps_k4_under_fused_switch(batches, monkeypatch):
    """With ALIGNN_TPU_FUSED_LSTAGE=1 a BatchNorm model runs the dense
    L-stage through K4's path (one call per ALIGNN layer) and never the
    fused one, as JAX's condition on the norm does; a LayerNorm model
    under the same switch takes the fused path."""
    from alignn_tpu_torch.nn import layers
    from alignn_tpu_torch.nn.models import (ALIGNN, ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig,
                                            ALIGNNConfig, atomwise_forward)

    calls = {"K4": 0, "fused": 0}

    def counting(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(layers, "dense_pair_aggregate",
                        counting("K4", layers.dense_pair_aggregate))
    monkeypatch.setattr(layers, "fused_pair_lstage",
                        counting("fused", layers.fused_pair_lstage))
    monkeypatch.setenv("ALIGNN_TPU_FUSED_LSTAGE", "1")
    tb = batches["dense"][0]
    ALIGNN(ALIGNNConfig(**SMALL)).train()(tb)
    assert calls == {"K4": SMALL["alignn_layers"], "fused": 0}
    atomwise_forward(ALIGNNAtomWise(ALIGNNAtomWiseConfig(**SMALL)), tb)
    assert calls == {"K4": SMALL["alignn_layers"],
                     "fused": SMALL["alignn_layers"]}
