"""alignn_tpu_torch's E/F/S training step against alignn_tpu's.

(a) K5b, the second order of the dense pair aggregation, against
``_xla_pair_bwd2`` and the Pallas ``_pair_bwd2_kernel`` (interpret mode);
(b) grad-of-grad through K1, K2, K3 and K4, with inputs of any stride;
(c) the losses; (d) the optimizers and the learning-rate schedule; (e) the
train step, dense and sparse, from the same parameters and batch.
Inputs come from numpy with fixed seeds and go to both packages.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alignn_tpu.ops import pallas_dense as jd
from alignn_tpu_torch.ops import dense as td
from torch_port_threads import _two_threads  # noqa: E402,F401

CPU = torch.device("cpu")
LR = 1e-3


def _np(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(a, b, rtol, atol_rel):
    """|a - b| <= atol_rel * max|b| + rtol * |b|."""
    a, b = _np(a), _np(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=atol_rel * max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# (a) K5b
# ---------------------------------------------------------------------------


def _pair_problem(n=16, D=5, F=128, seed=3):
    """Masked logits (node 0 empty, (1, t=1) a pad row) and random
    cotangents g, u, v."""
    rng = np.random.default_rng(seed)
    em = (rng.random(n * D) < 0.8).astype(np.float32)
    em[:D] = 0.0
    em[D + 1] = 0.0
    lg_mask = (em.reshape(n, 1, D) * em.reshape(n, D, 1)).reshape(-1)
    m2 = rng.standard_normal((n * D * D, F)).astype(np.float32)
    m2 = (m2 + (lg_mask - 1.0)[:, None] * np.float32(1e9)).astype(np.float32)
    bh, g, v = (rng.standard_normal((n * D, F)).astype(np.float32)
                for _ in range(3))
    u = rng.standard_normal((n * D * D, F)).astype(np.float32)
    return m2, bh, g, u, v, em, lg_mask, D


@pytest.mark.parametrize("pallas", [False, True],
                         ids=["xla_pair_bwd2", "pair_bwd2_kernel"])
def test_pair_bwd2_plain_matches_jax(monkeypatch, pallas):
    """K5b's plain version against ``jax.vjp`` of the JAX first-order op,
    whose rule is ``_xla_pair_bwd2`` or, with ALIGNN_TPU_PAIR_BWD_KERNEL=1,
    the Pallas ``_pair_bwd2_kernel`` in interpret mode: rtol 1e-4, atol
    1e-5.  Masked pairs and slots give exact zeros, and nothing is NaN."""
    m2, bh, g, u, v, em, lg_mask, D = _pair_problem()
    calls = []
    if pallas:
        monkeypatch.setenv("ALIGNN_TPU_PAIR_BWD_KERNEL", "1")
        real = jd._pallas_pair_bwd2
        monkeypatch.setattr(jd, "_pallas_pair_bwd2",
                            lambda *a: calls.append(1) or real(*a))
    else:
        monkeypatch.delenv("ALIGNN_TPU_PAIR_BWD_KERNEL", raising=False)
    _, vjp = jax.vjp(lambda a, b, c: jd.pair_aggregate_bwd(a, b, c, D, True),
                     m2, bh, g)
    refs = vjp((jnp.asarray(u), jnp.asarray(v)))
    assert len(calls) == int(pallas)
    got = td.pair_aggregate_bwd2_plain(
        *(torch.tensor(x) for x in (m2, bh, g, u, v)), D)
    for out, ref in zip(got, refs):
        np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-4,
                                   atol=1e-5)
    c_m2, c_bh, c_g = got
    pad_rows = torch.tensor(lg_mask.reshape(-1, D).sum(axis=1) == 0)
    assert pad_rows.sum() >= D + 1
    assert torch.all(c_m2[torch.tensor(lg_mask == 0)] == 0)
    assert torch.all(c_bh[torch.tensor(em == 0)] == 0)
    assert torch.all(c_g[pad_rows] == 0)
    assert all(torch.isfinite(x).all() for x in got)


def test_pair_bwd2_function_wiring():
    """Through the autograd Functions: a loss that touches dm2 and dbh and
    flows back into g, against ``jax.grad`` (rtol 1e-4, atol 1e-5)."""
    m2, bh, g, u, v, _em, _lg, D = _pair_problem(n=8, D=4, F=32, seed=4)

    def jloss(a, b, c):
        dm2, dbh = jd.pair_aggregate_bwd(a, b, c, D, False)
        return jnp.sum(dm2 * u) + jnp.sum(dbh * v) + jnp.sum(dbh ** 2)

    refs = jax.grad(jloss, argnums=(0, 1, 2))(m2, bh, g)
    ts = [torch.tensor(x, requires_grad=True) for x in (m2, bh, g)]
    dm2, dbh = td.pair_aggregate_bwd(*ts, D)
    loss = (torch.sum(dm2 * torch.tensor(u)) + torch.sum(dbh * torch.tensor(v))
            + torch.sum(dbh ** 2))
    for out, ref in zip(torch.autograd.grad(loss, ts), refs):
        np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-4,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# (b) grad-of-grad through K1, K2, K3, K4
# ---------------------------------------------------------------------------


def _operands(op, rng):
    """(JAX fn of its two operands, port fn, the operands as numpy).  K2
    takes one operand; the second is unused."""
    from alignn_tpu.ops import pallas_eggc as je
    from alignn_tpu_torch.ops import eggc as te

    F = 16
    if op in ("K1", "K2"):
        n, e = 12, 60
        dst = np.sort(rng.integers(0, n - 1, size=e))   # node n-1 empty
        seg = te.Segments.from_sorted(torch.tensor(dst), n)
        a = rng.standard_normal((e, F)).astype(np.float32)
        b = rng.standard_normal((e, F)).astype(np.float32)
        jdst = jnp.asarray(dst)
        if op == "K1":
            return (lambda x, y: je.gated_aggregate(x, y, jdst, n, False),
                    lambda x, y: te.gated_aggregate(x, y, seg), a, b)
        return (lambda x, y: je.sorted_segment_sum(x * y, jdst, n, False),
                lambda x, y: te.sorted_segment_sum(x * y, seg), a, b)
    n, D = 6, 4
    em = (rng.random(n * D) < 0.8).astype(np.float32)
    em[:D] = 0.0
    b = rng.standard_normal((n * D, F)).astype(np.float32)
    if op == "K3":
        a = rng.standard_normal((n * D, F)).astype(np.float32)
        return (lambda x, y: jd.dense_gated_aggregate(
                    jd.fold_mask(x, jnp.asarray(em)), y, D, False),
                lambda x, y: td.dense_gated_aggregate(
                    td.fold_mask(x, torch.tensor(em)), y, D), a, b)
    lg = (em.reshape(n, 1, D) * em.reshape(n, D, 1)).reshape(-1)
    a = rng.standard_normal((n * D * D, F)).astype(np.float32)
    return (lambda x, y: jd.dense_pair_aggregate(
                jd.fold_mask(x, jnp.asarray(lg)), y, D, False),
            lambda x, y: td.dense_pair_aggregate(
                td.fold_mask(x, torch.tensor(lg)), y, D), a, b)


def _strided(x: np.ndarray, strided: bool) -> torch.Tensor:
    """x as a leaf tensor, or as the transpose of one: a [rows, F] view
    with strides (1, rows)."""
    if not strided:
        return torch.tensor(x, requires_grad=True)
    return torch.tensor(np.ascontiguousarray(x.T), requires_grad=True).t()


@pytest.mark.parametrize("op,strided", [
    ("K1", False), ("K1", True), ("K2", False), ("K2", True),
    ("K3", False), ("K3", True), ("K4", False), ("K4", True)])
def test_grad_of_grad_matches_jax(op, strided):
    """d/d(a, b) of |d/d(a, b) sum(w * fn(a, b)^2)|^2 against JAX (rtol
    1e-4, atol 1e-5 x max|ref|).  The strided cases hand the Functions
    [rows, F] views with a feature stride of `rows`: a Function that saved
    its unit-stride copy instead of its input lost that input's graph and
    got the second order wrong."""
    rng = np.random.default_rng(5)
    jfn, tfn, a, b = _operands(op, rng)
    w = rng.standard_normal(np.asarray(jfn(a, b)).shape).astype(np.float32)

    def jgg(x, y):
        gx, gy = jax.grad(lambda p, q: jnp.sum(w * jfn(p, q) ** 2),
                          argnums=(0, 1))(x, y)
        return jnp.sum(gx ** 2) + jnp.sum(gy ** 2)

    refs = jax.grad(jgg, argnums=(0, 1))(a, b)
    at, bt = _strided(a, strided), _strided(b, strided)
    assert (at.stride(1) != 1) == strided
    inner = torch.sum(torch.tensor(w) * tfn(at, bt) ** 2)
    gx, gy = torch.autograd.grad(inner, (at, bt), create_graph=True)
    outs = torch.autograd.grad(torch.sum(gx ** 2) + torch.sum(gy ** 2),
                               (at, bt))
    for out, ref in zip(outs, refs):
        _close(out, ref, 1e-4, 1e-5)
    assert np.abs(np.asarray(refs[0])).max() > 0


# ---------------------------------------------------------------------------
# (c) losses
# ---------------------------------------------------------------------------


def _loss_batch(rng, G=4, N=10):
    """A label batch with the last graph and the last two nodes padded."""
    gm = np.ones(G, np.float32)
    gm[-1] = 0
    nm = np.ones(N, np.float32)
    nm[-2:] = 0
    return dict(
        target=rng.standard_normal((G, 2)).astype(np.float32),
        forces=rng.standard_normal((N, 3)).astype(np.float32),
        stress=rng.standard_normal((G, 3, 3)).astype(np.float32),
        atomwise_target=rng.standard_normal((N, 2)).astype(np.float32),
        additional=rng.standard_normal((G, 3)).astype(np.float32),
        graph_mask=gm, node_mask=nm)


@pytest.mark.parametrize("layout", ["sparse", "dense"])
def test_batch_labels_match_jax(layout):
    """The training targets of a batch, array-equal to the JAX builders':
    wider targets, atomwise and additional labels, an unlabelled graph's
    zeros and the padding.  A graph target of another width raises, as in
    JAX."""
    from alignn_tpu.graph.batch import BucketSpec as JSpec
    from alignn_tpu.graph.batch import batch_graphs as jbatch
    from alignn_tpu.graph.build import GraphData as JGraph
    from alignn_tpu.graph.dense import dense_batch_graphs as jdense
    from alignn_tpu.graph.dense import dense_spec_for_batch as jdspec
    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.graph.dense import (dense_batch_graphs,
                                              dense_spec_for_batch)

    rng = np.random.default_rng(8)
    graphs = _rocksalt_graphs(3, seed=1)
    for g in graphs[:2]:
        g.target = rng.standard_normal(2)
        g.atomwise_target = rng.standard_normal((g.num_nodes, 2))
        g.additional = rng.standard_normal(4)   # cut to the batch's 3
    last = graphs[2]
    last.target = last.forces = last.stress = None
    widths = dict(target_width=2, atomwise_width=2, additional_width=3)
    jgraphs = [JGraph(**vars(g)) for g in graphs]
    if layout == "sparse":
        def port(gs):
            return batch_graphs(gs, BucketSpec.tight_for_batch(gs), CPU,
                                **widths)
        ref = jbatch(jgraphs, JSpec.tight_for_batch(jgraphs),
                     gather_windows=False, **widths)
    else:
        def port(gs):
            return dense_batch_graphs(gs, dense_spec_for_batch(gs), CPU,
                                      **widths)
        ref = jdense(jgraphs, jdspec(jgraphs), **widths)
    got = port(graphs)
    for k in ("target", "forces", "stress", "atomwise_target", "additional"):
        np.testing.assert_array_equal(_np(getattr(got, k)),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    assert got.target.shape == (got.graph_mask.shape[0], 2)
    assert float(got.forces.abs().sum()) > 0
    graphs[0].target = np.array([1.0])
    with pytest.raises(ValueError, match="target width 1 != batch"):
        port(graphs)


def test_losses_match_jax():
    """masked_mean, _sanitize, property_loss and the 5-part atomwise_loss
    against JAX (rtol 1e-6).  An inf in a padded row reaches no loss."""
    from alignn_tpu.nn.models import ALIGNNAtomWiseConfig as JConfig
    from alignn_tpu.train import losses as jl
    from alignn_tpu_torch.nn.models import ALIGNNAtomWiseConfig
    from alignn_tpu_torch.train import losses as tl

    rng = np.random.default_rng(6)
    nb = _loss_batch(rng)
    jb = types.SimpleNamespace(**{k: jnp.asarray(v) for k, v in nb.items()})
    tb = types.SimpleNamespace(**{k: torch.tensor(v) for k, v in nb.items()})
    G, N = nb["target"].shape[0], nb["forces"].shape[0]
    res = {"out": rng.standard_normal((G, 2)),
           "atomwise_pred": rng.standard_normal((N, 3)),
           "grad": rng.standard_normal((N, 3)),
           "stresses": rng.standard_normal((G, 3, 3)),
           "additional": rng.standard_normal((G, 4))}
    res = {k: v.astype(np.float32) for k, v in res.items()}
    res["out"][-1] = np.inf                          # the padded graph

    err = rng.standard_normal((N, 3)).astype(np.float32)
    _close(tl.masked_mean(torch.tensor(err), tb.node_mask),
           jl.masked_mean(jnp.asarray(err), jb.node_mask), 1e-6, 0)
    _close(tl._sanitize(torch.tensor(res["out"]), tb.graph_mask),
           jl._sanitize(jnp.asarray(res["out"]), jb.graph_mask), 0, 0)
    for crit in ("l1", "mse", "poisson", "zig"):
        got = tl.property_loss(torch.tensor(res["out"]), tb, crit, False)
        ref = jl.property_loss(jnp.asarray(res["out"]), jb, crit, False)
        assert np.isfinite(_np(got))
        _close(got, ref, 1e-6, 0)
    logp = np.log(rng.dirichlet(np.ones(3), G)).astype(np.float32)
    cls = types.SimpleNamespace(target=torch.tensor([[0.], [2.], [1.], [0.]]),
                                graph_mask=tb.graph_mask)
    jcls = types.SimpleNamespace(target=jnp.asarray(cls.target.numpy()),
                                 graph_mask=jb.graph_mask)
    _close(tl.property_loss(torch.tensor(logp), cls, "l1", True),
           jl.property_loss(jnp.asarray(logp), jcls, "l1", True), 1e-6, 0)

    res["out"][-1] = 0.0
    kw = dict(output_features=2, atomwise_output_features=3,
              additional_output_features=4, graphwise_weight=1.0,
              atomwise_weight=0.5, gradwise_weight=10.0,
              stresswise_weight=0.1, additional_output_weight=0.3)
    got = tl.atomwise_loss({k: torch.tensor(v) for k, v in res.items()}, tb,
                           ALIGNNAtomWiseConfig(**kw))
    ref = jl.atomwise_loss({k: jnp.asarray(v) for k, v in res.items()}, jb,
                           JConfig(**kw))
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], 1e-6, 0)
    assert all(float(ref[f"loss{i}"]) > 0 for i in range(1, 6))


# ---------------------------------------------------------------------------
# (d) optimizers and schedule
# ---------------------------------------------------------------------------

SMALL = dict(name="alignn_atomwise", alignn_layers=1, gcn_layers=1,
             hidden_features=128, embedding_features=32,
             gradwise_weight=10.0, stresswise_weight=0.1,
             graphwise_weight=1.0)


def _rocksalt_graphs(n=4, seed=0):
    """bench.py's rattled rocksalt cells and labels, in its draw order."""
    from alignn_tpu_torch.graph.build import rocksalt_graphs

    return rocksalt_graphs(n, seed)


@pytest.fixture(scope="module")
def jax_small():
    """The small JAX model, initialised on the sparse batch of 4 cells."""
    from alignn_tpu.graph.batch import BucketSpec as JSpec
    from alignn_tpu.graph.batch import batch_graphs as jbatch
    from alignn_tpu.graph.build import GraphData as JGraph
    from alignn_tpu.graph.dense import dense_batch_graphs as jdense
    from alignn_tpu.graph.dense import dense_spec_for_batch as jdspec
    from alignn_tpu.nn.models import ALIGNNAtomWise as JModel
    from alignn_tpu.nn.models import ALIGNNAtomWiseConfig as JConfig

    graphs = _rocksalt_graphs()
    jgraphs = [JGraph(**vars(g)) for g in graphs]
    jbatches = {
        "sparse": jbatch(jgraphs, JSpec.tight_for_batch(jgraphs),
                         target_width=1, gather_windows=False),
        "dense": jdense(jgraphs, jdspec(jgraphs), target_width=1)}
    jmodel = JModel(cfg=JConfig(**SMALL))
    variables = jax.jit(lambda key, b: jmodel.init(key, b, b.r, train=False))(
        jax.random.PRNGKey(0), jbatches["sparse"])
    return graphs, jbatches, jmodel, variables["params"]


def _port_model(params):
    from alignn_tpu_torch.nn.convert import state_dict_from_flax
    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig)

    model = ALIGNNAtomWise(ALIGNNAtomWiseConfig(**SMALL))
    model.load_state_dict(state_dict_from_flax(params))
    return model


def test_no_decay_mask_matches_jax(jax_small):
    from alignn_tpu.train.optim import no_decay_mask as jmask
    from alignn_tpu_torch.nn.convert import state_dict_from_flax
    from alignn_tpu_torch.train.optim import no_decay_mask

    _g, _b, _m, params = jax_small
    ref = {k: bool(v) for k, v in state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jmask(params))).items()}
    got = no_decay_mask(_port_model(params))
    assert got == ref
    assert 0 < sum(got.values()) < len(got)
    assert not got["trunk.gcn_layers_0.norm_nodes.weight"]
    assert not got["trunk.gcn_layers_0.src_gate.bias"]
    assert got["trunk.gcn_layers_0.src_gate.weight"]


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_optimizer_steps_match_optax(jax_small, name):
    """Two updates with random gradients, decay mask on, against optax:
    parameters to 1e-6 absolute (the updates are ~lr = 1e-2)."""
    import optax

    from alignn_tpu.train.optim import build_optimizer as jbuild
    from alignn_tpu_torch.nn.convert import state_dict_from_flax
    from alignn_tpu_torch.train.optim import build_optimizer

    _g, _b, _m, params = jax_small
    rng = np.random.default_rng(7)
    grads = [jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        for _ in range(2)]
    tx = jbuild(name, 1e-2, 0.1, params=params)
    state, jp = tx.init(params), params
    model = _port_model(params)
    opt = build_optimizer(name, 1e-2, 0.1, model=model).init(model)
    named = dict(model.named_parameters())
    for gr in grads:
        updates, state = tx.update(gr, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, v in state_dict_from_flax(gr).items():
            named[k].grad = v
        opt.step()
    for k, v in state_dict_from_flax(jp).items():
        np.testing.assert_allclose(_np(named[k]), _np(v), rtol=0, atol=1e-6,
                                   err_msg=k)


def test_onecycle_matches_jax():
    from alignn_tpu.train.optim import epoch_lr as jepoch
    from alignn_tpu.train.optim import onecycle_lr as jcycle
    from alignn_tpu_torch.train.optim import epoch_lr, onecycle_lr

    for total in (1, 7, 100):
        got, ref = onecycle_lr(1e-3, total), jcycle(1e-3, total)
        assert [got(s) for s in range(total + 2)] == \
            [ref(s) for s in range(total + 2)]
    for sched in ("onecycle", "onecycle_full", "none"):
        assert [epoch_lr(sched, 1e-3, 10, e, 5) for e in range(10)] == \
            [jepoch(sched, 1e-3, 10, e, 5) for e in range(10)]


# ---------------------------------------------------------------------------
# (e) the train step
# ---------------------------------------------------------------------------

STEPS = 4


@pytest.fixture(scope="module")
def trajectories(jax_small):
    """Per layout: JAX's step-0 losses and gradients, its 4-step loss
    trajectory and final parameters; the port's the same, from the same
    parameters and batch (bench.py's optimizer: AdamW, lr 1e-3, wd 1e-5,
    no decay mask)."""
    from flax import core

    from alignn_tpu.train.optim import build_optimizer as jbuild
    from alignn_tpu.train.state import TrainState as JState
    from alignn_tpu.train.state import _forward_and_loss
    from alignn_tpu.train.state import make_train_step as jmake
    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.graph.dense import (dense_batch_graphs,
                                              dense_spec_for_batch)
    from alignn_tpu_torch.nn.convert import state_dict_from_flax
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    graphs, jbatches, jmodel, params = jax_small
    tbatches = {
        "sparse": batch_graphs(graphs, BucketSpec.tight_for_batch(graphs),
                               CPU, target_width=1),
        "dense": dense_batch_graphs(graphs, dense_spec_for_batch(graphs),
                                    CPU, target_width=1)}
    out = {}
    for layout in ("dense", "sparse"):
        jb = jbatches[layout]
        (_, (jl0, _r, _s)), jg = jax.jit(jax.value_and_grad(
            lambda p: _forward_and_loss(jmodel, p, core.FrozenDict(), jb,
                                        "l1", False, True),
            has_aux=True))(params)
        tx = jbuild("adamw", LR, 1e-5)
        jstate = JState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=core.FrozenDict(),
                        opt_state=tx.init(params), tx=tx)
        jstep = jmake(jmodel, "l1", donate=False)
        jtraj = []
        for _ in range(STEPS):
            jstate, jlosses = jstep(jstate, jb)
            jtraj.append({k: float(v) for k, v in jlosses.items()})

        model = _port_model(params)
        state = create_train_state(model, tbatches[layout],
                                   build_optimizer("adamw", LR, 1e-5))
        step = make_train_step(model, "l1")
        traj, grads = [], None
        for i in range(STEPS):
            state, losses = step(state, tbatches[layout])
            traj.append({k: float(v) for k, v in losses.items()})
            if i == 0:   # the update leaves .grad in place until next step
                grads = {k: p.grad.clone()
                         for k, p in model.named_parameters()}
        out[layout] = dict(
            jl0={k: float(v) for k, v in jl0.items()},
            jgrads=state_dict_from_flax(jg), jtraj=jtraj,
            jparams=state_dict_from_flax(jstate.params),
            traj=traj, grads=grads, params=dict(model.named_parameters()),
            steps=state.step)
    return out


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_step0_gradients_match_jax(trajectories, layout):
    """Every parameter's step-0 gradient against ``jax.grad`` of
    ``_forward_and_loss``: rtol 1e-3, atol 1e-5 x that tensor's
    max|grad|.  The loss components to rtol 1e-4."""
    r = trajectories[layout]
    for k, ref in r["jl0"].items():
        np.testing.assert_allclose(r["traj"][0][k], ref, rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert r["jl0"]["loss3"] > 0 and r["jl0"]["loss4"] > 0
    assert set(r["grads"]) == set(r["jgrads"])
    for k, ref in r["jgrads"].items():
        got = r["grads"][k]
        np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-3,
                                   atol=1e-5 * float(ref.abs().max()),
                                   err_msg=k)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_loss_trajectory_matches_jax(trajectories, layout):
    """4 AdamW steps against ``make_train_step``: every loss component to
    rtol 1e-4.  Parameters after the 4 steps within lr / 2 = 5e-4: Adam's
    early steps move an element by about lr sign(g), so an element whose
    gradient is near 0 may step on one side and not the other."""
    r = trajectories[layout]
    assert r["steps"] == STEPS
    for got, ref in zip(r["traj"], r["jtraj"]):
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-7,
                                       err_msg=k)
    assert r["traj"][-1]["loss"] < r["traj"][0]["loss"]
    for k, ref in r["jparams"].items():
        np.testing.assert_allclose(_np(r["params"][k]), _np(ref), rtol=0,
                                   atol=LR / 2, err_msg=k)


def test_dense_and_sparse_steps_agree(trajectories):
    """The JAX invariant of tests/test_dense.py:144-178 in the port: the
    same weights and graphs give the same step-0 losses (rtol 1e-4) and
    gradients (max abs diff <= 1e-3 x max|grad| + 1e-7) in both layouts."""
    d, s = trajectories["dense"], trajectories["sparse"]
    for k in s["traj"][0]:
        np.testing.assert_allclose(d["traj"][0][k], s["traj"][0][k],
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    for k, ref in s["grads"].items():
        diff = float((d["grads"][k] - ref).abs().max())
        assert diff <= 1e-3 * float(ref.abs().max()) + 1e-7, (k, diff)


def test_eval_step_and_state(trajectories, jax_small):
    """make_eval_step gives the step's losses without touching a
    gradient; the state refuses another model; a BatchNorm model's running
    statistics are the state's ``batch_stats``."""
    from alignn_tpu_torch.graph.dense import (dense_batch_graphs,
                                              dense_spec_for_batch)
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import (create_train_state,
                                              make_eval_step,
                                              make_train_step)

    graphs, _jb, _jm, params = jax_small
    batch = dense_batch_graphs(graphs, dense_spec_for_batch(graphs), CPU,
                               target_width=1)
    model = _port_model(params)
    state = create_train_state(model, batch,
                               build_optimizer("adamw", LR, 1e-5, model))
    assert len(state.optimizer.param_groups) == 2
    losses, res = make_eval_step(model)(state, batch)
    np.testing.assert_allclose(
        float(losses["loss"]), trajectories["dense"]["traj"][0]["loss"],
        rtol=1e-5)
    assert all(p.grad is None for p in model.parameters())
    assert not res["grad"].requires_grad
    state.set_lr(5e-4)
    assert all(g["lr"] == 5e-4 for g in state.optimizer.param_groups)
    with pytest.raises(ValueError, match="another model"):
        make_train_step(_port_model(params))(state, batch)
    # BatchNorm statistics live in the model's buffers: the state shows
    # a property model's and none of a LayerNorm model
    from alignn_tpu_torch.nn.models import ALIGNN, ALIGNNConfig

    assert state.batch_stats == {}
    bn_state = create_train_state(
        ALIGNN(ALIGNNConfig(alignn_layers=1, gcn_layers=1,
                            hidden_features=16, embedding_features=8)),
        batch, build_optimizer())
    assert bn_state.batch_stats and all(
        k.endswith((".mean", ".var")) for k in bn_state.batch_stats)
