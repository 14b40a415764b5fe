"""alignn_tpu_torch's forward-over-reverse E/F/S step (``train/fjvp.py``),
its forward-mode rules, and the opt-in ``gated_aggregate_bwd``, on the CPU.

- The fjvp step against JAX's ``make_train_step_fjvp`` (sparse, SGD at
  lr 1 so the update is the gradient) and against the port's standard
  step (sparse and dense): losses within 1e-4 relative, gradients within
  1e-3 x max|grad| + 1e-7; out-of-scope configs raise JAX's errors.
- Each forward-mode rule (K1, K2, the sorted gather, gather_nodes,
  permute_rows, K3, K4) against ``torch.func.jvp`` of its plain version.
- ``gated_aggregate_bwd``: its value against JAX's ``_xla_gated_bwd``,
  its VJP against ``_xla_gated_bwd2`` and its second order against JAX's
  VJP of ``_xla_gated_bwd2``; the dense train step with
  ``ALIGNN_TPU_GATED_BWD_OP=1`` against the step without it.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_port_dp import _jax_graphs  # noqa: E402
from torch_port_gp_worker import MODEL, micro_batches  # noqa: E402
from torch_port_threads import _two_threads  # noqa: E402,F401


def _grads_close(got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        tol = 1e-3 * np.abs(want[k]).max() + 1e-7
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0,
                                   err_msg=k)


def _port_step(make, batch, weights=None, opt=("adamw", 1e-3, 1e-5)):
    """(losses, {name: grad}) of one step of `make(model)` from seeded (or
    the given) weights."""
    from alignn_tpu_torch.config import model_config_from_dict
    from alignn_tpu_torch.nn.models import ALIGNNAtomWise, init_parameters
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import create_train_state

    model = ALIGNNAtomWise(model_config_from_dict(MODEL))
    if weights is None:
        init_parameters(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(weights)
    state = create_train_state(model, batch, build_optimizer(*opt))
    _s, losses = make(model)(state, batch)
    return ({k: float(v) for k, v in losses.items()},
            {k: p.grad.numpy().copy() for k, p in model.named_parameters()})


def test_fjvp_matches_jax_fjvp():
    """One fjvp step of each package from the same weights on the same
    sparse batch: the same losses and gradients."""
    import jax

    from alignn_tpu.config import model_config_from_dict as jcfg
    from alignn_tpu.graph.batch import BucketSpec as JSpec
    from alignn_tpu.graph.batch import batch_graphs as jbatch
    from alignn_tpu.nn.models import ALIGNNAtomWise as JModel
    from alignn_tpu.train.fjvp import make_train_step_fjvp as jfjvp
    from alignn_tpu.train.optim import build_optimizer as jopt
    from alignn_tpu.train.state import create_train_state as jstate
    from alignn_tpu_torch.nn.convert import state_dict_from_flax
    from alignn_tpu_torch.train.fjvp import make_train_step_fjvp

    sparse, _d, rows, (spec, _ds) = micro_batches()
    jb = jbatch(_jax_graphs(rows[0]), JSpec(spec.n_nodes, spec.n_edges,
                                            spec.n_lg_edges, spec.n_graphs))
    model = JModel(cfg=jcfg(MODEL))
    state = jstate(model, jb, jopt("sgd", 1.0, 0.0), seed=4)
    new, jlosses = jfjvp(model, donate=False)(state, jb)
    jgrads = jax.tree_util.tree_map(lambda a, b: np.asarray(a - b),
                                    state.params, new.params)
    want = {k: v.numpy() for k, v in state_dict_from_flax(jgrads).items()}
    losses, grads = _port_step(make_train_step_fjvp, sparse[0],
                               state_dict_from_flax(state.params))
    for k, v in jlosses.items():
        np.testing.assert_allclose(losses[k], float(v), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    _grads_close(grads, want)


@pytest.mark.parametrize("layout", ["sparse", "dense"])
def test_fjvp_matches_standard_step(layout):
    """The port's fjvp step gives its reverse-over-reverse step's losses
    and gradients (the identity is exact for L1 almost everywhere)."""
    from alignn_tpu_torch.train.fjvp import make_train_step_fjvp
    from alignn_tpu_torch.train.state import make_train_step

    sparse, dense, _r, _s = micro_batches()
    batch = (sparse if layout == "sparse" else dense)[1]
    l_std, g_std = _port_step(
        lambda m: make_train_step(m, cuda_graph=False), batch)
    l_fjv, g_fjv = _port_step(make_train_step_fjvp, batch)
    for k in l_std:
        np.testing.assert_allclose(l_fjv[k], l_std[k], rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    _grads_close(g_fjv, g_std)


def test_fjvp_rejects_out_of_scope_configs():
    from alignn_tpu_torch.config import model_config_from_dict
    from alignn_tpu_torch.nn.models import ALIGNN, ALIGNNAtomWise
    from alignn_tpu_torch.train.fjvp import make_train_step_fjvp

    model = ALIGNNAtomWise(model_config_from_dict(MODEL))
    with pytest.raises(ValueError, match="L1"):
        make_train_step_fjvp(model, criterion="mse")
    with pytest.raises(ValueError, match="regression"):
        make_train_step_fjvp(model, classification=True)
    prop = ALIGNN(model_config_from_dict({
        "name": "alignn", "alignn_layers": 1, "gcn_layers": 1,
        "hidden_features": 16, "embedding_features": 8}))
    with pytest.raises(ValueError, match="ALIGNNAtomWise"):
        make_train_step_fjvp(prop)
    pos = ALIGNNAtomWise(model_config_from_dict(
        {**MODEL, "include_pos_deriv": True}))
    with pytest.raises(ValueError, match="r-gradient forces"):
        make_train_step_fjvp(pos)


def _segments(n_seg=7, rows=40, seed=0):
    from alignn_tpu_torch.ops.eggc import Segments

    g = np.random.default_rng(seed)
    ids = np.sort(g.integers(0, n_seg, rows))
    return Segments.from_sorted(torch.as_tensor(ids), n_seg)


def _rand(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=torch.float64)


def _rules():
    """{name: (Function-backed op, plain version, primal inputs)}."""
    from alignn_tpu_torch.ops import dense as od
    from alignn_tpu_torch.ops import eggc as oe

    seg = _segments()
    rows, f, D = seg.ids.shape[0], 6, 3
    perm = torch.randperm(rows, generator=torch.Generator().manual_seed(1))
    inv = torch.argsort(perm)
    idx = torch.as_tensor(np.random.default_rng(2).integers(0, 9, rows))
    p = torch.argsort(idx, stable=True)
    sorted_seg = oe.Segments.from_sorted(idx[p], 9)
    return {
        "K1": (lambda m, bh: oe.gated_aggregate(m, bh, seg),
               lambda m, bh: oe.gated_aggregate_plain(m, bh, seg),
               (_rand(rows, f), _rand(rows, f, seed=1))),
        "K2": (lambda x: oe.sorted_segment_sum(x, seg),
               lambda x: oe.sorted_segment_sum_plain(x, seg),
               (_rand(rows, f),)),
        "sorted_gather": (lambda x: oe.sorted_gather(x, seg),
                          lambda x: x[seg.ids], (_rand(seg.num, f),)),
        "gather_nodes": (
            lambda x: oe.gather_nodes(x, idx, p, torch.argsort(p),
                                      sorted_seg),
            lambda x: x[idx], (_rand(9, f),)),
        "permute_rows": (lambda x: oe.permute_rows(x, perm, inv),
                         lambda x: x[perm], (_rand(rows, f),)),
        "K3": (lambda m, bh: od.dense_gated_aggregate(m, bh, D),
               lambda m, bh: od.dense_gated_aggregate_plain(m, bh, D),
               (_rand(5 * D, f), _rand(5 * D, f, seed=1))),
        "K4": (lambda m2, bh: od.dense_pair_aggregate(m2, bh, D),
               lambda m2, bh: od.dense_pair_aggregate_plain(m2, bh, D),
               (_rand(5 * D * D, f), _rand(5 * D, f, seed=1))),
    }


@pytest.mark.parametrize("name", ["K1", "K2", "sorted_gather",
                                  "gather_nodes", "permute_rows", "K3",
                                  "K4"])
def test_forward_mode_rule_matches_plain_jvp(name):
    """Each Function's forward-mode rule (torch.autograd.forward_ad)
    against torch.func.jvp of its plain version, f64 inputs, tangents on
    every input; the rule's tangent is differentiable (its reverse pass,
    to the primals and the tangents, equals that of the plain jvp)."""
    from torch.autograd import forward_ad

    op, plain, primals = _rules()[name]
    tangents = tuple(_rand(*x.shape, seed=10 + i)
                     for i, x in enumerate(primals))

    def leaves():
        return [x.clone().requires_grad_(True) for x in primals + tangents]

    want_in = leaves()
    _out, want = torch.func.jvp(plain, tuple(want_in[:len(primals)]),
                                tuple(want_in[len(primals):]))
    got_in = leaves()
    with forward_ad.dual_level():
        duals = [forward_ad.make_dual(x, t) for x, t in
                 zip(got_in[:len(primals)], got_in[len(primals):])]
        got = forward_ad.unpack_dual(op(*duals)).tangent
    # the dense sums run in f32, as JAX's do, whatever the input dtype
    tol = dict(rtol=1e-5, atol=1e-6) if name in ("K3", "K4") else \
        dict(rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(got, want, **tol)
    w = _rand(*got.shape, seed=30)
    for out, ins in ((got, got_in), (want, want_in)):
        grads = torch.autograd.grad((out * w).sum(), ins, allow_unused=True)
        out.grads = [torch.zeros_like(x) if g is None else g
                     for x, g in zip(ins, grads)]
    for a, b in zip(got.grads, want.grads):
        torch.testing.assert_close(a, b, **tol)


def test_gated_aggregate_bwd_matches_jax():
    """gated_aggregate_bwd's value, VJP and second order against JAX's
    ``_xla_gated_bwd``/``_xla_gated_bwd2`` (f64 inputs, f32 sums in
    both)."""
    import jax
    import jax.numpy as jnp

    from alignn_tpu.ops.pallas_dense import _xla_gated_bwd, _xla_gated_bwd2
    from alignn_tpu_torch.ops.dense import fold_mask, gated_aggregate_bwd

    jax.config.update("jax_enable_x64", True)
    try:
        D, f, n = 4, 5, 6
        mask = torch.as_tensor((np.arange(n * D) % 3 != 2).astype(float))
        m = fold_mask(_rand(n * D, f), mask)
        bh, g = _rand(n * D, f, seed=1), _rand(n, f, seed=2)
        u, v = _rand(n * D, f, seed=3), _rand(n * D, f, seed=4)
        w = [_rand(*x.shape, seed=5 + i) for i, x in enumerate((m, bh, g))]
        jn = [jnp.asarray(x.numpy()) for x in (m, bh, g, u, v)]

        leaves = [x.clone().requires_grad_(True) for x in (m, bh, g)]
        dm, dbh = gated_aggregate_bwd(*leaves, D)
        for a, b in zip((dm, dbh), _xla_gated_bwd(*jn[:3], D)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-10, atol=1e-12)
        cots = torch.autograd.grad((dm * u).sum() + (dbh * v).sum(), leaves,
                                   create_graph=True)
        for a, b in zip(cots, _xla_gated_bwd2(*jn, D)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-10, atol=1e-12)
        second = torch.autograd.grad(
            sum((c * wi).sum() for c, wi in zip(cots, w)), leaves)
        jw = [jnp.asarray(x.numpy()) for x in w]
        ref = jax.grad(lambda a, b, c: sum(
            jnp.sum(x * y) for x, y in zip(
                _xla_gated_bwd2(a, b, c, jn[3], jn[4], D), jw)),
            argnums=(0, 1, 2))(*jn[:3])
        # both packages form these sums in f32 (astype), and autodiff
        # orders the third-order terms its own way
        for a, b in zip(second, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7)
    finally:
        jax.config.update("jax_enable_x64", False)


def test_gated_bwd_op_dense_step(monkeypatch):
    """The dense E/F/S step with ``ALIGNN_TPU_GATED_BWD_OP=1`` gives the
    step without it (K3's backward as the first-class op, whose VJP is
    the hand-derived second order)."""
    from alignn_tpu_torch.train.state import make_train_step

    batch = micro_batches()[1][0]
    step = (lambda m: make_train_step(m, cuda_graph=False))
    l_off, g_off = _port_step(step, batch)
    monkeypatch.setenv("ALIGNN_TPU_GATED_BWD_OP", "1")
    l_on, g_on = _port_step(step, batch)
    for k in l_off:
        np.testing.assert_allclose(l_on[k], l_off[k], rtol=1e-6, err_msg=k)
    _grads_close(g_on, g_off)
