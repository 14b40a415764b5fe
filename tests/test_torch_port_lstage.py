"""alignn_tpu_torch's fused dense L-stage (K6, K7) against alignn_tpu's.

(a) the plain forward and backward against ``fused_pair_lstage`` and
``_bwd_op`` with their Pallas kernels in interpret mode; (b) the VJP and
the grad-of-grad through the port's autograd Functions against
``jax.grad``; (c) a 1+1/128 model with ``ALIGNN_TPU_FORCE_PALLAS`` and
``ALIGNN_TPU_FUSED_LSTAGE`` set, E/F/S and the E/F/S train step against
JAX, and the port's fused path against its unfused dense path.  Inputs
come from numpy with fixed seeds and go to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alignn_tpu.ops import pallas_fused_lstage as jf
from alignn_tpu_torch.ops import fused_lstage as tf
from torch_port_threads import _two_threads  # noqa: E402,F401

CPU = torch.device("cpu")
D = 4
LR = 1e-3


def _np(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _inputs(n=16, F=128, seed=0, masked=True):
    """As tests/test_fused_lstage.py: (z, w, b, sg_f, dg_f, bh, scale,
    bias) as numpy f32, the edge mask folded into sg_f and dg_f, and the
    [N*D*D] pair mask (a pair is real iff both its edges are)."""
    rng = np.random.default_rng(seed)
    E, L = n * D, n * D * D

    def mk(shape, sc=1.0):
        return (rng.standard_normal(shape) * sc).astype(np.float32)

    z, sg, dg, bh = mk((L, F)), mk((E, F)), mk((E, F)), mk((E, F))
    w, b = mk((F, F), 0.05), mk(F, 0.1)
    sc = (1.0 + 0.1 * rng.standard_normal(F)).astype(np.float32)
    bi = (0.1 * rng.standard_normal(F)).astype(np.float32)
    em = (rng.random(E) < 0.85).astype(np.float32) if masked \
        else np.ones(E, np.float32)
    shift = ((em - 1.0) * np.float32(1e9))[:, None]
    lm = (em.reshape(n, 1, D) * em.reshape(n, D, 1)).reshape(-1)
    return ((z, w, b, (sg + shift).astype(np.float32),
             (dg + shift).astype(np.float32), bh, sc, bi), lm)


def _cotangents(args, lm, seed):
    """Random de and dh; de is 0 on masked pair rows, as it is in the
    model (nothing reads those rows of e_new).  Elsewhere the LayerNorm
    backward of a masked row, whose m2 sits near -1e9, depends on the
    summation order of its mean and differs between any two
    implementations."""
    rng = np.random.default_rng(seed)
    de = rng.standard_normal(args[0].shape).astype(np.float32)
    de[lm == 0] = 0.0
    dh = rng.standard_normal(args[3].shape).astype(np.float32)
    return de, dh


def _count_calls(mp, module, names):
    """{name: calls} of module.<name> for each name, counted from now on
    (`mp`: a pytest MonkeyPatch)."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        def counted(*a, _real=getattr(module, name), _name=name):
            calls[_name] += 1
            return _real(*a)
        mp.setattr(module, name, counted)
    return calls


# ---------------------------------------------------------------------------
# (a) plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [True, False])
def test_forward_matches_pallas(monkeypatch, masked):
    """h to rtol 1e-5, e_new on real pair rows to rtol 1e-5 (atol 1e-5);
    masked rows of e_new finite.  The autograd Function gives the plain
    version's output on the CPU."""
    args, lm = _inputs(masked=masked)
    calls = _count_calls(monkeypatch, jf, ["_pallas_fused"])
    e_j, h_j = jf.fused_pair_lstage(*map(jnp.asarray, args), D, True)
    assert calls == {"_pallas_fused": 1}
    targs = [torch.tensor(x) for x in args]
    e_t, h_t = tf.fused_pair_lstage_plain(*targs, D)
    real = lm > 0
    np.testing.assert_allclose(_np(h_t), np.asarray(h_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(e_t)[real], np.asarray(e_j)[real],
                               rtol=1e-5, atol=1e-5)
    assert torch.isfinite(e_t).all() and torch.isfinite(h_t).all()
    assert real.all() != masked
    e_f, h_f = tf.fused_pair_lstage(*targs, D)
    assert torch.equal(e_f, e_t) and torch.equal(h_f, h_t)


def test_backward_plain_matches_pallas(monkeypatch):
    """fused_lstage_bwd_plain against ``_bwd_op`` (the Pallas
    ``_bwd_kernel``), all eight outputs, normalised by max|ref|: 1e-5."""
    args, lm = _inputs(seed=7)
    de, dh = _cotangents(args, lm, 8)
    calls = _count_calls(monkeypatch, jf, ["_pallas_bwd"])
    refs = jf._bwd_op(*map(jnp.asarray, (*args, de, dh)), D, True)
    assert calls == {"_pallas_bwd": 1}
    got = tf.fused_lstage_bwd_plain(*(torch.tensor(x)
                                      for x in (*args, de, dh)), D)
    for out, ref in zip(got, refs):
        ref = np.asarray(ref)
        scale = max(float(np.abs(ref).max()), 1e-9)
        assert out.shape == ref.shape
        np.testing.assert_allclose(_np(out) / scale, ref / scale, rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# (b) the autograd Functions
# ---------------------------------------------------------------------------


def test_vjp_matches_jax():
    """d/d(all 8 operands) of sum((e_new lm)^2) + sum(h^2) through the
    port's Functions against ``jax.grad`` through the custom VJP (whose
    backward is the Pallas ``_bwd_kernel``): rtol 1e-4, atol 1e-4."""
    args, lm = _inputs(seed=2)
    jlm = jnp.asarray(lm)[:, None]

    def jloss(a):
        e, h = jf.fused_pair_lstage(*a, D, True)
        return jnp.sum((e * jlm) ** 2) + jnp.sum(h ** 2)

    refs = jax.grad(jloss)(tuple(map(jnp.asarray, args)))
    ts = [torch.tensor(x, requires_grad=True) for x in args]
    e, h = tf.fused_pair_lstage(*ts, D)
    loss = torch.sum((e * torch.tensor(lm)[:, None]) ** 2) + torch.sum(h ** 2)
    for out, ref in zip(torch.autograd.grad(loss, ts), refs):
        np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)


def _strided(x: np.ndarray, strided: bool) -> torch.Tensor:
    """x as a leaf tensor, or as the transpose of one: a [rows, F] view
    with strides (1, rows), which the Functions copy for the kernel."""
    if not strided:
        return torch.tensor(x, requires_grad=True)
    return torch.tensor(np.ascontiguousarray(x.T), requires_grad=True).t()


@pytest.mark.parametrize("strided", [False, True])
def test_grad_of_grad_matches_jax(strided):
    """The force-training pattern of tests/test_fused_lstage.py: d/d(w, sg,
    bh) of |d/dz (sum e_new^2 + sum h^2)|^2, through the port's Functions
    (K7's backward is autograd of the plain backward) against ``jax.grad``
    with the Pallas backward: normalised rtol 1e-5, atol 1e-6.  The
    strided case hands the Functions transposed views: a Function that
    saved its unit-stride copy instead of its input would lose that
    input's graph."""
    args, _lm = _inputs(n=8, seed=9, masked=False)
    z, w, b, sg, dg, bh, sc, bi = args

    def jfloss(w_, sg_, bh_):
        def energy(zz):
            e, h = jf.fused_pair_lstage(zz, w_, b, sg_, dg, bh_, sc, bi, D,
                                        True)
            return jnp.sum(e ** 2) + jnp.sum(h ** 2)
        return jnp.sum(jax.grad(energy)(jnp.asarray(z)) ** 2)

    refs = jax.grad(jfloss, argnums=(0, 1, 2))(
        jnp.asarray(w), jnp.asarray(sg), jnp.asarray(bh))
    zt = _strided(z, strided)
    wt, sgt, bht = (_strided(x, strided) for x in (w, sg, bh))
    assert (zt.stride(1) != 1) == strided
    e, h = tf.fused_pair_lstage(zt, wt, torch.tensor(b), sgt,
                                torch.tensor(dg), bht, torch.tensor(sc),
                                torch.tensor(bi), D)
    (gz,) = torch.autograd.grad(torch.sum(e ** 2) + torch.sum(h ** 2), zt,
                                create_graph=True)
    outs = torch.autograd.grad(torch.sum(gz ** 2), (wt, sgt, bht))
    for out, ref in zip(outs, refs):
        ref = np.asarray(ref)
        scale = float(np.abs(ref).max())
        assert scale > 0
        np.testing.assert_allclose(_np(out) / scale, ref / scale, rtol=1e-5,
                                   atol=1e-6)


def test_third_derivative_raises():
    args, _lm = _inputs(n=2, F=8, seed=1, masked=False)
    ts = [torch.tensor(x, requires_grad=True) for x in args]
    e, h = tf.fused_pair_lstage(*ts, D)
    (gz,) = torch.autograd.grad(e.sum() + h.sum(), ts[0], create_graph=True)
    (gw,) = torch.autograd.grad((gz ** 2).sum(), ts[1], create_graph=True)
    with pytest.raises(RuntimeError, match="differentiate twice"):
        gw.sum().backward()


def test_kernel_wrappers_refuse_cpu_tensors():
    """On the CPU the Functions take the plain versions; the kernel
    wrappers themselves take CUDA tensors only."""
    args, _lm = _inputs(n=2, seed=1)
    ts = [torch.tensor(x) for x in args]
    with pytest.raises(ValueError, match="CUDA tensors"):
        tf.fused_pair_lstage_cuda(*ts, D)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tf.fused_lstage_bwd_cuda(*ts, ts[0], ts[3], D)


def test_kernel_codes_raise():
    """fused_lstage.cu returns ERR_TILE for a t-group over its row tile and
    ERR_SMEM for a block over the card's shared memory: both are ValueError
    with the reason; another nonzero code is a RuntimeError."""
    with pytest.raises(ValueError, match="D = 65 is over .* 64-row tile"):
        tf._raise_on_fused(tf.ERR_TILE, "fused_pair_lstage", 65)
    with pytest.raises(ValueError, match="shared memory"):
        tf._raise_on_fused(-1, "fused_lstage_bwd", 65)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        tf._raise_on_fused(1, "fused_lstage_bwd", 13)
    tf._raise_on_fused(0, "fused_lstage_bwd", 13)


def test_switch_selects_the_fused_stage(monkeypatch):
    """ALIGNN_TPU_FUSED_LSTAGE, read at each call as JAX reads it, sends
    EdgeGatedGraphConv.pair_stage through fused_pair_lstage, and only
    then; both stages give the same x_new, and e_new on real pair rows
    (rtol 1e-5, atol 1e-6)."""
    from alignn_tpu_torch.nn import layers

    n, f = 3, 16
    rng = np.random.default_rng(4)
    em = np.ones(n * D, np.float32)
    em[[1, D + 2]] = 0.0
    lg = (em.reshape(n, 1, D) * em.reshape(n, D, 1)).reshape(-1)
    # rev: within each node swap slots 0 and 3 (an involution)
    rev = np.arange(n * D).reshape(n, D)[:, [3, 1, 2, 0]].reshape(-1)
    dense = layers.DenseWiring(D, torch.tensor(em), torch.tensor(lg),
                               torch.tensor(rev))
    torch.manual_seed(0)
    conv = layers.EdgeGatedGraphConv(f)
    x = torch.tensor(rng.standard_normal((n * D, f)), dtype=torch.float32)
    e = torch.tensor(rng.standard_normal((n * D * D, f)), dtype=torch.float32)
    calls = _count_calls(monkeypatch, layers, ["fused_pair_lstage"])
    monkeypatch.delenv("ALIGNN_TPU_FUSED_LSTAGE", raising=False)
    x_u, e_u = conv.pair_stage(x, e, dense)
    assert calls == {"fused_pair_lstage": 0}
    monkeypatch.setenv("ALIGNN_TPU_FUSED_LSTAGE", "1")
    x_f, e_f = conv.pair_stage(x, e, dense)
    assert calls == {"fused_pair_lstage": 1}
    keep = torch.tensor(lg > 0)
    torch.testing.assert_close(x_f, x_u, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(e_f[keep], e_u[keep], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# (c) the model and the train step
# ---------------------------------------------------------------------------

SMALL = dict(name="alignn_atomwise", alignn_layers=1, gcn_layers=1,
             hidden_features=128, embedding_features=32,
             gradwise_weight=10.0, stresswise_weight=0.1,
             graphwise_weight=1.0)
STEPS = 4


def _port_model(params):
    from alignn_tpu_torch.nn.convert import state_dict_from_flax
    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig)

    model = ALIGNNAtomWise(ALIGNNAtomWiseConfig(**SMALL))
    model.load_state_dict(state_dict_from_flax(params))
    return model


def _port_run(params, batch):
    """(E/F/S, step-0 losses, step-0 gradients, 4-step losses)."""
    from alignn_tpu_torch.nn.models import atomwise_forward
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    model = _port_model(params)
    res = atomwise_forward(model, batch)
    res = {k: _np(res[k]) for k in ("out", "grad", "stresses")}
    state = create_train_state(model, batch,
                               build_optimizer("adamw", LR, 1e-5))
    step = make_train_step(model, "l1")
    traj, grads = [], None
    for i in range(STEPS):
        state, losses = step(state, batch)
        traj.append({k: float(v) for k, v in losses.items()})
        if i == 0:
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return res, grads, traj


@pytest.fixture(scope="module")
def fused_runs():
    """JAX and the port on 4 rocksalt cells (dense batch), a 1+1/128 model
    from one JAX init, with ALIGNN_TPU_FORCE_PALLAS and
    ALIGNN_TPU_FUSED_LSTAGE set; and the port once more with the fused
    switch off."""
    from flax import core

    from alignn_tpu.graph.build import GraphData as JGraph
    from alignn_tpu.graph.dense import dense_batch_graphs as jdense
    from alignn_tpu.graph.dense import dense_spec_for_batch as jdspec
    from alignn_tpu.nn.models import ALIGNNAtomWise as JModel
    from alignn_tpu.nn.models import ALIGNNAtomWiseConfig as JConfig
    from alignn_tpu.nn.models import atomwise_forward as jforward
    from alignn_tpu.train.optim import build_optimizer as jbuild
    from alignn_tpu.train.state import TrainState as JState
    from alignn_tpu.train.state import _forward_and_loss
    from alignn_tpu.train.state import make_train_step as jmake
    from alignn_tpu_torch.graph.build import rocksalt_graphs
    from alignn_tpu_torch.graph.dense import (dense_batch_graphs,
                                              dense_spec_for_batch)
    from alignn_tpu_torch.nn.convert import state_dict_from_flax

    graphs = rocksalt_graphs(4, 0)
    jgraphs = [JGraph(**vars(g)) for g in graphs]
    jb = jdense(jgraphs, jdspec(jgraphs), target_width=1)
    tb = dense_batch_graphs(graphs, dense_spec_for_batch(graphs), CPU,
                            target_width=1)
    jmodel = JModel(cfg=JConfig(**SMALL))
    params = jax.jit(lambda key, b: jmodel.init(key, b, b.r, train=False))(
        jax.random.PRNGKey(0), jb)["params"]
    out = {"n": sum(g.num_nodes for g in graphs), "ng": len(graphs)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ALIGNN_TPU_FORCE_PALLAS", "1")
        mp.setenv("ALIGNN_TPU_FUSED_LSTAGE", "1")
        jcalls = _count_calls(mp, jf, ["_pallas_fused", "_pallas_bwd"])
        jres = jax.device_get(jforward(jmodel, {"params": params}, jb,
                                       train=False))
        out["jres"] = {k: np.asarray(jres[k])
                       for k in ("out", "grad", "stresses")}
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
        out["jcalls"] = dict(jcalls)
        out["jl0"] = {k: float(v) for k, v in jl0.items()}
        out["jgrads"] = state_dict_from_flax(jg)
        out["jtraj"] = jtraj
        calls = _count_calls(mp, tf, ["fused_pair_lstage_plain",
                                      "fused_lstage_bwd_plain"])
        out["fused"] = _port_run(params, tb)
        out["port_calls"] = dict(calls)
    out["unfused"] = _port_run(params, tb)
    return out


def test_both_packages_took_the_fused_path(fused_runs):
    """JAX ran its Pallas K6 and K7; the port's fused branch ran its plain
    K6 (forward) and K7 (backward and its autograd)."""
    assert min(fused_runs["jcalls"].values()) > 0, fused_runs["jcalls"]
    assert min(fused_runs["port_calls"].values()) > 0, \
        fused_runs["port_calls"]


def test_fused_model_matches_jax(fused_runs):
    """E/F/S at the limits of test_fused_model_parity: energy rtol 2e-4,
    atol 2e-5; forces and stress rtol 5e-4, atol 5e-5."""
    j, (t, _g, _tr) = fused_runs["jres"], fused_runs["fused"]
    n, ng = fused_runs["n"], fused_runs["ng"]
    np.testing.assert_allclose(t["out"][:ng], j["out"][:ng], rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(t["grad"][:n], j["grad"][:n], rtol=5e-4,
                               atol=5e-5)
    np.testing.assert_allclose(t["stresses"][:ng], j["stresses"][:ng],
                               rtol=5e-4, atol=5e-5)
    assert np.abs(j["grad"][:n]).max() > 1e-2


def test_fused_step0_gradients_match_jax(fused_runs):
    """Every parameter's step-0 gradient against ``jax.grad`` of
    ``_forward_and_loss`` with the fused path: rtol 1e-3, atol 1e-5 x that
    tensor's max|grad|; the loss components to rtol 1e-4."""
    _res, grads, traj = fused_runs["fused"]
    for k, ref in fused_runs["jl0"].items():
        np.testing.assert_allclose(traj[0][k], ref, rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    assert set(grads) == set(fused_runs["jgrads"])
    for k, ref in fused_runs["jgrads"].items():
        np.testing.assert_allclose(_np(grads[k]), _np(ref), rtol=1e-3,
                                   atol=1e-5 * float(ref.abs().max()),
                                   err_msg=k)


def test_fused_loss_trajectory_matches_jax(fused_runs):
    """4 AdamW steps against ``make_train_step``: every loss component to
    rtol 1e-4, and the loss goes down."""
    _res, _grads, traj = fused_runs["fused"]
    for got, ref in zip(traj, fused_runs["jtraj"]):
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-7,
                                       err_msg=k)
    assert traj[-1]["loss"] < traj[0]["loss"]


def test_fused_matches_unfused_dense_path(fused_runs):
    """The port's fused path against its own unfused dense path, same
    weights and batch: E/F/S (rtol 1e-4, atol 1e-5), the step-0 losses
    (rtol 1e-4) and gradients (max abs diff <= 1e-3 x max|grad| + 1e-7).
    Masked pair rows differ between the paths but reach no output."""
    (rf, gf, tf_), (ru, gu, tu) = fused_runs["fused"], fused_runs["unfused"]
    n, ng = fused_runs["n"], fused_runs["ng"]
    for key, rows in (("out", ng), ("grad", n), ("stresses", ng)):
        np.testing.assert_allclose(rf[key][:rows], ru[key][:rows],
                                   rtol=1e-4, atol=1e-5, err_msg=key)
    for k in tu[0]:
        np.testing.assert_allclose(tf_[0][k], tu[0][k], rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    for k, ref in gu.items():
        diff = float((gf[k] - ref).abs().max())
        assert diff <= 1e-3 * float(ref.abs().max()) + 1e-7, (k, diff)
