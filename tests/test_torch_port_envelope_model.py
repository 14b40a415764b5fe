"""The envelope-weighted FF model, ``include_pos_deriv`` and the jarvis
radius graph in alignn_tpu_torch, against alignn_tpu on the CPU.

(a) ``radius_graph_jarvis`` array-equal to JAX's; (b) forces of an
envelope model against central finite differences in f64 (the port of
``tests/test_forces.py``, whose structure file is not in the repository);
(c) ``include_pos_deriv`` against JAX; (d) the refusals; (e) the E/F/S
train step of a 2+2/32 envelope model against ``jax.grad`` and
``make_train_step``.  Inputs come from numpy with fixed seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

CPU = torch.device("cpu")
DIAMOND = np.array([[0, 0, 0], [0.25, 0.25, 0.25], [0, 0.5, 0.5],
                    [0.25, 0.75, 0.75], [0.5, 0, 0.5], [0.75, 0.25, 0.75],
                    [0.5, 0.5, 0], [0.75, 0.75, 0.25]])
ENV = dict(name="alignn_atomwise", alignn_layers=2, gcn_layers=2,
           hidden_features=32, embedding_features=16, gradwise_weight=10.0,
           stresswise_weight=0.1, graphwise_weight=1.0,
           envelope_edge_weights=True, envelope_cutoff=4.5)
TRAIN_LIMITS = {"loss_rel": 1e-4, "grad_rel": 1e-3, "grad_abs": 1e-7}


@pytest.fixture
def numpy_neighbors(monkeypatch):
    """A C++ cell list orders tied pairs otherwise than the numpy search;
    both packages take the numpy search here, to compare like with like
    (tests/test_torch_port_native.py compares their C++ lists)."""
    import alignn_tpu.native
    import alignn_tpu_torch.native

    for mod in (alignn_tpu.native, alignn_tpu_torch.native):
        monkeypatch.setattr(mod, "periodic_pairs_native",
                            lambda *a, **k: None)


# ---------------------------------------------------------------------------
# (a) radius_graph_jarvis
# ---------------------------------------------------------------------------


def _jarvis_structures():
    """(lattice, frac, elements, cutoff): rattled diamond Si; a 2-atom
    cell of 2.6 A whose self-images sit inside the cutoff; a 10 A cell
    whose third atom lies beyond 3 A of the others, so the first cutoff
    leaves it isolated and the search retries with a larger one."""
    rng = np.random.default_rng(3)
    lat = np.eye(3) * 5.43
    cart = DIAMOND @ lat + rng.normal(0.0, 0.05, (8, 3))
    return [
        ("rattled_diamond", lat, cart @ np.linalg.inv(lat), ["Si"] * 8,
         4.0),
        ("self_images", np.eye(3) * 2.6,
         np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]), ["Fe", "Fe"], 4.0),
        ("retry", np.eye(3) * 10.0,
         np.array([[0.10, 0.10, 0.10], [0.33, 0.10, 0.10],
                   [0.60, 0.55, 0.50]]), ["Si"] * 3, 3.0),
    ]


@pytest.mark.parametrize("which", [0, 1, 2],
                         ids=[s[0] for s in _jarvis_structures()])
def test_radius_graph_jarvis_equals_jax(numpy_neighbors, which):
    from alignn_tpu.chem.atoms import Atoms as JAtoms
    from alignn_tpu.graph.build import build_graph as jbuild
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.graph.build import build_graph

    _name, lat, frac, elements, cutoff = _jarvis_structures()[which]
    kw = dict(neighbor_strategy="radius_graph_jarvis", cutoff=cutoff)
    gj = jbuild(JAtoms(lattice_mat=lat, frac_coords=frac, elements=elements),
                **kw)
    gt = build_graph(Atoms(lattice_mat=lat, frac_coords=frac,
                           elements=elements), **kw)
    for key in ("z", "src", "dst", "images", "lg_src", "lg_dst"):
        assert getattr(gt, key).dtype == getattr(gj, key).dtype, key
        np.testing.assert_array_equal(getattr(gt, key), getattr(gj, key),
                                      err_msg=key)
    assert gt.r.tobytes() == gj.r.tobytes()
    assert not np.any(gt.src == gt.dst)          # no self-image bond


def test_jarvis_drops_self_images_and_retries():
    """On the small cell radius_graph keeps the i -> i image bonds that
    the jarvis graph drops; on the sparse cell the jarvis search widens
    its cutoff until the third atom has a bond."""
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.graph.build import radius_graph, radius_graph_jarvis

    structures = _jarvis_structures()
    _n, lat, frac, el, cut = structures[1]
    atoms = Atoms(lattice_mat=lat, frac_coords=frac, elements=el)
    u, v, _r, _i = radius_graph(atoms, cutoff=cut)
    uj, vj, _rj, _ij = radius_graph_jarvis(atoms, cutoff=cut)
    assert np.any(u == v) and not np.any(uj == vj)
    assert len(uj) == np.sum(u != v)
    _n, lat, frac, el, cut = structures[2]
    u, v, r, _i = radius_graph_jarvis(
        Atoms(lattice_mat=lat, frac_coords=frac, elements=el), cutoff=cut)
    assert set(u) == {0, 1, 2}
    assert np.linalg.norm(r, axis=1).max() > cut


def test_jarvis_envelope_calculator_matches_jax(numpy_neighbors):
    """A radius_graph_jarvis config served by both Calculators (a 1+1/16
    envelope model, JAX-initialised, envelope at the 4 A cutoff) on the
    2-atom cell whose self-images the jarvis graph drops, rattled, then
    again after a move under skin / 2, which
    reuses the candidate set: energy 1e-4 eV/atom; forces and stress to
    1e-3 x their largest JAX value (the random model's forces are small,
    so the serving limits would not test them)."""
    from alignn_tpu.chem.atoms import Atoms as JAtoms
    from alignn_tpu.ff.calculator import Calculator as JCalculator
    from alignn_tpu.graph.batch import BucketSpec as JSpec
    from alignn_tpu.graph.batch import batch_graphs as jbatch
    from alignn_tpu.graph.build import build_graph as jbuild
    from alignn_tpu.nn.models import ALIGNNAtomWise as JModel
    from alignn_tpu.nn.models import ALIGNNAtomWiseConfig as JConfig
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.ff.calculator import Calculator
    from alignn_tpu_torch.nn.convert import state_dict_from_flax
    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig)

    config = {"neighbor_strategy": "radius_graph_jarvis", "cutoff": 4.0}
    kw = dict(ENV, alignn_layers=1, gcn_layers=1, hidden_features=16,
              embedding_features=8, envelope_cutoff=4.0)
    _n, lat, frac, elements, _cut = _jarvis_structures()[1]
    rng = np.random.default_rng(4)
    frac = frac + rng.normal(0.0, 0.02, frac.shape)
    jg = jbuild(JAtoms(lattice_mat=lat, frac_coords=frac,
                       elements=elements), **config)
    jb = jbatch([jg], JSpec.tight_for_batch([jg]), gather_windows=False)
    jmodel = JModel(cfg=JConfig(**kw))
    variables = jmodel.init(jax.random.PRNGKey(1), jb, jb.r, train=False)
    jcalc = JCalculator(model=jmodel, variables=variables, config=config)
    model = ALIGNNAtomWise(ALIGNNAtomWiseConfig(**kw))
    model.load_state_dict(state_dict_from_flax(variables["params"]))
    calc = Calculator(model=model, config=config, device="cpu")
    step = rng.normal(0.0, 0.02, frac.shape) @ np.linalg.inv(lat)
    for frac_i in (frac, frac + step):
        jr = jcalc.calculate(JAtoms(lattice_mat=lat, frac_coords=frac_i,
                                    elements=elements))
        tr = calc.calculate(Atoms(lattice_mat=lat, frac_coords=frac_i,
                                  elements=elements))
        assert abs(tr["energy"] - jr["energy"]) / len(elements) < 1e-4
        for key in ("forces", "stress"):
            ref = np.asarray(jr[key])
            assert np.abs(ref).max() > 0
            np.testing.assert_allclose(tr[key], ref, rtol=0,
                                       atol=1e-3 * np.abs(ref).max(),
                                       err_msg=key)
    assert calc._nl_graph is not None     # the second call reused it
    assert not np.any(calc._nl_graph.src == calc._nl_graph.dst)


# ---------------------------------------------------------------------------
# (b) finite differences, (c) include_pos_deriv
# ---------------------------------------------------------------------------


def _rattled_si(seed=5, rattle=0.08):
    from alignn_tpu_torch.chem.atoms import Atoms

    rng = np.random.default_rng(seed)
    lat = np.eye(3) * 5.43
    cart = DIAMOND @ lat + rng.normal(0.0, rattle, (8, 3))
    return Atoms(lattice_mat=lat, frac_coords=cart @ np.linalg.inv(lat),
                 elements=["Si"] * 8)


def test_forces_match_finite_difference_f64():
    """An envelope model (1+1/16, envelope at the graph cutoff of 4 A, so
    Si's second shell at about 3.84 A sits near it) in f64, on rattled
    diamond Si with the graph held fixed: the forces of atomwise_forward
    (dE/dr summed over bonds) against central differences of the energy
    in the cartesian positions (h 1e-4 A; rtol 1e-6, atol 1e-6 x
    max|F|), and the include_pos_deriv forces against them, divided by
    the node count the pos-deriv energy carries.  The weights are live:
    the same parameters without them give other forces."""
    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.graph.build import build_graph
    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig,
                                            atomwise_forward,
                                            compute_cartesian_r,
                                            init_parameters)

    atoms = _rattled_si()
    g = build_graph(atoms, neighbor_strategy="radius_graph", cutoff=4.0)
    batch = batch_graphs([g], BucketSpec.tight_for_batch([g]), CPU,
                         dtype=torch.float64)
    batch = dataclasses.replace(batch, r=compute_cartesian_r(batch))
    cfg = ALIGNNAtomWiseConfig(alignn_layers=1, gcn_layers=1,
                               hidden_features=16, embedding_features=8,
                               envelope_edge_weights=True,
                               envelope_cutoff=4.0)
    model = init_parameters(ALIGNNAtomWise(cfg),
                            torch.Generator().manual_seed(0)).double()
    bl = batch.r[batch.edge_mask > 0].norm(dim=1)
    assert float(bl.max()) > 3.8    # bonds with small, steep weights
    forces = atomwise_forward(model, batch)["grad"][:8].detach().numpy()
    scale = np.abs(forces).max()
    plain = ALIGNNAtomWise(dataclasses.replace(
        cfg, envelope_edge_weights=False, envelope_cutoff=0.0)).double()
    plain.load_state_dict(model.state_dict())
    unweighted = atomwise_forward(plain, batch)["grad"][:8].detach().numpy()
    assert np.abs(unweighted - forces).max() > 0.1 * scale

    lat = batch.lattice[0]
    cart0 = batch.frac_coords[:8] @ lat

    def energy(cart):
        frac = batch.frac_coords.clone()
        frac[:8] = cart @ torch.linalg.inv(lat)
        with torch.no_grad():
            res = model(batch, compute_cartesian_r(batch, frac))
        return float((res["en_out"] * batch.graph_mask).sum())

    h = 1e-4
    fd = np.zeros((8, 3))
    for i in range(8):
        for k in range(3):
            plus, minus = cart0.clone(), cart0.clone()
            plus[i, k] += h
            minus[i, k] -= h
            fd[i, k] = -(energy(plus) - energy(minus)) / (2 * h)
    np.testing.assert_allclose(forces, fd, rtol=1e-6, atol=1e-6 * scale)

    pos = ALIGNNAtomWise(dataclasses.replace(cfg, include_pos_deriv=True))
    pos.load_state_dict(model.state_dict())
    res = atomwise_forward(pos.double(), batch)
    np.testing.assert_allclose(res["grad"][:8].detach().numpy() / 8.0,
                               forces, rtol=1e-9, atol=1e-9 * scale)
    assert float(res["stresses"].abs().max()) == 0.0


@pytest.fixture(scope="module")
def pos_deriv_pair():
    """A 1+1/16 model with include_pos_deriv, JAX-initialised, on a
    3-atom cell with one bond in the short-bond penalty region (as
    tests/test_forces.py builds it): (JAX result, port result, batch)."""
    from alignn_tpu.graph.batch import BucketSpec as JSpec
    from alignn_tpu.graph.batch import batch_graphs as jbatch
    from alignn_tpu.graph.build import GraphData as JGraph
    from alignn_tpu.nn.models import ALIGNNAtomWise as JModel
    from alignn_tpu.nn.models import ALIGNNAtomWiseConfig as JConfig
    from alignn_tpu.nn.models import atomwise_forward as jforward
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.graph.build import build_graph
    from alignn_tpu_torch.nn.convert import state_dict_from_flax
    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig,
                                            atomwise_forward)

    atoms = Atoms(lattice_mat=np.eye(3) * 6.0,
                  frac_coords=np.array([[0.10, 0.10, 0.10],
                                        [0.25, 0.10, 0.10],
                                        [0.60, 0.55, 0.50]]),
                  elements=["Si", "Si", "Si"])
    g = build_graph(atoms, neighbor_strategy="radius_graph", cutoff=4.0)
    spec = BucketSpec.tight_for_batch([g])
    jb = jbatch([JGraph(**vars(g))],
                JSpec(n_nodes=spec.n_nodes, n_edges=spec.n_edges,
                      n_lg_edges=spec.n_lg_edges, n_graphs=spec.n_graphs),
                gather_windows=False)
    kw = dict(name="alignn_atomwise", alignn_layers=1, gcn_layers=1,
              hidden_features=16, embedding_features=8, gradwise_weight=1.0,
              stresswise_weight=0.0, use_penalty=True,
              include_pos_deriv=True)
    jmodel = JModel(cfg=JConfig(**kw))
    variables = jmodel.init(jax.random.PRNGKey(0), jb, jb.r, train=False)
    jres = jax.device_get(jax.jit(
        lambda b: jforward(jmodel, variables, b, train=False))(jb))
    model = ALIGNNAtomWise(ALIGNNAtomWiseConfig(**kw))
    model.load_state_dict(state_dict_from_flax(variables["params"]))
    tb = batch_graphs([g], spec, CPU)
    return jres, atomwise_forward(model.eval(), tb), tb


def test_include_pos_deriv_matches_jax(pos_deriv_pair):
    """Forces from the fractional-coordinate gradient (energy times the
    node count, inv(lattice)^T per node) against JAX's: atol 1e-5 x
    max|F| (f32, the energy carries the factor 3); the energy to rtol
    1e-5; stress zero on both sides."""
    jres, tres, tb = pos_deriv_pair
    nm = tb.node_mask.numpy() > 0
    f = tres["grad"].detach().numpy()[nm]
    ref = np.asarray(jres["grad"])[nm]
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(f, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(tres["out"].detach().numpy()[:1],
                               np.asarray(jres["out"])[:1], rtol=1e-5)
    assert float(tres["stresses"].abs().max()) == 0.0
    assert np.abs(np.asarray(jres["stresses"])).max() == 0.0


# ---------------------------------------------------------------------------
# (d) refusals
# ---------------------------------------------------------------------------


def _small_graphs():
    from alignn_tpu_torch.graph.build import build_graph

    return [build_graph(_rattled_si(), neighbor_strategy="radius_graph",
                        cutoff=4.5)]


@pytest.mark.parametrize("layout", ["dense", "no_cutoff"])
def test_envelope_refusals_match_jax(layout):
    """An envelope model refuses a dense batch and an envelope_cutoff of
    0 with JAX's ValueError and message."""
    from alignn_tpu.graph.batch import BucketSpec as JSpec
    from alignn_tpu.graph.batch import batch_graphs as jbatch
    from alignn_tpu.graph.build import GraphData as JGraph
    from alignn_tpu.graph.dense import dense_batch_graphs as jdense
    from alignn_tpu.graph.dense import dense_spec_for_batch as jdspec
    from alignn_tpu.nn.models import ALIGNNAtomWise as JModel
    from alignn_tpu.nn.models import ALIGNNAtomWiseConfig as JConfig
    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.graph.dense import (dense_batch_graphs,
                                              dense_spec_for_batch)
    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig,
                                            atomwise_forward)

    graphs = _small_graphs()
    jgraphs = [JGraph(**vars(g)) for g in graphs]
    kw = dict(ENV, alignn_layers=1, gcn_layers=1)
    if layout == "dense":
        tb = dense_batch_graphs(graphs, dense_spec_for_batch(graphs), CPU)
        jb = jdense(jgraphs, jdspec(jgraphs))
        match = "runs the sparse layout"
    else:
        kw["envelope_cutoff"] = 0.0
        tb = batch_graphs(graphs, BucketSpec.tight_for_batch(graphs), CPU)
        jb = jbatch(jgraphs, JSpec.tight_for_batch(jgraphs),
                    gather_windows=False)
        match = "requires envelope_cutoff > 0"
    with pytest.raises(ValueError, match=match) as jerr:
        JModel(cfg=JConfig(**kw)).init(jax.random.PRNGKey(0), jb, jb.r,
                                       train=False)
    with pytest.raises(ValueError, match=match) as terr:
        atomwise_forward(ALIGNNAtomWise(ALIGNNAtomWiseConfig(**kw)), tb)
    assert str(terr.value) == str(jerr.value)


def test_dense_calculator_refuses_an_envelope_potential():
    """Calculator(dense=True) on Si_envelope: diamond's radius graph (D
    16) qualifies for the dense layout, and the model refuses it rather
    than running dense without its weights."""
    import os

    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.ff.calculator import Calculator

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs", "mlearn_r5", "Si_envelope")
    calc = Calculator(path=path, dense=True, device="cpu")
    with pytest.raises(ValueError, match="runs the sparse layout"):
        calc.calculate(Atoms(lattice_mat=np.eye(3) * 5.43,
                             frac_coords=DIAMOND, elements=["Si"] * 8))
    assert calc._spec.dense_D > 0


def test_extra_features_still_refused():
    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig)

    with pytest.raises(NotImplementedError, match="extra_features"):
        ALIGNNAtomWise(ALIGNNAtomWiseConfig(extra_features=4))


# ---------------------------------------------------------------------------
# (e) the train step
# ---------------------------------------------------------------------------

STEPS = 3


@pytest.fixture(scope="module")
def envelope_steps():
    """JAX's step-0 losses and gradients (``jax.grad`` of
    ``_forward_and_loss``), its forward and its 3-step loss trajectory;
    the port's the same from the same parameters and batch: bench.py's
    4 rocksalt cells with the envelope potentials' graph (radius 4.5 A,
    no canonisation), bench.py's optimizer (AdamW, lr 1e-3, wd 1e-5)."""
    from flax import core

    from alignn_tpu.graph.batch import BucketSpec as JSpec
    from alignn_tpu.graph.batch import batch_graphs as jbatch
    from alignn_tpu.graph.build import GraphData as JGraph
    from alignn_tpu.nn.models import ALIGNNAtomWise as JModel
    from alignn_tpu.nn.models import ALIGNNAtomWiseConfig as JConfig
    from alignn_tpu.nn.models import atomwise_forward as jforward
    from alignn_tpu.train.optim import build_optimizer as jbuild
    from alignn_tpu.train.state import TrainState as JState
    from alignn_tpu.train.state import _forward_and_loss
    from alignn_tpu.train.state import make_train_step as jmake
    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.graph.build import rocksalt_graphs
    from alignn_tpu_torch.nn.convert import state_dict_from_flax
    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig,
                                            atomwise_forward)
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    graphs = rocksalt_graphs(4, seed=0, neighbor_strategy="radius_graph",
                             cutoff=4.5, use_canonize=False)
    jgraphs = [JGraph(**vars(g)) for g in graphs]
    jb = jbatch(jgraphs, JSpec.tight_for_batch(jgraphs), target_width=1,
                gather_windows=False)
    jmodel = JModel(cfg=JConfig(**ENV))
    params = jax.jit(lambda key, b: jmodel.init(key, b, b.r, train=False))(
        jax.random.PRNGKey(0), jb)["params"]
    jres = jax.device_get(jax.jit(lambda b: jforward(
        jmodel, {"params": params}, b, train=False))(jb))
    (_, (jl0, _r, _s)), jg = jax.jit(jax.value_and_grad(
        lambda p: _forward_and_loss(jmodel, p, core.FrozenDict(), jb, "l1",
                                    False, True), has_aux=True))(params)
    tx = jbuild("adamw", 1e-3, 1e-5)
    jstate = JState(step=jnp.zeros((), jnp.int32), params=params,
                    batch_stats=core.FrozenDict(), opt_state=tx.init(params),
                    tx=tx)
    jstep = jmake(jmodel, "l1", donate=False)
    jtraj = []
    for _ in range(STEPS):
        jstate, jlosses = jstep(jstate, jb)
        jtraj.append({k: float(v) for k, v in jlosses.items()})

    tb = batch_graphs(graphs, BucketSpec.tight_for_batch(graphs), CPU,
                      target_width=1)
    model = ALIGNNAtomWise(ALIGNNAtomWiseConfig(**ENV))
    model.load_state_dict(state_dict_from_flax(params))   # strict
    tres = atomwise_forward(model.eval(), tb)
    state = create_train_state(model, tb, build_optimizer("adamw", 1e-3,
                                                          1e-5))
    step = make_train_step(model, "l1")
    traj, grads = [], None
    for i in range(STEPS):
        state, losses = step(state, tb)
        traj.append({k: float(v) for k, v in losses.items()})
        if i == 0:   # the update leaves .grad in place until the next step
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return dict(jres=jres, tres=tres, tb=tb,
                jl0={k: float(v) for k, v in jl0.items()},
                jgrads=state_dict_from_flax(jg), jtraj=jtraj, traj=traj,
                grads=grads)


def test_envelope_forward_matches_jax(envelope_steps):
    """E (rtol 1e-5), forces (atol 1e-5 x max|F|) and stress (atol 1e-5 x
    max|S|) of the 2+2/32 envelope model on the 4 rocksalt cells."""
    r = envelope_steps
    tb, jres, tres = r["tb"], r["jres"], r["tres"]
    gm, nm = tb.graph_mask.numpy() > 0, tb.node_mask.numpy() > 0
    np.testing.assert_allclose(tres["out"].detach().numpy()[gm],
                               jres["out"][gm], rtol=1e-5, atol=1e-6)
    for key, mask in (("grad", nm), ("stresses", gm)):
        ref = jres[key][mask]
        np.testing.assert_allclose(tres[key].detach().numpy()[mask], ref,
                                   rtol=0, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=key)
    bl = tres["bondlength"].detach().numpy()[tb.edge_mask.numpy() > 0]
    assert bl.max() > 4.0     # bonds in the envelope's steep part


def test_envelope_step0_matches_jax(envelope_steps):
    """Loss components to relative 1e-4; every parameter's gradient within
    1e-3 x that tensor's max|grad| + 1e-7; the port's parameters are
    exactly JAX's (an envelope model adds none)."""
    r = envelope_steps
    for k, ref in r["jl0"].items():
        assert abs(r["traj"][0][k] - ref) <= \
            TRAIN_LIMITS["loss_rel"] * abs(ref), k
    assert r["jl0"]["loss3"] > 0 and r["jl0"]["loss4"] > 0
    assert set(r["grads"]) == set(r["jgrads"])
    for k, ref in r["jgrads"].items():
        diff = float((r["grads"][k] - ref).abs().max())
        assert diff <= TRAIN_LIMITS["grad_rel"] * float(ref.abs().max()) \
            + TRAIN_LIMITS["grad_abs"], (k, diff)


def test_envelope_loss_trajectory_matches_jax(envelope_steps):
    """3 AdamW steps against ``make_train_step``: every loss component to
    relative 1e-4, and the loss falls."""
    r = envelope_steps
    for got, ref in zip(r["traj"], r["jtraj"]):
        for k in ref:
            assert abs(got[k] - ref[k]) <= \
                TRAIN_LIMITS["loss_rel"] * abs(ref[k]) + 1e-7, k
    assert r["traj"][-1]["loss"] < r["traj"][0]["loss"]
