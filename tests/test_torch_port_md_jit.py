"""The port's on-device MD and batched FIRE against alignn_tpu's, on the CPU.

``alignn_tpu_torch.ff.md_jit.run_md_jit`` and ``ff.relax_jit.batch_relax``
run their device loops eagerly here (the CUDA graphs need the card; see
``tests/test_torch_port_cuda.py``), with the small model of
``tests/test_md_jit.py`` (1+1 layers, 16 hidden) and JAX's weights carried
by ``nn/convert.py``: NVE positions within 1e-5 A and per-step energies
within 1e-5 eV of JAX's ``run_md_jit``, ``batch_relax`` positions within
1e-5 A and energies within 1e-5 eV of JAX's.  Then every case of
``tests/test_md_jit.py`` and ``tests/test_relax_jit.py`` through the port
alone: host-loop parity, chunked against stepwise, Langevin (finite, and
its mean temperature against the thermostat's), the dense layout's
per-chunk sparse detour, dense against sparse, and forces reduced by the
batched relaxation; and the step loop's batch reuse.
"""

import numpy as np
import pytest
import torch

CPU = torch.device("cpu")
SMALL = dict(name="alignn_atomwise", alignn_layers=1, gcn_layers=1,
             hidden_features=16, embedding_features=8, gradwise_weight=1.0,
             stresswise_weight=0.0)
NACL = dict(lattice_mat=np.eye(3) * 4.1,
            frac_coords=[[0, 0, 0], [0.5, 0.5, 0.5]], elements=["Na", "Cl"])



@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads while this module runs: the suite runs its
    files in parallel workers, whose default thread counts would
    oversubscribe the host's cores."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def models():
    """(JAX model, its variables, the port's model with those weights)."""
    import jax

    from alignn_tpu.chem.atoms import Atoms as JAtoms
    from alignn_tpu.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu.graph.build import build_graph
    from alignn_tpu.nn.models import ALIGNNAtomWise as JModel
    from alignn_tpu.nn.models import ALIGNNAtomWiseConfig as JConfig
    from alignn_tpu_torch.nn.convert import state_dict_from_flax
    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig)

    jmodel = JModel(cfg=JConfig(**SMALL))
    g = build_graph(JAtoms(**NACL), neighbor_strategy="radius_graph",
                    cutoff=5.0)
    batch = batch_graphs([g], BucketSpec.tight_for_batch([g]))
    variables = jmodel.init(jax.random.PRNGKey(0), batch, batch.r,
                            train=False)
    model = ALIGNNAtomWise(ALIGNNAtomWiseConfig(**SMALL)).eval()
    model.load_state_dict(state_dict_from_flax(variables["params"]))
    return jmodel, variables, model


def _atoms(**kw):
    from alignn_tpu_torch.chem.atoms import Atoms

    return Atoms(**{**NACL, **kw})


def _wrapped_cart(atoms):
    """Cartesian coordinates wrapped into the home cell (``build_graph``
    wraps fractional coordinates between chunks)."""
    return (np.asarray(atoms.frac_coords) % 1.0) @ atoms.lattice_mat


def _rattled(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [dict(NACL, frac_coords=np.array([[0, 0, 0], [0.5, 0.5, 0.5]])
                 + 0.04 * rng.standard_normal((2, 3)))
            for _ in range(n)]


MD_KW = dict(steps=8, timestep_fs=0.5, ensemble="nve",
             initial_temperature_K=80.0, seed=3, cutoff=5.0)


def test_md_jit_nve_matches_jax(models):
    """NVE in chunks of 3: positions within 1e-5 A, every step's potential
    and kinetic energy within 1e-5 eV."""
    from alignn_tpu.chem.atoms import Atoms as JAtoms
    from alignn_tpu.ff.md_jit import run_md_jit as jrun
    from alignn_tpu_torch.ff.md_jit import run_md_jit

    jmodel, variables, model = models
    ja, jlog = jrun(jmodel, variables, JAtoms(**NACL), chunk_steps=3,
                    **MD_KW)
    ta, tlog = run_md_jit(model, _atoms(), chunk_steps=3, device="cpu",
                          **MD_KW)
    np.testing.assert_allclose(_wrapped_cart(ta), _wrapped_cart(ja),
                               rtol=0, atol=1e-5)
    assert len(tlog.rows) == len(jlog.rows) == 8
    for tr, jr in zip(tlog.rows, jlog.rows):
        assert tr["step"] == jr["step"]
        assert abs(tr["epot"] - jr["epot"]) < 1e-5
        assert abs(tr["ekin"] - jr["ekin"]) < 1e-5
    assert abs(tlog.rows[-1]["epot"] - tlog.rows[0]["epot"]) > 1e-6


def test_batch_relax_matches_jax(models):
    """Four rattled NaCl cells, 3 chunks of 10 FIRE steps: positions within
    1e-5 A, final energies within 1e-5 eV, max forces within 1e-5."""
    from alignn_tpu.chem.atoms import Atoms as JAtoms
    from alignn_tpu.ff.relax_jit import batch_relax as jrelax
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.ff.relax_jit import batch_relax

    jmodel, variables, model = models
    cells = _rattled()
    kw = dict(fmax=1e-6, max_steps=30, chunk_steps=10, cutoff=5.0)
    jr, je, jf = jrelax(jmodel, variables, [JAtoms(**c) for c in cells],
                        **kw)
    tr, te, tf = batch_relax(model, [Atoms(**c) for c in cells],
                             device="cpu", **kw)
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(_wrapped_cart(a), _wrapped_cart(b),
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(te, je, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-5)
    moved = max(np.abs(_wrapped_cart(a) - _wrapped_cart(Atoms(**c))).max()
                for a, c in zip(tr, cells))
    assert moved > 1e-3


# ---------------------------------------------------------------------------
# the cases of tests/test_md_jit.py and tests/test_relax_jit.py, port only
# ---------------------------------------------------------------------------


def test_md_jit_matches_host_loop(models):
    from alignn_tpu_torch.ff.calculator import Calculator
    from alignn_tpu_torch.ff.md import run_md
    from alignn_tpu_torch.ff.md_jit import run_md_jit

    model = models[2]
    calc = Calculator(model=model, skin=0.0, device="cpu",
                      config={"neighbor_strategy": "radius_graph",
                              "cutoff": 5.0})
    host_state, host_log = run_md(
        calc, _atoms(), ensemble="nve", steps=8, timestep_fs=0.5,
        initial_temperature_K=80.0, seed=3, log_interval=8)
    jit_atoms, jit_log = run_md_jit(model, _atoms(), chunk_steps=1,
                                    device="cpu", **MD_KW)
    np.testing.assert_allclose(_wrapped_cart(jit_atoms),
                               _wrapped_cart(host_state.atoms),
                               rtol=1e-4, atol=1e-5)
    assert jit_log.rows[-1]["etot"] == pytest.approx(
        host_log.rows[-1]["etot"], rel=1e-3)


def test_md_jit_chunked_close_to_stepwise(models):
    from alignn_tpu_torch.ff.md_jit import run_md_jit

    model = models[2]
    a1, _ = run_md_jit(model, _atoms(), chunk_steps=1, device="cpu",
                       **MD_KW)
    a8, _ = run_md_jit(model, _atoms(), chunk_steps=8, device="cpu",
                       **MD_KW)
    np.testing.assert_allclose(_wrapped_cart(a8), _wrapped_cart(a1),
                               rtol=1e-4, atol=1e-5)


def test_md_jit_langevin_runs(models):
    from alignn_tpu_torch.ff.md_jit import run_md_jit

    a, log = run_md_jit(models[2], _atoms(), steps=6, timestep_fs=0.5,
                        ensemble="nvt_langevin", temperature_K=200.0,
                        seed=1, cutoff=5.0, chunk_steps=3, device="cpu")
    assert np.isfinite(log.rows[-1]["T"])
    assert np.isfinite(a.cart_coords).all()


def test_md_jit_langevin_temperature(models):
    """The port's noise is torch's, not jax.random's: the two runs agree
    in their statistics only.  A 16-atom cell from 50 K under a strong
    thermostat (friction 0.5/fs) at 300 K: both packages' mean
    temperatures over the last 100 of 200 steps lie within 35 % of 300 K
    and within 35 % of each other."""
    from alignn_tpu.chem.atoms import Atoms as JAtoms
    from alignn_tpu.ff.md_jit import run_md_jit as jrun
    from alignn_tpu_torch.ff.md_jit import run_md_jit

    jmodel, variables, model = models
    cell = _atoms().make_supercell((2, 2, 2))
    kw = dict(steps=200, timestep_fs=1.0, ensemble="nvt_langevin",
              temperature_K=300.0, friction=0.5, initial_temperature_K=50.0,
              seed=5, cutoff=5.0, chunk_steps=100)
    _a, tlog = run_md_jit(model, cell, device="cpu", **kw)
    _j, jlog = jrun(jmodel, variables,
                    JAtoms(lattice_mat=cell.lattice_mat,
                           frac_coords=cell.frac_coords,
                           elements=cell.elements), **kw)
    t_port = np.mean([r["T"] for r in tlog.rows[100:]])
    t_jax = np.mean([r["T"] for r in jlog.rows[100:]])
    assert abs(t_port - 300.0) < 0.35 * 300.0, t_port
    assert abs(t_jax - 300.0) < 0.35 * 300.0, t_jax
    assert abs(t_port - t_jax) < 0.35 * t_jax


def test_md_jit_dense_asymmetric_chunk_falls_back(models, monkeypatch):
    """An asymmetric edge set mid-trajectory does not abort the run: that
    chunk takes the sparse layout and the trajectory continues."""
    import alignn_tpu_torch.graph.dense as gd
    from alignn_tpu_torch.ff.md_jit import run_md_jit

    real = gd.dense_batch_graphs
    fail = {"n": 1}

    def flaky(*a, **kw):
        if fail["n"]:
            fail["n"] -= 1
            raise gd.AsymmetricEdgesError("injected asymmetry")
        return real(*a, **kw)

    monkeypatch.setattr(gd, "dense_batch_graphs", flaky)
    a, log = run_md_jit(models[2], _atoms(), steps=6, timestep_fs=0.5,
                        ensemble="nve", initial_temperature_K=80.0, seed=3,
                        cutoff=5.0, chunk_steps=3, dense=True, device="cpu")
    assert fail["n"] == 0
    assert len(log.rows) == 6
    assert np.isfinite(a.cart_coords).all()


def test_md_jit_dense_matches_sparse(models):
    from alignn_tpu_torch.ff.md_jit import run_md_jit

    kw = dict(MD_KW, steps=6, chunk_steps=3, device="cpu")
    a_sparse, log_s = run_md_jit(models[2], _atoms(), **kw)
    a_dense, log_d = run_md_jit(models[2], _atoms(), dense=True, **kw)
    np.testing.assert_allclose(_wrapped_cart(a_dense),
                               _wrapped_cart(a_sparse),
                               rtol=1e-4, atol=1e-5)
    assert log_d.rows[-1]["etot"] == pytest.approx(
        log_s.rows[-1]["etot"], rel=1e-3)


def test_batch_relax_reduces_forces(models):
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.ff.calculator import Calculator
    from alignn_tpu_torch.ff.relax_jit import batch_relax

    model = models[2]
    structs = [Atoms(**c) for c in _rattled()]
    relaxed, energies, fmaxes = batch_relax(
        model, structs, fmax=1e-4, max_steps=50, chunk_steps=10,
        cutoff=5.0, device="cpu")
    assert len(relaxed) == 4
    assert np.isfinite(energies).all()
    calc = Calculator(model=model, device="cpu",
                      config={"neighbor_strategy": "radius_graph",
                              "cutoff": 5.0})
    for a0, a1, fm in zip(structs, relaxed, fmaxes):
        f0 = np.abs(calc.get_forces(a0)).max()
        f1 = np.abs(calc.get_forces(a1)).max()
        assert f1 <= f0 + 1e-6, (f0, f1)
        assert np.isfinite(fm)


def test_step_loop_reuses_a_batch_of_the_same_signature():
    """A graph and its moved copy (same indices) in one bucket give equal
    signatures; loading the second into a loop built on the first copies
    every tensor, Segments included.  A batch of another bucket is
    refused."""
    import dataclasses

    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.ff.step_loop import (StepLoop, batch_leaves,
                                               batch_signature)
    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.graph.build import build_graph

    g = build_graph(Atoms(**_rattled(1)[0]), neighbor_strategy="radius_graph",
                    cutoff=5.0)
    graphs = [g, dataclasses.replace(g, frac_coords=g.frac_coords + 0.01,
                                     r=g.r * 1.01)]
    spec = BucketSpec(n_nodes=128, n_edges=256, n_lg_edges=2048,
                      n_graphs=2)
    b0, b1 = (batch_graphs([x], spec, CPU, gather_windows=False)
              for x in graphs)
    assert batch_signature(b0) == batch_signature(b1)
    assert not torch.equal(b0.r, b1.r)
    loop = StepLoop(lambda: None, b0)
    assert not loop.use_graph            # the CPU runs the step eagerly
    loop.load_batch(b1)
    for t0, t1 in zip(batch_leaves(b0)[0], batch_leaves(b1)[0]):
        assert torch.equal(t0, t1)
    other = batch_graphs(graphs[:1], BucketSpec(
        n_nodes=256, n_edges=256, n_lg_edges=2048, n_graphs=2), CPU,
        gather_windows=False)
    with pytest.raises(ValueError, match="signature"):
        loop.load_batch(other)


def test_item_capacity_pads_with_empty_items():
    """Segments padded to their most possible work items: the extra items
    are empty row ranges at the end, the pointers unchanged, and the bound
    holds for random and for one-segment ids."""
    from alignn_tpu_torch.ops.eggc import CHUNK_ROWS, Segments

    rng = np.random.default_rng(2)
    for ids, num in ((np.sort(rng.integers(0, 50, 3000)), 60),
                     (np.zeros(1000, dtype=np.int64), 7),
                     (np.arange(300), 300)):
        seg = Segments.from_sorted(torch.as_tensor(ids), num)
        cap = seg.max_items()
        assert cap >= seg.num_items
        assert cap == len(ids) // CHUNK_ROWS + min(num, len(ids)) + 1
        big = seg.with_capacity(cap)
        assert big.num_items == cap and big.item_rows.numel() == cap + 1
        assert torch.equal(big.item_rows[:seg.num_items + 1], seg.item_rows)
        assert (big.item_rows[seg.num_items:] == len(ids)).all()
        assert torch.equal(big.item_ptr, seg.item_ptr)
        assert seg.with_capacity(seg.num_items) is seg
        with pytest.raises(ValueError, match="capacity"):
            seg.with_capacity(seg.num_items - 1)
