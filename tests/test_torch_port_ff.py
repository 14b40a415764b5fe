"""The port's host-loop FF modules against alignn_tpu's, on the CPU.

relax (FIRE, L-BFGS, MDMin, with and without the cell), md (every
ensemble), tasks (EOS fits, E-V curve, vacancies, slabs, surface and
interface energy), zur, phonons, phonons3 (fc3 and its ``.npz`` export,
Grüneisen, kappa), forcefield, the ASE adapter and ``cli.ff``.

Both packages are driven by the same analytic calculator written here, a
Lennard-Jones pair sum in numpy (energy, forces, virial stress), so a
comparison isolates the module: given the same inputs both sides do the
same floating-point work.  Relaxation trajectories agree within 1e-8 A,
MD logs and final states within 1e-10 (the numpy RNG is shared), fits,
force constants, frequencies and files exactly or to 1e-10.

Then the model end to end: FIRE on rattled rocksalt through the port's
and JAX's Calculators (the small model of ``tests/test_ff.py``, JAX's
weights carried by ``nn/convert.py``), and ``python -m
alignn_tpu_torch.cli.ff`` on a POSCAR in ``tmp_path`` against JAX's
ForceField on the same model directory.
"""

import json
import os
import sys
import types

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FCC = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
ROCKSALT = np.concatenate([FCC, FCC + [0.5, 0, 0]])
EXACT = dict(rtol=0, atol=1e-10)



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


class LJ:
    """Lennard-Jones pair sum over periodic images (numpy): energy, forces
    and the virial stress (eV/A^3, ASE sign), truncated and shifted at
    `cutoff`.  Counts its calls."""

    def __init__(self, epsilon=0.0104, sigma=3.4, cutoff=6.0):
        self.eps, self.sig, self.rc = epsilon, sigma, cutoff
        self.calls = 0

    def _phi(self, r):
        s6 = (self.sig / r) ** 6
        return 4 * self.eps * (s6 * s6 - s6)

    def calculate(self, atoms):
        self.calls += 1
        lat = np.asarray(atoms.lattice_mat, dtype=np.float64)
        cart = np.asarray(atoms.frac_coords, dtype=np.float64) @ lat
        n = cart.shape[0]
        reach = np.ceil(self.rc * np.linalg.norm(np.linalg.inv(lat),
                                                 axis=0)).astype(int)
        shifts = np.array([i * lat[0] + j * lat[1] + k * lat[2]
                           for i in range(-reach[0], reach[0] + 1)
                           for j in range(-reach[1], reach[1] + 1)
                           for k in range(-reach[2], reach[2] + 1)])
        d = (cart[None, :, None, :] + shifts[None, None, :, :]
             - cart[:, None, None, :])               # [i, j, image, 3]
        r = np.linalg.norm(d, axis=-1)
        keep = (r > 1e-8) & (r <= self.rc)
        rr = np.where(keep, r, 1.0)
        s6 = (self.sig / rr) ** 6
        e_pair = np.where(keep, 4 * self.eps * (s6 * s6 - s6)
                          - self._phi(self.rc), 0.0)
        dphi = np.where(keep, -24 * self.eps * (2 * s6 * s6 - s6) / rr,
                        0.0)
        energy = 0.5 * e_pair.sum()
        # F_i = sum_j phi'(r) d_ij / r  (d_ij points from i to j)
        forces = (dphi[..., None] * d / rr[..., None]).sum(axis=(1, 2))
        vol = abs(np.linalg.det(lat))
        stress = 0.5 * np.einsum("ijm,ijma,ijmb->ab", dphi / rr, d, d) / vol
        return {"energy": float(energy), "forces": forces,
                "stress_3x3": stress,
                "stress": np.array([stress[0, 0], stress[1, 1],
                                    stress[2, 2], stress[1, 2],
                                    stress[0, 2], stress[0, 1]])}

    def get_potential_energy(self, atoms):
        return self.calculate(atoms)["energy"]

    def get_forces(self, atoms):
        return self.calculate(atoms)["forces"]

    def get_stress(self, atoms):
        return self.calculate(atoms)["stress"]


def _pair(lat, frac, elements, rattle=0.0, seed=0):
    """The same structure as (port Atoms, JAX Atoms)."""
    from alignn_tpu.chem.atoms import Atoms as JAtoms
    from alignn_tpu_torch.chem.atoms import Atoms

    lat = np.asarray(lat, dtype=np.float64)
    cart = np.asarray(frac, dtype=np.float64) @ lat
    if rattle:
        cart = cart + np.random.default_rng(seed).normal(0, rattle,
                                                         cart.shape)
    frac = cart @ np.linalg.inv(lat)
    return (Atoms(lattice_mat=lat, frac_coords=frac, elements=elements),
            JAtoms(lattice_mat=lat, frac_coords=frac, elements=elements))


def _argon(rattle=0.05, a=5.4, cells=1):
    t, j = _pair(np.eye(3) * a, FCC, ["Ar"] * 4, rattle=rattle)
    if cells > 1:
        t, j = t.make_supercell((cells,) * 3), j.make_supercell((cells,) * 3)
    return t, j


def _close_atoms(a, b, atol):
    np.testing.assert_allclose(a.lattice_mat, b.lattice_mat, rtol=0,
                               atol=atol)
    np.testing.assert_allclose(a.cart_coords, b.cart_coords, rtol=0,
                               atol=atol)
    assert list(a.elements) == list(b.elements)


# ---------------------------------------------------------------------------
# atoms
# ---------------------------------------------------------------------------


def test_atoms_io_and_transforms_match_jax(tmp_path):
    t, j = _pair(np.array([[5.0, 0.1, 0], [0.3, 5.2, 0], [0.2, 0.1, 5.5]]),
                 ROCKSALT, ["Na"] * 4 + ["Cl"] * 4, rattle=0.05)
    assert t.to_poscar() == j.to_poscar()
    assert json.dumps(t.to_dict()) == json.dumps(j.to_dict())
    assert t.composition == j.composition and t.density == j.density
    np.testing.assert_array_equal(t.lattice.abc, j.lattice.abc)
    np.testing.assert_array_equal(t.lattice.angles, j.lattice.angles)
    np.testing.assert_array_equal(t.lattice.reciprocal, j.lattice.reciprocal)
    np.testing.assert_array_equal(t.lattice.inv_matrix, j.lattice.inv_matrix)
    p = np.array([[1, 1, 0], [-1, 1, 0], [0, 0, 1]])
    for tt, jj in ((t.make_supercell_matrix(p), j.make_supercell_matrix(p)),
                   (t.center_around_origin(), j.center_around_origin()),
                   (t.with_positions(cart_coords=t.cart_coords + 0.1),
                    j.with_positions(cart_coords=j.cart_coords + 0.1))):
        np.testing.assert_array_equal(tt.frac_coords, jj.frac_coords)
        np.testing.assert_array_equal(tt.lattice_mat, jj.lattice_mat)
    from alignn_tpu.chem.atoms import Atoms as JAtoms
    from alignn_tpu.chem.atoms import atomic_masses as jmasses
    from alignn_tpu_torch.chem.atoms import Atoms, atomic_masses, loadjson

    np.testing.assert_array_equal(atomic_masses(), jmasses())
    cif = ("data_x\n_cell_length_a 4.0\n_cell_length_b 4.1\n"
           "_cell_length_c 4.2\n_cell_angle_alpha 90\n_cell_angle_beta 95\n"
           "_cell_angle_gamma 100\nloop_\n_atom_site_label\n"
           "_atom_site_fract_x\n_atom_site_fract_y\n_atom_site_fract_z\n"
           "NA1 0.0 0.0 0.0\nCL1 0.5 0.5 0.5\n")
    xyz = "2\nwater-ish\nO 0.0 0.0 0.0\nH 0.96 0.0 0.0\n"
    pdb = ("ATOM      1  O   HOH A   1       0.000   0.000   0.000  1.00"
           "  0.00           O\nATOM      2  H1  HOH A   1       0.960"
           "   0.000   0.000  1.00  0.00           H\n")
    files = {"POSCAR": t.to_poscar(), "x.cif": cif, "x.xyz": xyz,
             "x.pdb": pdb}
    for name, text in files.items():
        path = tmp_path / name
        path.write_text(text)
        a, b = Atoms.from_file(str(path)), JAtoms.from_file(str(path))
        np.testing.assert_array_equal(a.frac_coords, b.frac_coords)
        np.testing.assert_array_equal(a.lattice_mat, b.lattice_mat)
        assert a.elements == b.elements
    from alignn_tpu_torch.chem.atoms import dumpjson

    dumpjson(t.to_dict(), str(tmp_path / "a.json"))
    assert Atoms.from_dict(loadjson(str(tmp_path / "a.json"))) \
        .to_poscar() == t.to_poscar()


# ---------------------------------------------------------------------------
# relax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("optimizer", ["fire", "lbfgs", "mdmin"])
@pytest.mark.parametrize("lattice", [False, True])
def test_relax_matches_jax(optimizer, lattice):
    """Every step of the trajectory (energy, fmax, structure) within 1e-8,
    and the result."""
    from alignn_tpu.ff.relax import relax as jrelax
    from alignn_tpu_torch.ff.relax import relax

    t, j = _argon(a=5.6)
    kw = dict(optimizer=optimizer, fmax=1e-4, steps=40,
              optimize_lattice=lattice, scalar_pressure=0.001 * lattice)
    ttraj, jtraj = [], []
    ta, te, tn = relax(LJ(), t, trajectory=ttraj, **kw)
    ja, je, jn = jrelax(LJ(), j, trajectory=jtraj, **kw)
    assert tn == jn and len(ttraj) == len(jtraj) > 5
    for x, y in zip(ttraj, jtraj):
        assert abs(x["energy"] - y["energy"]) < 1e-8
        assert abs(x["fmax"] - y["fmax"]) < 1e-8
        np.testing.assert_allclose(x["atoms"]["coords"], y["atoms"]["coords"],
                                   rtol=0, atol=1e-8)
        np.testing.assert_allclose(x["atoms"]["lattice_mat"],
                                   y["atoms"]["lattice_mat"], rtol=0,
                                   atol=1e-8)
    _close_atoms(ta, ja, 1e-8)
    assert abs(te - je) < 1e-8
    assert ttraj[-1]["fmax"] < 0.5 * ttraj[0]["fmax"]


def test_relax_rejects_unknown_optimizer():
    from alignn_tpu_torch.ff.relax import relax

    with pytest.raises(ValueError, match="unknown optimizer"):
        relax(LJ(), _argon()[0], optimizer="bfgs2")


# ---------------------------------------------------------------------------
# md
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ensemble", [
    "nve", "nvt_langevin", "nvt_andersen", "nvt_berendsen",
    "nvt_nose_hoover", "npt_berendsen", "npt_nose_hoover"])
def test_md_ensembles_match_jax(ensemble):
    """Every logged row and the final positions, velocities and cell
    within 1e-10 (the same numpy RNG streams on both sides)."""
    from alignn_tpu.ff.md import run_md as jrun
    from alignn_tpu_torch.ff.md import run_md

    t, j = _argon(rattle=0.02, cells=2)
    kw = dict(ensemble=ensemble, steps=12, timestep_fs=2.0,
              temperature_K=60.0, pressure_GPa=0.1, friction=0.05, seed=4,
              log_interval=3, taut_fs=20.0, taup_fs=50.0)
    ttraj, jtraj = [], []
    ts, tlog = run_md(LJ(), t, trajectory=ttraj, **kw)
    js, jlog = jrun(LJ(), j, trajectory=jtraj, **kw)
    assert len(tlog.rows) == len(jlog.rows) == 5
    for x, y in zip(tlog.rows, jlog.rows):
        assert x.keys() == y.keys()
        for k in x:
            assert abs(x[k] - y[k]) <= 1e-10 * max(1.0, abs(y[k])), k
    np.testing.assert_allclose(ts.velocities, js.velocities, **EXACT)
    _close_atoms(ts.atoms, js.atoms, 1e-10)
    assert len(ttraj) == len(jtraj) == 5
    assert np.abs(ts.atoms.cart_coords - t.cart_coords).max() > 1e-4


def test_md_helpers_match_jax():
    from alignn_tpu.ff.md import maxwell_boltzmann_velocities as jmb
    from alignn_tpu_torch.ff.md import MDState, maxwell_boltzmann_velocities

    t, j = _argon(cells=2)
    v = maxwell_boltzmann_velocities(t, 300.0, seed=7)
    np.testing.assert_array_equal(v, jmb(j, 300.0, seed=7))
    from alignn_tpu_torch.chem.atoms import atomic_masses

    m = atomic_masses()[t.atomic_numbers]
    np.testing.assert_allclose((m[:, None] * v).sum(axis=0), 0, atol=1e-12)
    assert MDState(t, v, m).temperature > 0
    from alignn_tpu_torch.ff.md import run_md

    with pytest.raises(ValueError, match="unknown ensemble"):
        run_md(LJ(), t, ensemble="nvt_langevn")


# ---------------------------------------------------------------------------
# tasks and zur
# ---------------------------------------------------------------------------


def test_eos_fits_match_jax():
    from alignn_tpu.ff import tasks as jt
    from alignn_tpu_torch.ff import tasks as tt

    v = np.linspace(36.0, 44.0, 9)
    e = 0.02 * (v - 40.3) ** 2 - 0.001 * (v - 40.3) ** 3 - 8.0
    for name in ("fit_murnaghan", "fit_birch_murnaghan"):
        a, b = getattr(tt, name)(v, e), getattr(jt, name)(v, e)
        assert a.keys() == b.keys()
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-10 * max(1.0, abs(b[k])), (name, k)
        assert abs(a["V0"] - 40.3) < 0.2


def test_ev_curve_matches_jax():
    from alignn_tpu.ff.tasks import ev_curve as jev
    from alignn_tpu_torch.ff.tasks import ev_curve

    t, j = _argon(rattle=0.0, a=5.5)
    a = ev_curve(LJ(), t, fmax=1e-3, steps=60)
    b = jev(LJ(), j, fmax=1e-3, steps=60)
    np.testing.assert_allclose(a["volumes"], b["volumes"], **EXACT)
    np.testing.assert_allclose(a["energies"], b["energies"], **EXACT)
    for key in ("eos", "eos_birch_murnaghan"):
        for k in a[key]:
            assert abs(a[key][k] - b[key][k]) <= 1e-8 * max(
                1.0, abs(b[key][k])), (key, k)
    assert a["kv"] == pytest.approx(b["kv"], rel=1e-10)
    assert a["kv"] > 0


@pytest.mark.parametrize("miller", [(1, 1, 1), (1, 0, 0), (1, 1, 0),
                                    (3, 2, 1), (0, 0, 1)])
def test_make_slab_matches_jax(miller):
    from alignn_tpu.ff.tasks import make_slab as jslab
    from alignn_tpu_torch.ff.tasks import make_slab

    t, j = _pair(np.eye(3) * 5.64, ROCKSALT, ["Na"] * 4 + ["Cl"] * 4)
    a, b = make_slab(t, miller, layers=2), jslab(j, miller, layers=2)
    np.testing.assert_array_equal(a.lattice_mat, b.lattice_mat)
    np.testing.assert_array_equal(a.frac_coords, b.frac_coords)
    assert a.elements == b.elements


def test_vacancy_and_surface_energy_match_jax():
    from alignn_tpu.ff import tasks as jt
    from alignn_tpu_torch.ff import tasks as tt

    t, j = _argon(rattle=0.0, a=5.3)
    a = tt.vacancy_formation(LJ(), t, supercell=(1, 1, 2), fmax=1e-3,
                             steps=30)
    b = jt.vacancy_formation(LJ(), j, supercell=(1, 1, 2), fmax=1e-3,
                             steps=30)
    assert [r["element"] for r in a] == [r["element"] for r in b] == ["Ar"]
    for x, y in zip(a, b):
        for k in ("E_vacancy", "E_bulk", "mu", "E_formation"):
            assert abs(x[k] - y[k]) < 1e-8, k
    assert [(el, v.num_atoms) for el, v in tt.generate_vacancies(t)] == \
        [(el, v.num_atoms) for el, v in jt.generate_vacancies(j)]
    s = tt.surface_energy(LJ(), t, miller=(1, 0, 0), layers=2, fmax=1e-3,
                          steps=20)
    r = jt.surface_energy(LJ(), j, miller=(1, 0, 0), layers=2, fmax=1e-3,
                          steps=20)
    for k in s:
        if isinstance(s[k], float):
            assert abs(s[k] - r[k]) < 1e-8, k
        else:
            assert s[k] == r[k], k
    assert s["surface_energy_J_m2"] > 0


def test_interface_energy_and_zur_match_jax():
    from alignn_tpu.ff import tasks as jt
    from alignn_tpu.ff import zur as jz
    from alignn_tpu_torch.ff import tasks as tt
    from alignn_tpu_torch.ff import zur as tz

    film = _pair(np.eye(3) * 5.3, FCC, ["Ar"] * 4)
    sub = _pair(np.eye(3) * 5.5, FCC, ["Ar"] * 4)
    a = tt.get_interface_energy(LJ(), film[0], sub[0], fmax=1e-2, steps=5,
                                film_layers=1, subs_layers=1)
    b = jt.get_interface_energy(LJ(), film[1], sub[1], fmax=1e-2, steps=5,
                                film_layers=1, subs_layers=1)
    assert a.keys() == b.keys() and a["zur_matched"] == b["zur_matched"]
    for k in a:
        if isinstance(a[k], float):
            assert abs(a[k] - b[k]) < 1e-8, k
        elif k != "interface":
            assert a[k] == b[k], k
    np.testing.assert_allclose(a["interface"]["coords"],
                               b["interface"]["coords"], **EXACT)
    # two lattices that match only as superlattices
    f_ab = np.array([[3.0, 0, 0], [0, 3.0, 0]])
    s_ab = np.array([[4.24, 0, 0], [0, 4.24, 0]])
    ms, mj = tz.zur_matches(f_ab, s_ab), jz.zur_matches(f_ab, s_ab)
    assert len(ms) == len(mj) > 0
    for x, y in zip(ms, mj):
        np.testing.assert_array_equal(x.film_transform, y.film_transform)
        np.testing.assert_array_equal(x.substrate_transform,
                                      y.substrate_transform)
        np.testing.assert_array_equal(x.strain, y.strain)
        assert x.area == y.area
    best, jbest = tz.best_match(f_ab, s_ab), jz.best_match(f_ab, s_ab)
    assert best.area == jbest.area == ms[0].area
    np.testing.assert_array_equal(best.film_sl, jbest.film_sl)
    assert best.mean_abs_strain == jbest.mean_abs_strain < 0.03


# ---------------------------------------------------------------------------
# phonons and phonons3
# ---------------------------------------------------------------------------


def test_phonons_match_jax(tmp_path):
    from alignn_tpu.ff import phonons as jp
    from alignn_tpu_torch.ff import phonons as tp

    prim = _pair(np.array([[0, 2.7, 2.7], [2.7, 0, 2.7], [2.7, 2.7, 0]]),
                 [[0, 0, 0]], ["Ar"])
    a = tp.phonon_band_structure(LJ(), prim[0], supercell=(3, 3, 3),
                                 npoints=5)
    b = jp.phonon_band_structure(LJ(), prim[1], supercell=(3, 3, 3),
                                 npoints=5)
    np.testing.assert_allclose(a["fcdata"]["fc"], b["fcdata"]["fc"],
                               **EXACT)
    np.testing.assert_allclose(a["frequencies_THz"], b["frequencies_THz"],
                               **EXACT)
    np.testing.assert_allclose(a["distances"], b["distances"], **EXACT)
    assert a["labels"] == b["labels"] and a["qpoints"] == b["qpoints"]
    q = np.array([0.1, 0.2, 0.3])
    np.testing.assert_allclose(tp.dynamical_matrix(a["fcdata"], q),
                               jp.dynamical_matrix(b["fcdata"], q), **EXACT)
    d1 = tp.phonon_dos(a["fcdata"], mesh=(3, 3, 3))
    d2 = jp.phonon_dos(b["fcdata"], mesh=(3, 3, 3))
    np.testing.assert_allclose(d1["dos"], d2["dos"], **EXACT)
    th1 = tp.thermal_properties(a["fcdata"], [0, 50, 300], mesh=(3, 3, 3))
    th2 = jp.thermal_properties(b["fcdata"], [0, 50, 300], mesh=(3, 3, 3))
    for k in th1:
        np.testing.assert_allclose(th1[k], th2[k], **EXACT)
    tp.export_force_constants(a["fcdata"], str(tmp_path / "t_FC"))
    jp.export_force_constants(b["fcdata"], str(tmp_path / "j_FC"))
    assert (tmp_path / "t_FC").read_text() == (tmp_path / "j_FC").read_text()
    gamma = tp.phonon_frequencies(a["fcdata"], np.zeros(3))
    assert np.abs(gamma).max() < 1e-3          # one atom: acoustic only
    assert max(a["frequencies_THz"][5]) > 0.1


def test_phonons3_match_jax(tmp_path):
    from alignn_tpu.ff import phonons3 as jp3
    from alignn_tpu_torch.ff import phonons3 as tp3

    t, j = _pair(np.eye(3) * 5.3, FCC, ["Ar"] * 4)
    a = tp3.third_order_fc(LJ(), t, supercell=(1, 1, 1), pair_cutoff=3.8)
    b = jp3.third_order_fc(LJ(), j, supercell=(1, 1, 1), pair_cutoff=3.8)
    assert a["pairs"] == b["pairs"] and a["n_force_calls"] == \
        b["n_force_calls"] > 0
    np.testing.assert_allclose(a["fc3"], b["fc3"], **EXACT)
    # the .npz layout (what export_fc3 writes where h5py is absent)
    pa = tp3.export_fc3(a, str(tmp_path / "t_fc3.npz"), sc_atoms=t)
    pb = jp3.export_fc3(b, str(tmp_path / "j_fc3.npz"), sc_atoms=j)
    za, zb = np.load(pa), np.load(pb)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k])
    assert za["fc3"].shape == (4, 4, 4, 3, 3, 3)
    # an .hdf5 path: the hdf5 file where h5py is installed, else the .npz
    pa = tp3.export_fc3(a, str(tmp_path / "t_fc3.hdf5"))
    pb = jp3.export_fc3(b, str(tmp_path / "j_fc3.hdf5"))
    assert os.path.splitext(pa)[1] == os.path.splitext(pb)[1]
    if pa.endswith(".hdf5"):
        import h5py

        with h5py.File(pa) as fa, h5py.File(pb) as fb:
            np.testing.assert_array_equal(fa["fc3"][()], fb["fc3"][()])
            np.testing.assert_array_equal(fa["p2s_map"][()],
                                          fb["p2s_map"][()])
    g1 = tp3.mode_gruneisen(LJ(), t, supercell=(1, 1, 1))
    g2 = jp3.mode_gruneisen(LJ(), j, supercell=(1, 1, 1))
    np.testing.assert_allclose(g1["gruneisen"], g2["gruneisen"], **EXACT)
    k1 = tp3.thermal_conductivity(LJ(), t, supercell=(1, 1, 1),
                                  mesh=(2, 2, 2))
    k2 = jp3.thermal_conductivity(LJ(), j, supercell=(1, 1, 1),
                                  mesh=(2, 2, 2))
    np.testing.assert_allclose(k1["kappa_w_mk"], k2["kappa_w_mk"],
                               rtol=1e-10)
    assert k1["theta_d_K"] == pytest.approx(k2["theta_d_K"], rel=1e-10)


# ---------------------------------------------------------------------------
# forcefield and the ASE adapter
# ---------------------------------------------------------------------------


def test_forcefield_matches_jax(tmp_path):
    """The ForceField's tasks over the LJ calculator: energies, relaxed and
    MD end states, and the artifacts each writes."""
    from alignn_tpu.ff.forcefield import ForceField as JForceField
    from alignn_tpu_torch.ff.forcefield import ForceField

    t, j = _argon(rattle=0.03)
    tf = ForceField(t, calculator=LJ(), dirname=str(tmp_path / "t"))
    jf = JForceField(j, calculator=LJ(), dirname=str(tmp_path / "j"))
    assert tf.unrelaxed_atoms() == jf.unrelaxed_atoms()
    for opt in ("FIRE", "LBFGS"):
        (ta, te), (ja, je) = (ff.optimize_atoms(steps=10, optimizer=opt)
                              for ff in (tf, jf))
        _close_atoms(ta, ja, 1e-8)
        assert abs(te - je) < 1e-8
    for name in ("run_nve_velocity_verlet", "run_nvt_langevin",
                 "run_nvt_andersen", "run_nvt_berendsen",
                 "run_npt_berendsen", "run_nvt_nose_hoover",
                 "run_npt_nose_hoover"):
        (ta, tl), (ja, jl) = (getattr(ff, name)(steps=4) for ff in (tf, jf))
        _close_atoms(ta, ja, 1e-10)
    for task in ("t", "j"):
        assert os.path.exists(tmp_path / task / "opt.traj.json")
        assert os.path.exists(tmp_path / task / "nve.traj.json")
    log_t = (tmp_path / "t" / "alignn_ff.log").read_text().splitlines()
    log_j = (tmp_path / "j" / "alignn_ff.log").read_text().splitlines()
    assert len(log_t) == len(log_j) > 10
    for x, y in zip(log_t, log_j):
        if x.startswith("{"):
            rx, ry = json.loads(x), json.loads(y)
            assert rx.keys() == ry.keys()
            for k in rx:
                if isinstance(rx[k], float):
                    assert abs(rx[k] - ry[k]) <= 1e-8 * max(1, abs(ry[k]))


def test_forcefield_needs_a_model():
    from alignn_tpu_torch.ff.forcefield import ForceField

    with pytest.raises(ValueError, match="model_path"):
        ForceField(_argon()[0])


def _forge_ase(monkeypatch):
    ase = types.ModuleType("ase")
    calcs = types.ModuleType("ase.calculators")
    calcmod = types.ModuleType("ase.calculators.calculator")

    class Calculator:
        def __init__(self, **kwargs):
            self.results = {}

        def calculate(self, atoms=None, properties=None,
                      system_changes=None):
            if atoms is not None:
                self.atoms = atoms

    calcmod.Calculator = Calculator
    calcmod.all_changes = ["positions", "numbers", "cell", "pbc"]
    ase.calculators = calcs
    calcs.calculator = calcmod
    monkeypatch.setitem(sys.modules, "ase", ase)
    monkeypatch.setitem(sys.modules, "ase.calculators", calcs)
    monkeypatch.setitem(sys.modules, "ase.calculators.calculator", calcmod)


class _FakeAseAtoms:
    def __init__(self, atoms):
        self.cell = np.asarray(atoms.lattice_mat)
        self._frac = np.asarray(atoms.frac_coords)
        self._symbols = list(atoms.elements)

    def get_scaled_positions(self):
        return self._frac

    def get_chemical_symbols(self):
        return self._symbols


# ---------------------------------------------------------------------------
# the model end to end: Calculators, the ASE adapter and cli.ff
# ---------------------------------------------------------------------------


SMALL_FF = dict(name="alignn_atomwise", alignn_layers=1, gcn_layers=1,
                hidden_features=16, embedding_features=8,
                gradwise_weight=1.0, stresswise_weight=0.1)
FF_CONFIG = {"neighbor_strategy": "k-nearest", "cutoff": 5.0,
             "max_neighbors": 12}


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """The small model of tests/test_ff.py (JAX init, seed 0) saved as a
    model directory: config.json + best_model.mpk."""
    import jax

    from alignn_tpu.chem.atoms import Atoms as JAtoms
    from alignn_tpu.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu.graph.build import build_graph
    from alignn_tpu.nn.models import ALIGNNAtomWise, ALIGNNAtomWiseConfig
    from alignn_tpu.train.checkpoint import checkpoint_meta, save_params

    model = ALIGNNAtomWise(cfg=ALIGNNAtomWiseConfig(**SMALL_FF))
    probe = JAtoms(lattice_mat=np.eye(3) * 4.0,
                   frac_coords=[[0, 0, 0], [0.5, 0.5, 0.5]],
                   elements=["Na", "Cl"])
    g = build_graph(probe, cutoff=5.0, max_neighbors=12)
    batch = batch_graphs([g], BucketSpec.tight_for_batch([g]))
    variables = model.init(jax.random.PRNGKey(0), batch, batch.r,
                           train=False)
    d = tmp_path_factory.mktemp("small_ff")
    with open(d / "config.json", "w") as f:
        json.dump({**FF_CONFIG, "model": SMALL_FF}, f)
    save_params(str(d / "best_model.mpk"), variables["params"],
                meta=checkpoint_meta())
    return str(d)


def test_fire_relax_through_both_calculators(model_dir):
    """FIRE on rattled rocksalt NaCl through the port's and JAX's
    Calculators (k-NN, 12 neighbours, cutoff 5): every step's energy
    within 1e-4 eV and the relaxed positions within 1e-4 A (f32 models on
    both sides)."""
    from alignn_tpu.ff.calculator import Calculator as JCalculator
    from alignn_tpu.ff.relax import fire_relax as jfire
    from alignn_tpu_torch.ff.calculator import Calculator
    from alignn_tpu_torch.ff.relax import fire_relax

    t, j = _pair(np.eye(3) * 5.64, ROCKSALT, ["Na"] * 4 + ["Cl"] * 4,
                 rattle=0.08)
    ttraj, jtraj = [], []
    ta, te, tn = fire_relax(Calculator(path=model_dir, device="cpu"), t,
                            fmax=1e-3, steps=15, trajectory=ttraj)
    ja, je, jn = jfire(JCalculator(path=model_dir), j, fmax=1e-3, steps=15,
                       trajectory=jtraj)
    assert tn == jn
    for x, y in zip(ttraj, jtraj):
        assert abs(x["energy"] - y["energy"]) < 1e-4
    _close_atoms(ta, ja, 1e-4)
    assert abs(te - je) < 1e-4
    assert ttraj[-1]["fmax"] < ttraj[0]["fmax"]


def test_ase_adapter_wraps_the_port(model_dir, monkeypatch):
    import importlib

    import alignn_tpu_torch.ff.ase_adapter as mod
    from alignn_tpu_torch.ff.calculator import Calculator

    with pytest.raises(ImportError, match="ase is not installed"):
        mod.AlignnAtomWiseCalculator(path=model_dir, device="cpu")
    _forge_ase(monkeypatch)
    mod = importlib.reload(mod)
    try:
        assert mod.HAVE_ASE
        atoms = _pair(np.eye(3) * 5.64, ROCKSALT,
                      ["Na"] * 4 + ["Cl"] * 4, rattle=0.05)[0]
        res = mod.AlignnAtomWiseCalculator(path=model_dir, device="cpu") \
            .calculate(_FakeAseAtoms(atoms))
        ref = Calculator(path=model_dir, device="cpu").calculate(atoms)
        assert res["energy"] == res["free_energy"] == ref["energy"]
        np.testing.assert_array_equal(res["forces"], ref["forces"])
        np.testing.assert_array_equal(res["stress"], ref["stress"])
    finally:
        monkeypatch.undo()
        importlib.reload(mod)


def test_cli_ff_on_a_poscar(model_dir, tmp_path, capsys):
    """``python -m alignn_tpu_torch.cli.ff --task optimize --device cpu``
    on a rattled rocksalt POSCAR: the printed energy and structure
    against JAX's ForceField on the same directory (1e-4), and the
    artifacts; ``--help`` lists ``--device``."""
    from alignn_tpu.chem.atoms import Atoms as JAtoms
    from alignn_tpu.ff.forcefield import ForceField as JForceField
    from alignn_tpu_torch.cli import ff as cli

    t, _ = _pair(np.eye(3) * 5.64, ROCKSALT, ["Na"] * 4 + ["Cl"] * 4,
                 rattle=0.08)
    poscar = tmp_path / "POSCAR"
    poscar.write_text(t.to_poscar())
    out_dir = tmp_path / "out"
    cli.main(["--model_path", model_dir, "--file_path", str(poscar),
              "--task", "optimize", "--opt_steps", "8", "--fmax", "1e-3",
              "--output_dir", str(out_dir), "--device", "cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jff = JForceField(JAtoms.from_file(str(poscar)), model_path=model_dir,
                      dirname=str(tmp_path / "jax"))
    ja, je = jff.optimize_atoms(fmax=1e-3, steps=8)
    assert abs(res["energy"] - je) < 1e-4
    np.testing.assert_allclose(res["atoms"]["lattice_mat"],
                               ja.lattice_mat, rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(res["atoms"]["coords"]) @ np.asarray(
            res["atoms"]["lattice_mat"]), ja.cart_coords, rtol=0, atol=1e-4)
    assert (out_dir / "opt.traj.json").exists()
    assert (out_dir / "alignn_ff.log").exists()
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    assert "--device" in capsys.readouterr().out
