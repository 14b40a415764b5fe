"""The port's C++ neighbour list against alignn_tpu's, on the CPU.

``alignn_tpu_torch/native/neighbors.cpp`` is a copy of
``alignn_tpu/native/neighbors.cpp``, built by ``g++`` into
``build/alignn_tpu_torch/`` at first use.  Here both packages run their
C++ lists:

- the pairs (``src, dst, images, disp, dist``) are byte-equal, and so is
  every array of ``build_graph`` for k-NN with ``use_canonize`` true and
  false, ``tie_tol`` 0 and 1e-6, and for the radius and jarvis radius
  strategies, on the perfect diamond cell (its degenerate second shell),
  the diamond cell strained by +-0.5 %, a cell with an atom at fractional
  -2.7e-17 (the corner that ``% 1.0`` wraps to 1.0), rattled 64- and
  512-atom Si, rocksalt NaCl and fcc Cu;
- on the rattled cells the port's C++ and numpy k-NN graphs are
  byte-equal, and so are its radius graphs but for the bond vectors,
  within 1e-12 A (a radius graph takes the search's own displacements,
  which the two searches round each their own way);
- two processes that build the library at once both load it.

alignn_tpu compiles its own library in place at first use (``g++ -o``
next to its source), so a test process may find it half written by
another; the tests that run it first wait for it to be whole
(:func:`jax_native`).
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
from torch_port_threads import _two_threads  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIAMOND = np.array([[0, 0, 0], [0.25, 0.25, 0.25], [0, 0.5, 0.5],
                    [0.25, 0.75, 0.75], [0.5, 0, 0.5], [0.75, 0.25, 0.75],
                    [0.5, 0.5, 0], [0.75, 0.75, 0.25]])
FCC = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
ROCKSALT = np.concatenate([FCC, FCC + [0.5, 0, 0]])


def _rattled_si(n, seed=0):
    lat = np.eye(3) * 5.43 * n
    frac = np.concatenate([(DIAMOND + img) / n for img in np.ndindex(n, n, n)])
    cart = frac @ lat + np.random.default_rng(seed).normal(0, 0.03,
                                                           frac.shape)
    return lat, cart @ np.linalg.inv(lat), ["Si"] * len(frac)


def _corner():
    frac = DIAMOND.astype(np.float64).copy()
    frac[0] = [-2.7e-17, 0.0, -2.7e-17]
    return np.eye(3) * 5.43, frac, ["Si"] * 8


STRUCTURES = {
    "diamond8": (np.eye(3) * 5.43, DIAMOND, ["Si"] * 8),
    "diamond8_plus": (np.eye(3) * 5.43 * 1.005, DIAMOND, ["Si"] * 8),
    "diamond8_minus": (np.eye(3) * 5.43 * 0.995, DIAMOND, ["Si"] * 8),
    "corner": _corner(),
    "si64_rattled": _rattled_si(2),
    "si512_rattled": _rattled_si(4),
    "rocksalt": (np.eye(3) * 5.64, ROCKSALT, ["Na"] * 4 + ["Cl"] * 4),
    "fcc_cu": (np.eye(3) * 3.61, FCC, ["Cu"] * 4),
}
GRAPHS = [  # build_graph arguments
    dict(neighbor_strategy="k-nearest", cutoff=8.0, use_canonize=False,
         tie_tol=0.0),
    dict(neighbor_strategy="k-nearest", cutoff=8.0, use_canonize=True,
         tie_tol=0.0),
    dict(neighbor_strategy="k-nearest", cutoff=8.0, use_canonize=False,
         tie_tol=1e-6),
    dict(neighbor_strategy="k-nearest", cutoff=8.0, use_canonize=True,
         tie_tol=1e-6),
    dict(neighbor_strategy="radius_graph", cutoff=4.5),
    dict(neighbor_strategy="radius_graph_jarvis", cutoff=4.0),
]
FIELDS = ("z", "frac_coords", "lattice", "src", "dst", "r", "images",
          "lg_src", "lg_dst")


def _wait_until_still(path: str, deadline: float, quiet_s: float = 1.0):
    """Return once `path` is absent or its size has not changed for
    `quiet_s` seconds (or at `deadline`)."""
    last, since = None, time.monotonic()
    while time.monotonic() < deadline:
        size = os.path.getsize(path) if os.path.exists(path) else None
        if size is None:
            return
        if size != last:
            last, since = size, time.monotonic()
        elif time.monotonic() - since >= quiet_s:
            return
        time.sleep(0.1)


@pytest.fixture(scope="module")
def jax_native():
    """alignn_tpu's C++ neighbour library, loaded once it is whole.

    Wait until the library file's size is still, then load it; a load
    that still meets a partial file (``OSError``: "file too short") waits
    and loads again, for at most three minutes."""
    from alignn_tpu import native as jnative

    lib = os.path.join(os.path.dirname(jnative.__file__), "libneighbors.so")
    deadline = time.monotonic() + 180.0
    while True:
        _wait_until_still(lib, deadline)
        try:
            loaded = jnative.neighbors_lib()
            break
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.5)
    assert loaded is not None          # g++ is on this host
    return loaded


def _both_atoms(name):
    from alignn_tpu.chem.atoms import Atoms as JAtoms
    from alignn_tpu_torch.chem.atoms import Atoms

    lat, frac, el = STRUCTURES[name]
    return (Atoms(lattice_mat=lat, frac_coords=frac, elements=el),
            JAtoms(lattice_mat=lat, frac_coords=frac, elements=el))


def _assert_same_bytes(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                        b.dtype, a.shape,
                                                        b.shape)
    assert a.tobytes() == b.tobytes(), what


def test_native_library_is_built_outside_the_package():
    from alignn_tpu_torch import _build, native

    assert native.neighbors_lib() is not None       # g++ is on this host
    path = native.library_path("neighbors")
    assert path.exists()
    assert path.parent == _build.BUILD_DIR
    assert os.path.relpath(_build.BUILD_DIR, REPO) == os.path.join(
        "build", "alignn_tpu_torch")
    assert not [f for f in os.listdir(native.SRC_DIR) if f.endswith(".so")]


@pytest.mark.parametrize("name", sorted(STRUCTURES))
@pytest.mark.parametrize("cutoff", [4.5, 8.0])
def test_pairs_equal_jax_native(name, cutoff, jax_native):
    from alignn_tpu.native import periodic_pairs_native as jpairs
    from alignn_tpu_torch.native import periodic_pairs_native

    atoms, _ = _both_atoms(name)
    ours = periodic_pairs_native(atoms.lattice_mat, atoms.frac_coords,
                                 cutoff)
    ref = jpairs(atoms.lattice_mat, atoms.frac_coords, cutoff)
    assert ours is not None and ref is not None
    for what, a, b in zip(("src", "dst", "images", "disp", "dist"), ours,
                          ref):
        _assert_same_bytes(a, b, what)
    assert len(ours[0]) > 0


@pytest.mark.parametrize("name", sorted(STRUCTURES))
@pytest.mark.parametrize("kw", GRAPHS, ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_build_graph_equals_jax_native(name, kw, jax_native):
    from alignn_tpu.graph.build import build_graph as jbuild
    from alignn_tpu_torch.graph.build import build_graph

    atoms, jatoms = _both_atoms(name)
    ours, ref = build_graph(atoms, **kw), jbuild(jatoms, **kw)
    for f in FIELDS:
        _assert_same_bytes(getattr(ours, f), getattr(ref, f), f)
    assert ours.volume == ref.volume


def test_perfect_diamond_keeps_its_degenerate_shell():
    """tie_tol 0 on the perfect crystal keeps all 16 neighbours of the
    tied 12th-16th shell on both packages; 1e-6 too."""
    from alignn_tpu_torch.graph.build import build_graph

    atoms, _ = _both_atoms("diamond8")
    for tie_tol in (0.0, 1e-6):
        g = build_graph(atoms, cutoff=8.0, use_canonize=False,
                        tie_tol=tie_tol)
        assert set(np.bincount(g.dst)) == {32}, tie_tol


@pytest.mark.parametrize("name", ["si64_rattled", "si512_rattled"])
def test_native_equals_numpy_on_rattled_cells(name, monkeypatch):
    from alignn_tpu_torch import native
    from alignn_tpu_torch.graph.build import build_graph

    atoms, _ = _both_atoms(name)
    kinds = [GRAPHS[0], GRAPHS[3], GRAPHS[4]]
    fast = [build_graph(atoms, **kw) for kw in kinds]
    monkeypatch.setattr(native, "periodic_pairs_native",
                        lambda *a, **k: None)
    slow = [build_graph(atoms, **kw) for kw in kinds]
    for kw, a, b in zip(kinds, fast, slow):
        if kw["neighbor_strategy"] == "k-nearest":
            for f in FIELDS:
                _assert_same_bytes(getattr(a, f), getattr(b, f), f)
            continue
        # radius: the bond vectors are the searches' own displacements
        for f in FIELDS:
            if f != "r":
                _assert_same_bytes(getattr(a, f), getattr(b, f), f)
        np.testing.assert_allclose(a.r, b.r, rtol=0, atol=1e-12)


def test_concurrent_builds_both_load(tmp_path):
    """Two processes building into one empty directory at once: each
    compiles under its own temporary name, publishes with os.replace and
    loads a whole library."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "import numpy as np\n"
        "from alignn_tpu_torch import _build, native\n"
        "_build.BUILD_DIR = Path(sys.argv[1])\n"
        "p = native.periodic_pairs_native(np.eye(3) * 4.0, "
        "np.array([[0.0, 0, 0], [0.5, 0.5, 0.5]]), 4.0)\n"
        "assert native.library_path('neighbors').parent == _build.BUILD_DIR\n"
        "print(len(p[0]))\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=REPO)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (_out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0] == outs[1][0] and int(outs[0][0]) > 0
    libs = [f for f in os.listdir(tmp_path) if f.endswith(".so")]
    assert len(libs) == 1 and not [f for f in os.listdir(tmp_path)
                                   if f.endswith(".tmp")]
