"""alignn_tpu_torch's graph-parallel host indices against alignn_tpu's.

The ring index (``parallel/gp_batch.py``: ``make_ring_index``, forced step
widths, ``make_stacked_ring`` with a floor) and the dense halo plan
(``parallel/dense_gp.py``: ``make_dense_gp_index``, ``_repack_forced``,
``make_stacked_dense_index``) equal JAX's array for array, over batches of
small cells and one supercell that spans the shards, on 2 and 4 ranks.
Each rank's ring steps index only its shard, their destinations ascend
(the CSR the K2 sum reads), and every real L-edge sits in exactly one
step.  Host numpy only.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_port_dp import _jax_graphs  # noqa: E402
from torch_port_threads import _two_threads  # noqa: E402,F401


def _graphs(kind):
    from alignn_tpu_torch.graph.build import rocksalt_graphs

    if kind == "cells":
        return rocksalt_graphs(3, seed=5, rattle=0.05)
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.graph.build import (ROCKSALT_ELEMENTS,
                                              ROCKSALT_FRAC, build_graph)

    rng = np.random.default_rng(9)
    shifts = np.array([[i, j, k] for i in range(2) for j in range(2)
                       for k in range(2)])
    frac = ((ROCKSALT_FRAC[None] + shifts[:, None]) / 2).reshape(-1, 3)
    atoms = Atoms(lattice_mat=np.eye(3) * 8.4,
                  frac_coords=frac + 0.01 * rng.standard_normal(frac.shape),
                  elements=ROCKSALT_ELEMENTS * 8)
    return [build_graph(atoms, cutoff=8.0, max_neighbors=12)]


def _batches(kind, dense):
    """(port batch, JAX batch) of the same graphs in the same bucket."""
    import torch

    from alignn_tpu.graph.batch import BucketSpec as JSpec
    from alignn_tpu.graph.batch import batch_graphs as jbatch
    from alignn_tpu.graph.dense import dense_batch_graphs as jdense
    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.graph.dense import (dense_batch_graphs,
                                              dense_spec_for_batch)

    graphs = _graphs(kind)
    if dense:
        spec = dense_spec_for_batch(graphs, node_quantum=16)
        js = JSpec(spec.n_nodes, spec.n_edges, spec.n_lg_edges,
                   spec.n_graphs, spec.dense_D)
        return (dense_batch_graphs(graphs, spec, torch.device("cpu")),
                jdense(_jax_graphs(graphs), js))
    spec = BucketSpec.tight_for_batch(graphs)
    js = JSpec(spec.n_nodes, spec.n_edges, spec.n_lg_edges, spec.n_graphs)
    return (batch_graphs(graphs, spec, torch.device("cpu")),
            jbatch(_jax_graphs(graphs), js))


def _ring_equal(got, ref):
    for f in ("lg_src", "lg_dst", "lg_mask"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(ref, f)), f)
    assert got.steps == ref.steps and got.n_shards == ref.n_shards
    assert got.offsets == ref.offsets and got.cols == ref.cols


@pytest.mark.parametrize("kind", ["cells", "supercell"])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_index_matches_jax(kind, n):
    """make_ring_index (quantum 128 and 8, and forced wider steps) and
    make_stacked_ring over two rows with a floor equal JAX's; each rank's
    steps are CSR-ready and hold every real L-edge once."""
    from alignn_tpu.parallel import gp_batch as jgp
    from alignn_tpu_torch.parallel import gp_batch as gp

    batch, jb = _batches(kind, dense=False)
    for quantum in (128, 8):
        ring = gp.make_ring_index(batch, n, quantum)
        _ring_equal(ring, jgp.make_ring_index(jb, n, quantum))
    wider = tuple(s + 8 * (k + 1) for k, s in enumerate(ring.steps))
    _ring_equal(gp.make_ring_index(batch, n, 8, steps=wider),
                jgp.make_ring_index(jb, n, 8, steps=wider))
    with pytest.raises(ValueError, match="forced steps"):
        gp.make_ring_index(batch, n, 8, steps=(1,) * n)

    import jax

    stacked = jax.tree_util.tree_map(lambda *x: np.stack(x), jb, jb)
    floor = tuple(256 for _ in range(n))
    _ring_equal(gp.make_stacked_ring([batch, batch], n, min_steps=floor),
                jgp.make_stacked_ring(stacked, n, min_steps=floor))

    e_loc = batch.src.shape[0] // n
    real = 0
    for c in range(n):
        steps = gp.ring_steps(ring, c, e_loc, "cpu")
        for k, st in enumerate(steps.steps):
            dst = st.dst.ids.numpy()
            assert np.all(np.diff(dst) >= 0) and dst.max() < e_loc
            assert st.src.numpy().max() < e_loc
        real += int(steps.mask.sum())
    assert real == int(batch.lg_mask.sum())


@pytest.mark.parametrize("kind", ["cells", "supercell"])
@pytest.mark.parametrize("n", [2, 4])
def test_halo_index_matches_jax(kind, n):
    """make_dense_gp_index (quantum 8 and 1, forced wider steps) and
    make_stacked_dense_index with a floor equal JAX's plans and remaps."""
    from alignn_tpu.parallel import dense_gp as jdg
    from alignn_tpu_torch.parallel import dense_gp as dg

    batch, jb = _batches(kind, dense=True)

    def same(got, ref):
        for h in ("node_halo", "edge_halo"):
            np.testing.assert_array_equal(
                getattr(got, h).send_idx,
                np.asarray(getattr(ref, h).send_idx), h)
            assert getattr(got, h).steps == getattr(ref, h).steps
            assert getattr(got, h).total == getattr(ref, h).total
        np.testing.assert_array_equal(got.src_halo,
                                      np.asarray(ref.src_halo))
        np.testing.assert_array_equal(got.rev_halo,
                                      np.asarray(ref.rev_halo))
        assert got.n_shards == ref.n_shards

    for quantum in (8, 1):
        idx = dg.make_dense_gp_index(batch, n, quantum)
        same(idx, jdg.make_dense_gp_index(jb, n, quantum))
    forced = tuple(tuple(s + 4 for s in h.steps)
                   for h in (idx.node_halo, idx.edge_halo))
    same(dg.make_dense_gp_index(batch, n, 1, force_steps=forced),
         jdg.make_dense_gp_index(jb, n, 1, force_steps=forced))

    import jax

    stacked = jax.tree_util.tree_map(lambda *x: np.stack(x), jb, jb)
    floor = (tuple(16 for _ in range(n - 1)), tuple(64 for _ in range(n - 1)))
    same(dg.make_stacked_dense_index([batch, batch], n, min_steps=floor),
         jdg.make_stacked_dense_index(stacked, n, min_steps=floor))
    with pytest.raises(ValueError, match="dense batch"):
        dg.make_dense_gp_index(_batches(kind, dense=False)[0], n)
