"""alignn_tpu_torch's legacy adjacency-matrix ``Graph`` against
alignn_tpu's: ``from_atoms`` (adjacency, node features, the nearest
``max_neighbors`` edges per source and their weights) on rattled rocksalt
cells and a silicon cell, at two cutoffs, the dict round trip, equality,
and the networkx export where networkx is installed."""

import numpy as np
import pytest
from torch_port_threads import _two_threads  # noqa: E402,F401


def _structures():
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.graph.build import rocksalt_cells

    cells = [atoms for atoms, _t, _f in rocksalt_cells(2, seed=8,
                                                        rattle=0.03)]
    si = Atoms(lattice_mat=np.eye(3) * 5.43,
               frac_coords=np.array([[0, 0, 0], [0.25, 0.25, 0.25],
                                     [0.5, 0.5, 0], [0.75, 0.75, 0.25],
                                     [0.5, 0, 0.5], [0.75, 0.25, 0.75],
                                     [0, 0.5, 0.5], [0.25, 0.75, 0.75]]),
               elements=["Si"] * 8)
    return cells + [si]


@pytest.mark.parametrize("cutoff,max_neighbors", [(8.0, 12), (4.0, 4)])
def test_graph_from_atoms_matches_jax(cutoff, max_neighbors):
    from alignn_tpu.chem.atoms import Atoms as JAtoms
    from alignn_tpu.graph.legacy import Graph as JGraph
    from alignn_tpu_torch.graph.legacy import Graph

    for atoms in _structures():
        got = Graph.from_atoms(atoms, cutoff=cutoff,
                               max_neighbors=max_neighbors)
        ref = JGraph.from_atoms(JAtoms.from_dict(atoms.to_dict()),
                                cutoff=cutoff, max_neighbors=max_neighbors)
        d, r = got.to_dict(), ref.to_dict()
        assert d["nodes"] == r["nodes"] and d["edges"] == r["edges"]
        np.testing.assert_allclose(d["node_attributes"],
                                   r["node_attributes"], rtol=0, atol=0)
        np.testing.assert_allclose(d["edge_attributes"],
                                   r["edge_attributes"], rtol=1e-12)
        np.testing.assert_allclose(d["adjacency"], r["adjacency"],
                                   rtol=1e-12)
        assert got.num_nodes == ref.num_nodes
        assert got.num_edges == ref.num_edges > 0


def test_graph_dict_round_trip_and_networkx():
    from alignn_tpu_torch.graph.legacy import Graph

    g = Graph.from_atoms(_structures()[0], cutoff=6.0)
    back = Graph.from_dict(g.to_dict())
    assert back == g and back.to_dict() == g.to_dict()
    assert (Graph() == 3) is False
    nx = pytest.importorskip("networkx")
    h = g.to_networkx()
    assert isinstance(h, nx.DiGraph)
    assert h.number_of_nodes() == g.num_nodes
    assert h.number_of_edges() == g.num_edges
    a, b = g.edges[0]
    assert h[a][b]["weight"] == g.edge_attributes[0]
