"""The legacy adjacency-matrix Graph class (counterpart of
``alignn_tpu/graph/legacy.py``).

The reference's non-DGL ``Graph`` helpers: an adjacency matrix built from
a structure, element features, a networkx export and a dict round trip.
Kept for API compatibility; the training path uses the flat index arrays
of :mod:`alignn_tpu_torch.graph.build`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from alignn_tpu_torch.chem.atoms import Atoms
from alignn_tpu_torch.chem.features import attribute_lookup_table


class Graph:
    """Adjacency-matrix graph representation of a structure."""

    def __init__(self, nodes=None, node_attributes=None,
                 edges=None, edge_attributes=None,
                 adjacency: Optional[np.ndarray] = None):
        self.nodes = [] if nodes is None else list(nodes)
        self.node_attributes = ([] if node_attributes is None
                                else list(node_attributes))
        self.edges = [] if edges is None else list(edges)
        self.edge_attributes = ([] if edge_attributes is None
                                else list(edge_attributes))
        self.adjacency = adjacency

    @classmethod
    def from_atoms(cls, atoms: Atoms, cutoff: float = 8.0,
                   atom_features: str = "cgcnn",
                   max_neighbors: int = 12) -> "Graph":
        """Graph with distance-weighted adjacency + element features.

        Reference `Graph.atom_graph` family (graphs.py:438-592 legacy
        branch): nodes = atoms, adjacency[i, j] = min periodic distance
        within cutoff (0 beyond), node attributes from the element
        feature table.
        """
        from alignn_tpu_torch.graph.build import _tiled_pairs

        n = atoms.num_atoms
        u, v, _imgs, _disp, dist = _tiled_pairs(atoms, cutoff)
        adj = np.zeros((n, n))
        for a, b, d in zip(u, v, dist):
            if adj[a, b] == 0 or d < adj[a, b]:
                adj[a, b] = d
        table = attribute_lookup_table(atom_features)
        feats = table[atoms.atomic_numbers]
        # ONE edge per (i, j) at the min periodic distance, consistent
        # with the adjacency matrix (per-image duplicates left
        # to_networkx weights at an arbitrary image's distance), capped
        # at the max_neighbors nearest per source like the reference
        edges, weights = [], []
        for a in range(n):
            nb = [(adj[a, b], b) for b in range(n) if adj[a, b] > 0]
            nb.sort()
            for d, b in nb[:max_neighbors]:
                edges.append((int(a), int(b)))
                weights.append(float(d))
        return cls(nodes=list(range(n)), node_attributes=feats.tolist(),
                   edges=edges, edge_attributes=weights,
                   adjacency=adj)

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    @property
    def num_edges(self) -> int:
        return len(self.edges)

    def to_networkx(self):
        """networkx export (reference graphs.py:766-775)."""
        import networkx as nx

        g = nx.DiGraph()
        g.add_nodes_from(self.nodes)
        for (a, b), w in zip(self.edges, self.edge_attributes):
            g.add_edge(a, b, weight=w)
        return g

    def to_dict(self) -> dict:
        return {
            "nodes": self.nodes,
            "node_attributes": self.node_attributes,
            "edges": self.edges,
            "edge_attributes": self.edge_attributes,
            "adjacency": (None if self.adjacency is None
                          else np.asarray(self.adjacency).tolist()),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Graph":
        adj = d.get("adjacency")
        return cls(nodes=d.get("nodes"),
                   node_attributes=d.get("node_attributes"),
                   edges=[tuple(e) for e in d.get("edges", [])],
                   edge_attributes=d.get("edge_attributes"),
                   adjacency=None if adj is None else np.asarray(adj))

    def __eq__(self, other) -> bool:
        if not isinstance(other, Graph):
            return NotImplemented
        return self.to_dict() == other.to_dict()
