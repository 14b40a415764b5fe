"""Dense-neighbourhood batch layout: regular blocks instead of index lists.

Counterpart of ``alignn_tpu/graph/dense.py``.  Every node's in-edge list
is padded to a static degree ``D``, so that each dst aggregation is a
block reduction over D rows, and (with the reverse-edge involution
``rev`` of a symmetric edge set) the whole line-graph stage becomes
all-pairs algebra inside each block:

- edge row ``j*D + s`` is the s-th in-edge of node ``j``, so
  ``dst == row // D``;
- the L(g) edge (a, b) with ``dst[a] == src[b] == j`` is the local pair
  (a = j*D+s, b = rev[j*D+t]), kept at pair row ``j*D*D + t*D + s``; its
  cosine is ``r_s . r_t / (|r_s||r_t|)`` (ops/basis.py), its gate reads
  ``dst_gate[rev]`` (nn/layers.py).

A dense batch is a normal :class:`~alignn_tpu_torch.graph.batch.GraphBatch`
with ``dense_D > 0`` and ``rev`` set.  Only the g stage has an
:class:`~alignn_tpu_torch.graph.batch.Incidence` (the src-side gather and
its K2 transpose); the dense model reads no line-graph index arrays, so
``lg_index`` is None.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from alignn_tpu_torch.chem.features import attribute_lookup_table
from alignn_tpu_torch.graph.batch import (BucketSpec, GraphBatch, _incidence,
                                          _round_up, padded_labels)
from alignn_tpu_torch.graph.build import GraphData


def max_in_degree(graphs: Sequence[GraphData]) -> int:
    """Max per-node in-degree over the graphs."""
    out = 0
    for g in graphs:
        if g.num_edges:
            out = max(out, int(np.bincount(
                g.dst, minlength=g.num_nodes).max()))
    return out


def _dense_spec(n_pad: int, D: int, n_graphs: int) -> BucketSpec:
    return BucketSpec(n_nodes=n_pad, n_edges=n_pad * D,
                      n_lg_edges=n_pad * D * D, n_graphs=n_graphs,
                      dense_D=D)


def dense_spec_for_batch(graphs: Sequence[GraphData],
                         D: Optional[int] = None,
                         node_quantum: int = 128) -> BucketSpec:
    """Tight dense bucket for exactly this batch."""
    if D is None:
        D = max_in_degree(graphs)
    n_pad = _round_up(sum(g.num_nodes for g in graphs), node_quantum)
    return _dense_spec(n_pad, D, len(graphs) + 1)


def dense_spec_for_graphs(graphs: Sequence[GraphData], batch_size: int,
                          D: Optional[int] = None, node_quantum: int = 128,
                          slack: float = 1.0) -> BucketSpec:
    """One dense bucket for every batch of `batch_size` graphs: the
    largest graph's nodes x batch_size x slack, D the largest in-degree."""
    if D is None:
        D = max_in_degree(graphs)
    max_n = max(g.num_nodes for g in graphs)
    n_pad = _round_up(int(max_n * batch_size * slack), node_quantum)
    return _dense_spec(n_pad, D, batch_size + 1)


def dense_spec_from_counts(node_counts, indeg_counts, batch_size: int,
                           node_quantum: int = 128,
                           slack: float = 1.0) -> BucketSpec:
    """:func:`dense_spec_for_graphs` from per-graph node counts and
    in-degrees (a dataset's metadata), without the graphs."""
    D = int(np.max(indeg_counts))
    max_n = int(np.max(node_counts))
    n_pad = _round_up(int(max_n * batch_size * slack), node_quantum)
    return _dense_spec(n_pad, D, batch_size + 1)


def dense_spec_with_slack(g: GraphData, bucket_slack: float = 1.3,
                          degree_headroom: int = 2,
                          node_quantum: int = 128) -> BucketSpec:
    """Reusable dense bucket for one evolving structure: node slack and
    degree headroom let the next MD or relaxation steps reuse it."""
    D = max_in_degree([g]) + degree_headroom
    n_pad = _round_up(int(g.num_nodes * bucket_slack) + 1, node_quantum)
    return _dense_spec(n_pad, D, 2)


class AsymmetricEdgesError(ValueError):
    """A graph lacks the (i->j, image) / (j->i, -image) reverse involution
    that the dense layout needs; callers use the sparse layout for it."""


def dense_batch_graphs(graphs: List[GraphData], spec: BucketSpec,
                       device: torch.device, atom_features: str = "cgcnn",
                       dtype: torch.dtype = torch.float32,
                       target_width: int = 1, atomwise_width: int = 0,
                       additional_width: int = 0,
                       extra_width: int = 0) -> GraphBatch:
    """Concatenate + pad graphs into a dense-neighbourhood GraphBatch, with
    their training targets (:func:`padded_labels`).

    Layout contract (the dense paths of nn/layers.py and nn/models.py
    rely on it):
      - node rows are assigned in order per graph; rows past the real
        total are padding (mask 0, graph slot -> trash graph G-1, zero
        features);
      - edge row ``j*D + s``: the s-th real in-edge of node j (in the
        graph's dst-sorted order) for s below its in-degree, else a trash
        slot (mask 0, src -> 0, r -> (1, 0, 0));
      - ``dst[row] = row // D`` for every row: masks, not routing,
        isolate the trash slots;
      - ``rev`` pairs each real edge with its reverse row (trash slots
        map to themselves);
      - pair row ``j*D^2 + t*D + s`` is the L-edge (a = j*D+s,
        b = rev[j*D+t]), recorded in ``lg_src``/``lg_dst``, with
        ``lg_mask = edge_mask[a] * edge_mask[j*D+t]``.
    """
    D = spec.dense_D
    if D <= 0:
        raise ValueError("spec.dense_D must be > 0 for dense batching")
    n_pad, g_pad = spec.n_nodes, spec.n_graphs
    e_pad = n_pad * D
    if spec.n_edges != e_pad or spec.n_lg_edges != e_pad * D:
        raise ValueError("inconsistent dense spec: n_edges/n_lg_edges "
                         "must equal n_nodes*D / n_nodes*D^2")
    n_tot = sum(g.num_nodes for g in graphs)
    if n_tot > n_pad or len(graphs) >= g_pad:
        raise ValueError(
            f"batch ({n_tot}n/{len(graphs)}g) overflows dense bucket "
            f"({n_pad}/{g_pad})")
    feat_table = attribute_lookup_table(atom_features)

    z = np.zeros(n_pad, dtype=np.int64)
    feats = np.zeros((n_pad, feat_table.shape[1]))
    frac = np.zeros((n_pad, 3))
    node_graph = np.full(n_pad, g_pad - 1, dtype=np.int64)
    node_mask = np.zeros(n_pad)
    src = np.zeros(e_pad, dtype=np.int64)            # trash slots -> node 0
    dst = np.arange(e_pad, dtype=np.int64) // D
    r = np.zeros((e_pad, 3))
    r[:, 0] = 1.0                                    # pad displacement
    images = np.zeros((e_pad, 3))
    edge_graph = np.full(e_pad, g_pad - 1, dtype=np.int64)
    edge_mask = np.zeros(e_pad)
    rev = np.arange(e_pad, dtype=np.int64)           # trash slots -> self
    lattice = np.tile(np.eye(3), (g_pad, 1, 1))
    volume = np.ones(g_pad)
    n_nodes = np.zeros(g_pad)
    graph_mask = np.zeros(g_pad)

    n_off = 0
    for gi, g in enumerate(graphs):
        nn, ne = g.num_nodes, g.num_edges
        ns = slice(n_off, n_off + nn)
        z[ns] = g.z
        feats[ns] = feat_table[g.z]
        frac[ns] = g.frac_coords
        node_graph[ns] = gi
        node_mask[ns] = 1.0
        if ne:
            d = g.dst.astype(np.int64)
            if np.any(np.diff(d) < 0):
                raise ValueError("dense layout requires dst-sorted edges "
                                 "(graph/build.py invariant)")
            deg = np.bincount(d, minlength=nn)
            if int(deg.max()) > D:
                raise ValueError(
                    f"graph in-degree {int(deg.max())} exceeds dense_D={D}")
            # slot within the block: position past the first edge of this
            # dst (keeps the build's edge order)
            slot = np.arange(ne, dtype=np.int64) - np.searchsorted(d, d)
            rows = (n_off + d) * D + slot
            src[rows] = g.src + n_off
            r[rows] = g.r
            images[rows] = g.images
            edge_graph[rows] = gi
            edge_mask[rows] = 1.0
            # reverse-edge involution: (src, dst, image) meets
            # (dst, src, -image) under two sorts of the same order
            s64 = g.src.astype(np.int64)
            img = np.round(g.images).astype(np.int64)
            o1 = np.lexsort((img[:, 2], img[:, 1], img[:, 0], d, s64))
            o2 = np.lexsort((-img[:, 2], -img[:, 1], -img[:, 0], s64, d))
            if not (np.array_equal(s64[o1], d[o2])
                    and np.array_equal(d[o1], s64[o2])
                    and np.array_equal(img[o1], -img[o2])):
                raise AsymmetricEdgesError(
                    "dense layout requires a symmetric edge set "
                    "(every (i->j, image) must have (j->i, -image))")
            rev_g = np.empty(ne, dtype=np.int64)
            rev_g[o1] = o2
            rev[rows] = rows[rev_g]
        lattice[gi] = g.lattice
        volume[gi] = g.volume
        n_nodes[gi] = nn
        graph_mask[gi] = 1.0
        n_off += nn

    # implicit local-pair line graph: row j*D^2 + t*D + s <-> L-edge
    # (a = j*D+s, b = rev[j*D+t])
    lg_src = (np.repeat(dst * D, D)
              + np.tile(np.arange(D, dtype=np.int64), e_pad))
    lg_dst = np.repeat(rev, D)
    lg_mask = edge_mask[lg_src] * np.repeat(edge_mask, D)

    def f(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(
            device=device, dtype=dtype)

    def i(a):
        return torch.as_tensor(a).to(device)

    # Unlike the JAX builder, no argsort of lg_src is built: the dense
    # model reads no line-graph index arrays, and sorting N*D^2 pair rows
    # on the host would cost time for nothing.
    return GraphBatch(
        z=i(z), atom_features=f(feats), frac_coords=f(frac),
        node_graph=i(node_graph), node_mask=f(node_mask),
        src=i(src), dst=i(dst), r=f(r), images=f(images),
        edge_graph=i(edge_graph), edge_mask=f(edge_mask),
        lg_src=i(lg_src), lg_dst=i(lg_dst), lg_mask=f(lg_mask),
        lattice=f(lattice), volume=f(volume), n_nodes=f(n_nodes),
        graph_mask=f(graph_mask),
        **{k: f(v) for k, v in padded_labels(
            graphs, n_pad, g_pad, target_width, atomwise_width,
            additional_width, extra_width).items()},
        g_index=_incidence(src, None, n_pad, n_pad, device),
        lg_index=None, dense_D=D, rev=i(rev))
