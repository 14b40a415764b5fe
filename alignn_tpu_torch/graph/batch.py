"""Padded batch of crystal graphs, as tensors on one device.

Counterpart of ``alignn_tpu/graph/batch.py``.  The batch is assembled in
numpy with the same padding rules and moved to the device once:

- every axis keeps at least one trailing trash slot: padded edges point
  src/dst at the trash node N-1, padded nodes belong to graph slot G-1,
  padded L-edges point at the trash edge E-1, so garbage only flows into
  masked slots;
- padded bond vectors are r = (1, 0, 0), so no norm is zero and no NaN
  enters autograd.

Because dst and lg_dst are ascending (trash slots last), each message
passing stage is a set of contiguous segments.  Their CSR pointers, and
those of the argsorted src / lg_src, are built once here
(:class:`~alignn_tpu_torch.ops.eggc.Segments`) and read by every layer.
So are the static gather windows (``win_*``, :mod:`alignn_tpu_torch.ops.
gather`), measured on the numpy index arrays when ``gather_windows`` is
set; the Calculator batches without them, as in JAX.  The
dense-neighbourhood layout fills the same :class:`GraphBatch`
(:mod:`alignn_tpu_torch.graph.dense`) and leaves the windows at 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from alignn_tpu_torch.chem.features import attribute_lookup_table
from alignn_tpu_torch.graph.build import GraphData
from alignn_tpu_torch.ops.eggc import Segments
from alignn_tpu_torch.ops.gather import window_for


@dataclass(frozen=True)
class Incidence:
    """Index arrays of one message-passing stage (g or its line graph).

    A dense batch leaves ``dst`` out: its dst side is the block owner.
    """

    src: torch.Tensor           # [E] int64
    src_perm: torch.Tensor      # [E] int64, stable argsort(src)
    src_perm_inv: torch.Tensor  # [E] int64
    src_sorted: Segments        # segments of src[src_perm]
    dst: Optional[Segments] = None  # segments of the ascending dst


@dataclass
class GraphBatch:
    """A padded batch of crystal graphs + line graphs."""

    # nodes [N]
    z: torch.Tensor              # int64 atomic numbers (0 = pad)
    atom_features: torch.Tensor  # [N, F]
    frac_coords: torch.Tensor    # [N, 3]
    node_graph: torch.Tensor     # [N] int64 graph slot (pad -> G-1)
    node_mask: torch.Tensor      # [N] {0,1}
    # edges [E]
    src: torch.Tensor            # [E] int64 (pad -> N-1)
    dst: torch.Tensor            # [E] int64, ascending (pad -> N-1)
    r: torch.Tensor              # [E, 3] displacement src -> dst
    images: torch.Tensor         # [E, 3]
    edge_graph: torch.Tensor     # [E] int64 (pad -> G-1)
    edge_mask: torch.Tensor      # [E]
    # line-graph edges [L]
    lg_src: torch.Tensor         # [L] int64 edge ids (pad -> E-1)
    lg_dst: torch.Tensor         # [L] int64, ascending (pad -> E-1)
    lg_mask: torch.Tensor        # [L]
    # graphs [G]
    lattice: torch.Tensor        # [G, 3, 3]
    volume: torch.Tensor         # [G]
    n_nodes: torch.Tensor        # [G] real atom counts
    graph_mask: torch.Tensor     # [G]
    # training targets, zero where a graph has no label
    target: torch.Tensor         # [G, T]
    forces: torch.Tensor         # [N, 3]
    stress: torch.Tensor         # [G, 3, 3]
    atomwise_target: torch.Tensor  # [N, A]
    additional: torch.Tensor     # [G, Fadd]
    extra_features: torch.Tensor  # [G, Fx] model inputs (Fx may be 0)
    # message-passing stages: g (atoms <- bonds), L(g) (bonds <- angles);
    # a dense batch has no lg_index (its L-stage is local pairs)
    g_index: Incidence
    lg_index: Optional[Incidence]
    # dense layout (graph/dense.py): in-degree block D (0 = sparse) and
    # the reverse-edge involution [E] int64
    dense_D: int = 0
    rev: Optional[torch.Tensor] = None
    # static gather windows (ops/gather.py): the max per-supertile span of
    # real indices, 256-quantised; 0 = plain gather.  The model reads them
    # only with ALIGNN_TPU_ENABLE_WGATHER set.
    win_src: int = 0
    win_dst: int = 0
    win_src_sorted: int = 0
    win_lg_src: int = 0
    win_lg_dst: int = 0
    win_lg_src_sorted: int = 0


WIN_FIELDS = ("win_src", "win_dst", "win_src_sorted", "win_lg_src",
              "win_lg_dst", "win_lg_src_sorted")


@dataclass(frozen=True)
class BucketSpec:
    """Static pad sizes (nodes, edges, lg-edges, graphs) for a batch;
    ``dense_D > 0`` marks a dense-neighbourhood bucket."""

    n_nodes: int
    n_edges: int
    n_lg_edges: int
    n_graphs: int
    dense_D: int = 0

    @staticmethod
    def for_graphs(graphs: Sequence[GraphData], batch_size: int,
                   node_quantum: int = 128, edge_quantum: int = 128,
                   lg_quantum: int = 512, slack: float = 1.0) -> "BucketSpec":
        """One bucket for every batch of `batch_size` graphs: the largest
        graph's counts x batch_size x slack, rounded up to the quanta,
        plus the trash slots."""
        max_n = max(g.num_nodes for g in graphs)
        max_e = max(g.num_edges for g in graphs)
        max_l = max(g.num_lg_edges for g in graphs)
        return BucketSpec(
            n_nodes=_round_up(int(max_n * batch_size * slack) + 1,
                              node_quantum),
            n_edges=_round_up(int(max_e * batch_size * slack) + 1,
                              edge_quantum),
            n_lg_edges=_round_up(int(max_l * batch_size * slack) + 1,
                                 lg_quantum),
            n_graphs=batch_size + 1,
        )

    @staticmethod
    def tight_for_batch(graphs: Sequence[GraphData], node_quantum: int = 128,
                        edge_quantum: int = 128,
                        lg_quantum: int = 512) -> "BucketSpec":
        """Bucket sized for exactly this batch."""
        return BucketSpec(
            n_nodes=_round_up(sum(g.num_nodes for g in graphs) + 1,
                              node_quantum),
            n_edges=_round_up(sum(g.num_edges for g in graphs) + 1,
                              edge_quantum),
            n_lg_edges=_round_up(sum(g.num_lg_edges for g in graphs) + 1,
                                 lg_quantum),
            n_graphs=len(graphs) + 1,
        )


def _round_up(x: int, quantum: int) -> int:
    return ((x + quantum - 1) // quantum) * quantum


def _incidence(src: np.ndarray, dst: Optional[np.ndarray], num_dst: int,
               num_src: int, device: torch.device,
               perm: Optional[np.ndarray] = None) -> Incidence:
    """The stage's index tensors; `dst` None leaves its segments out.
    `perm`, the stable argsort of `src`, is computed when not given."""
    if dst is not None and np.any(np.diff(dst) < 0):
        raise ValueError("dst must be ascending: the segment kernels "
                         "reduce contiguous row ranges")
    if perm is None:
        perm = np.argsort(src, kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])

    def t(a):
        return torch.as_tensor(a.astype(np.int64)).to(device)

    src_t = t(src)
    perm_t = t(perm)
    return Incidence(
        src=src_t, src_perm=perm_t, src_perm_inv=t(inv),
        src_sorted=Segments.from_sorted(src_t[perm_t], num_src),
        dst=None if dst is None else Segments.from_sorted(t(dst), num_dst))


def padded_labels(graphs: Sequence[GraphData], n_pad: int, g_pad: int,
                  target_width: int = 1, atomwise_width: int = 0,
                  additional_width: int = 0, extra_width: int = 0
                  ) -> Dict[str, np.ndarray]:
    """The training targets and the per-structure extra features of
    graphs whose nodes take consecutive rows from 0, padded with zeros,
    under the width rules of the JAX batch functions: a label width below
    1 still gives one column; a graph target of another width raises; a
    graph's extra features are cut to `extra_width` (0 columns without
    them)."""
    target = np.zeros((g_pad, max(target_width, 1)))
    forces = np.zeros((n_pad, 3))
    stress = np.zeros((g_pad, 3, 3))
    atomwise = np.zeros((n_pad, max(atomwise_width, 1)))
    additional = np.zeros((g_pad, max(additional_width, 1)))
    extra = np.zeros((g_pad, extra_width))
    n_off = 0
    for gi, g in enumerate(graphs):
        nn = g.num_nodes
        ns = slice(n_off, n_off + nn)
        if g.target is not None:
            tg = np.asarray(g.target, dtype=np.float64).reshape(-1)
            if tg.shape[0] != target.shape[1]:
                # numpy would broadcast a scalar across a wider row or cut
                # a wider target: both corrupt the labels
                raise ValueError(
                    f"graph target width {tg.shape[0]} != batch "
                    f"target_width {target.shape[1]} (set target_width/"
                    f"model.output_features to the dataset's width)")
            target[gi] = tg
        if g.forces is not None:
            forces[ns] = g.forces
        if g.stress is not None:
            stress[gi] = g.stress
        if g.atomwise_target is not None:
            atomwise[ns] = np.asarray(g.atomwise_target).reshape(nn, -1)
        if g.additional is not None:
            additional[gi] = np.asarray(g.additional).reshape(-1)[
                : additional.shape[1]]
        if g.extra_features is not None:
            extra[gi] = np.asarray(g.extra_features).reshape(-1)[
                : extra_width]
        n_off += nn
    return {"target": target, "forces": forces, "stress": stress,
            "atomwise_target": atomwise, "additional": additional,
            "extra_features": extra}


def _windows(src, dst, lg_src, lg_dst, perm, lg_perm, n_pad: int) -> dict:
    """The six ``win_*`` windows of a padded batch's index arrays (the
    trash node and edge are the last of their bucket's rows)."""
    n_trash, e_trash = n_pad - 1, len(src) - 1
    return dict(
        win_src=window_for(src, n_trash), win_dst=window_for(dst, n_trash),
        win_src_sorted=window_for(src[perm], n_trash),
        win_lg_src=window_for(lg_src, e_trash),
        win_lg_dst=window_for(lg_dst, e_trash),
        win_lg_src_sorted=window_for(lg_src[lg_perm], e_trash))


def batch_windows(graphs: Sequence[GraphData], spec: BucketSpec) -> dict:
    """The ``win_*`` windows :func:`batch_graphs` would measure on these
    graphs in this bucket, from their index arrays alone (no features,
    labels or device copies): what a data-parallel rank needs of the
    other ranks' shards to floor its windows over the whole step."""
    n_pad, e_pad, l_pad = spec.n_nodes, spec.n_edges, spec.n_lg_edges
    src = np.full(e_pad, n_pad - 1, dtype=np.int64)
    dst = np.full(e_pad, n_pad - 1, dtype=np.int64)
    lg_src = np.full(l_pad, e_pad - 1, dtype=np.int64)
    lg_dst = np.full(l_pad, e_pad - 1, dtype=np.int64)
    n_off = e_off = l_off = 0
    for g in graphs:
        src[e_off:e_off + g.num_edges] = g.src + n_off
        dst[e_off:e_off + g.num_edges] = g.dst + n_off
        if g.num_lg_edges:
            lg_src[l_off:l_off + g.num_lg_edges] = g.lg_src + e_off
            lg_dst[l_off:l_off + g.num_lg_edges] = g.lg_dst + e_off
        n_off += g.num_nodes
        e_off += g.num_edges
        l_off += g.num_lg_edges
    return _windows(src, dst, lg_src, lg_dst,
                    np.argsort(src, kind="stable"),
                    np.argsort(lg_src, kind="stable"), n_pad)


def batch_graphs(graphs: List[GraphData], spec: BucketSpec,
                 device: torch.device, atom_features: str = "cgcnn",
                 dtype: torch.dtype = torch.float32, target_width: int = 1,
                 atomwise_width: int = 0, additional_width: int = 0,
                 gather_windows: bool = True,
                 extra_width: int = 0) -> GraphBatch:
    """Concatenate + pad graphs into one :class:`GraphBatch` on `device`,
    with their training targets (:func:`padded_labels`).

    `gather_windows` measures the six static ``win_*`` windows on the
    index arrays (False leaves them 0): geometry-evolving single-graph
    callers such as the Calculator skip it, as in JAX."""
    n_pad, e_pad = spec.n_nodes, spec.n_edges
    l_pad, g_pad = spec.n_lg_edges, spec.n_graphs
    n_tot = sum(g.num_nodes for g in graphs)
    e_tot = sum(g.num_edges for g in graphs)
    l_tot = sum(g.num_lg_edges for g in graphs)
    if n_tot >= n_pad or e_tot >= e_pad or l_tot >= l_pad or \
            len(graphs) >= g_pad:
        raise ValueError(
            f"batch ({n_tot}n/{e_tot}e/{l_tot}l/{len(graphs)}g) overflows "
            f"bucket ({n_pad}/{e_pad}/{l_pad}/{g_pad})")
    feat_table = attribute_lookup_table(atom_features)

    z = np.zeros(n_pad, dtype=np.int64)
    frac = np.zeros((n_pad, 3))
    node_graph = np.full(n_pad, g_pad - 1, dtype=np.int64)
    node_mask = np.zeros(n_pad)
    src = np.full(e_pad, n_pad - 1, dtype=np.int64)
    dst = np.full(e_pad, n_pad - 1, dtype=np.int64)
    r = np.zeros((e_pad, 3))
    r[:, 0] = 1.0  # pad displacement: unit x, nonzero norm
    images = np.zeros((e_pad, 3))
    edge_graph = np.full(e_pad, g_pad - 1, dtype=np.int64)
    edge_mask = np.zeros(e_pad)
    lg_src = np.full(l_pad, e_pad - 1, dtype=np.int64)
    lg_dst = np.full(l_pad, e_pad - 1, dtype=np.int64)
    lg_mask = np.zeros(l_pad)
    lattice = np.tile(np.eye(3), (g_pad, 1, 1))
    volume = np.ones(g_pad)
    n_nodes = np.zeros(g_pad)
    graph_mask = np.zeros(g_pad)

    n_off = e_off = l_off = 0
    for gi, g in enumerate(graphs):
        ns = slice(n_off, n_off + g.num_nodes)
        es = slice(e_off, e_off + g.num_edges)
        ls = slice(l_off, l_off + g.num_lg_edges)
        z[ns] = g.z
        frac[ns] = g.frac_coords
        node_graph[ns] = gi
        node_mask[ns] = 1.0
        src[es] = g.src + n_off
        dst[es] = g.dst + n_off
        r[es] = g.r
        images[es] = g.images
        edge_graph[es] = gi
        edge_mask[es] = 1.0
        if g.num_lg_edges:
            lg_src[ls] = g.lg_src + e_off
            lg_dst[ls] = g.lg_dst + e_off
            lg_mask[ls] = 1.0
        lattice[gi] = g.lattice
        volume[gi] = g.volume
        n_nodes[gi] = g.num_nodes
        graph_mask[gi] = 1.0
        n_off += g.num_nodes
        e_off += g.num_edges
        l_off += g.num_lg_edges

    def f(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(
            device=device, dtype=dtype)

    def i(a):
        return torch.as_tensor(a).to(device)

    perm = np.argsort(src, kind="stable")
    lg_perm = np.argsort(lg_src, kind="stable")
    windows = _windows(src, dst, lg_src, lg_dst, perm, lg_perm, n_pad) \
        if gather_windows else {}
    return GraphBatch(
        z=i(z), atom_features=f(feat_table[z]), frac_coords=f(frac),
        node_graph=i(node_graph), node_mask=f(node_mask),
        src=i(src), dst=i(dst), r=f(r), images=f(images),
        edge_graph=i(edge_graph), edge_mask=f(edge_mask),
        lg_src=i(lg_src), lg_dst=i(lg_dst), lg_mask=f(lg_mask),
        lattice=f(lattice), volume=f(volume), n_nodes=f(n_nodes),
        graph_mask=f(graph_mask),
        **{k: f(v) for k, v in padded_labels(
            graphs, n_pad, g_pad, target_width, atomwise_width,
            additional_width, extra_width).items()},
        g_index=_incidence(src, dst, n_pad, n_pad, device, perm),
        lg_index=_incidence(lg_src, lg_dst, e_pad, e_pad, device, lg_perm),
        **windows,
    )
