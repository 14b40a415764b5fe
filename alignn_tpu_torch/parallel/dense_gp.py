"""Graph parallelism of the dense-neighbourhood layout (counterpart of
``alignn_tpu/parallel/dense_gp.py``).

The dense layout is node-aligned: node j owns edge rows ``j*D..(j+1)*D``
and pair rows ``j*D^2..(j+1)*D^2``.  Sharding the nodes in contiguous
blocks over the ranks of a "graph" axis therefore shards every node, edge
and pair tensor contiguously, and the model has exactly two remote
accesses, both "rows owned by the rank of src": the node stage's source
gather ``cat[src]`` and the ``rev`` rides of the L-stage and of the force
assembly.  Each rank exchanges only the rows the others reference, a
halo: the host plans, for each ring distance, which local rows each rank
sends (:func:`make_dense_gp_index`); on the device the exchange is one
compact gather and one shift a populated distance
(:func:`halo_exchange`), and every consumer gather becomes a local gather
into the [local + halo] table.  The hops are independent, so neither
direction chains.

The aggregations stay the kernels of the one-device dense model: the node
stage's K3 (:class:`DenseGPNodeStage`), the L-stage's K4, whose backward
in a train step is K5a and, under the force loss, K5b
(:class:`DenseGPPairStage`).  The halo index is numpy, equal to JAX's;
:func:`dense_index_row` gives one rank its row as tensors.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from alignn_tpu_torch.graph.batch import GraphBatch
from alignn_tpu_torch.nn.layers import EdgeGatedGraphConv
from alignn_tpu_torch.nn.models import (EV_A3_TO_GPA, ALIGNNAtomWise,
                                        atomwise_heads)
from alignn_tpu_torch.ops.basis import (bond_cosines_dense,
                                        cutoff_function_based_edges)
from alignn_tpu_torch.ops.dense import (dense_gated_aggregate,
                                        dense_pair_aggregate, fold_mask)
from alignn_tpu_torch.ops.fp8 import fp8_ltables_enabled, fp8_round_trip
from alignn_tpu_torch.ops.segment import segment_sum
from alignn_tpu_torch.parallel.gp_batch import host
from alignn_tpu_torch.parallel.gp_model import share_parameters
from alignn_tpu_torch.parallel.mesh import (Axis, Mesh, all_gather,
                                            all_reduce_sum,
                                            collective_exchange,
                                            ordered_collectives, ring_shift)

GRAPH_AXIS = "graph"

# the row spaces that shard (node-aligned, contiguous); graph-level
# fields stay whole
NODE_FIELDS = ("z", "atom_features", "frac_coords", "node_graph",
               "node_mask", "forces", "atomwise_target")
EDGE_FIELDS = ("src", "dst", "r", "images", "edge_graph", "edge_mask",
               "rev")
LG_FIELDS = ("lg_src", "lg_dst", "lg_mask")


def _round_up(x: int, q: int) -> int:
    return ((x + q - 1) // q) * q


@dataclass
class HaloIndex:
    """One halo plan over a row space sharded in Dc blocks.

    ``send_idx[c]`` holds, grouped by ring distance k = 1..Dc-1 in columns
    ``[send_off[k-1], send_off[k])``, the local row ids rank c sends to
    rank (c - k) mod Dc: the rows that rank requests, sorted and unique,
    so the receiver's remap (built on the host in the same order) lines up
    without a second exchange.  ``steps`` are the per-distance widths (the
    max over ranks, quantum-padded; 0 = no traffic at that distance)."""

    send_idx: np.ndarray   # [Dc, sum(steps)] int32 local row ids
    steps: tuple = ()

    @property
    def total(self) -> int:
        return int(sum(self.steps))


@dataclass
class DenseGPIndex:
    """Halo plans and consumer remaps of a dense batch on Dc ranks.

    ``src_halo[c]`` maps each local edge row's source node into the
    [N_loc + node halo] table, ``rev_halo[c]`` each local edge row's
    reverse edge into the [E_loc + edge halo] table.  Masked consumer rows
    map to local row 0; the masks that isolate them on one device discard
    their values."""

    node_halo: HaloIndex
    edge_halo: HaloIndex
    src_halo: np.ndarray   # [Dc, E_loc] int32
    rev_halo: np.ndarray   # [Dc, E_loc] int32
    n_shards: int = 1


def _build_halo(targets: np.ndarray, consumer_mask: np.ndarray,
                rows_per_shard: int, n_shards: int,
                quantum: int) -> tuple:
    """(HaloIndex, remap[Dc, C_loc]) of one consumer -> target pattern.

    ``targets``: the global target row of each consumer row (flat, all
    ranks); the consumers shard contiguously like everything else."""
    d, r = n_shards, rows_per_shard
    c_tot = targets.shape[0]
    c_loc = c_tot // d
    t = targets.astype(np.int64).reshape(d, c_loc)
    live = consumer_mask.reshape(d, c_loc) > 0.5
    owner = t // r
    chip = np.arange(d, dtype=np.int64)[:, None]
    dist = (owner - chip) % d

    need = [[np.unique(t[c][(dist[c] == k) & live[c]])
             for k in range(d)] for c in range(d)]
    steps = []
    for k in range(1, d):
        m = max(len(need[c][k]) for c in range(d))
        steps.append(_round_up(m, quantum) if m else 0)
    steps = tuple(steps)

    send_idx = np.zeros((d, sum(steps)), dtype=np.int32)
    off = 0
    for k in range(1, d):
        if steps[k - 1] == 0:
            continue
        for o in range(d):
            req = need[(o - k) % d][k]
            send_idx[o, off:off + len(req)] = (req % r).astype(np.int32)
        off += steps[k - 1]

    remap = np.zeros((d, c_loc), dtype=np.int32)
    for c in range(d):
        rm = np.zeros(c_loc, dtype=np.int64)
        local = dist[c] == 0
        rm[local] = t[c][local] % r
        halo_off = r
        for k in range(1, d):
            if steps[k - 1] == 0:
                continue
            sel = (dist[c] == k) & live[c]
            if sel.any():
                pos = np.searchsorted(need[c][k], t[c][sel])
                rm[sel] = halo_off + pos
            halo_off += steps[k - 1]
        rm[~live[c]] = 0
        remap[c] = rm.astype(np.int32)
    return HaloIndex(send_idx=send_idx, steps=steps), remap


def make_dense_gp_index(batch, n_shards: int, quantum: int = 8,
                        force_steps: Optional[tuple] = None
                        ) -> DenseGPIndex:
    """The host's halo plan of a dense batch on `n_shards` ranks.
    `force_steps` = (node_steps, edge_steps) pins the widths (a monotone
    floor across batches, as for the ring)."""
    if not batch.dense_D:
        raise ValueError("make_dense_gp_index requires a dense batch "
                         "(graph/dense.dense_batch_graphs)")
    n = int(host(batch.z).shape[0])
    e = int(host(batch.src).shape[0])
    if n % n_shards or e % n_shards:
        raise ValueError(f"node ({n}) / edge ({e}) pads must divide "
                         f"the mesh size {n_shards}")
    em = host(batch.edge_mask)
    node_halo, src_halo = _build_halo(
        host(batch.src), em, n // n_shards, n_shards, quantum)
    edge_halo, rev_halo = _build_halo(
        host(batch.rev), em, e // n_shards, n_shards, quantum)
    if force_steps is not None:
        node_halo, src_halo = _repack_forced(
            node_halo, src_halo, n // n_shards, force_steps[0])
        edge_halo, rev_halo = _repack_forced(
            edge_halo, rev_halo, e // n_shards, force_steps[1])
    return DenseGPIndex(node_halo=node_halo, edge_halo=edge_halo,
                        src_halo=src_halo, rev_halo=rev_halo,
                        n_shards=n_shards)


def _repack_forced(halo: HaloIndex, remap, rows, steps):
    """Re-pad a built halo plan into forced (>= required) widths: an array
    shuffle, no new plan."""
    if any(a > b for a, b in zip(halo.steps, steps)):
        raise ValueError(f"forced halo steps {steps} < required "
                         f"{halo.steps}")
    d = halo.send_idx.shape[0]
    send = np.zeros((d, sum(steps)), dtype=np.int32)
    src_off = dst_off = 0
    for a, b in zip(halo.steps, steps):
        send[:, dst_off:dst_off + a] = halo.send_idx[:,
                                                     src_off:src_off + a]
        src_off += a
        dst_off += b
    # remap entries shift by the widening of the steps before the halo
    # segment they fall in (local rows shift by 0)
    bounds = rows + np.concatenate([[0], np.cumsum(halo.steps)])
    seg = np.searchsorted(bounds, remap, side="right") - 1
    seg = np.clip(seg, 0, len(steps))
    shift = np.concatenate([[0], np.cumsum(
        np.asarray(steps, dtype=np.int64)
        - np.asarray(halo.steps, dtype=np.int64))])
    new_remap = remap.astype(np.int64) + shift[seg]
    return HaloIndex(send_idx=send, steps=tuple(int(s) for s in steps)), \
        new_remap.astype(np.int32)


def make_stacked_dense_index(rows: Sequence, gp_size: int,
                             quantum: int = 8,
                             min_steps: Optional[tuple] = None
                             ) -> DenseGPIndex:
    """Halo plans of the dense micro-batches of a (data x graph) step, one
    a data row, sharing one (node_steps, edge_steps) pair (the max over
    rows, floored by `min_steps`): arrays ``[D, Dc, ...]``."""
    first = [make_dense_gp_index(r, gp_size, quantum) for r in rows]
    node_steps = tuple(max(ix.node_halo.steps[k] for ix in first)
                       for k in range(gp_size - 1))
    edge_steps = tuple(max(ix.edge_halo.steps[k] for ix in first)
                       for k in range(gp_size - 1))
    if min_steps is not None:
        node_steps = tuple(max(a, b) for a, b in
                           zip(node_steps, min_steps[0]))
        edge_steps = tuple(max(a, b) for a, b in
                           zip(edge_steps, min_steps[1]))
    n_loc = int(host(rows[0].z).shape[0]) // gp_size
    e_loc = int(host(rows[0].src).shape[0]) // gp_size
    idxs = []
    for ix in first:
        nh, sh = _repack_forced(ix.node_halo, ix.src_halo, n_loc,
                                node_steps)
        eh, rh = _repack_forced(ix.edge_halo, ix.rev_halo, e_loc,
                                edge_steps)
        idxs.append(DenseGPIndex(node_halo=nh, edge_halo=eh, src_halo=sh,
                                 rev_halo=rh, n_shards=gp_size))
    return DenseGPIndex(
        node_halo=HaloIndex(
            send_idx=np.stack([ix.node_halo.send_idx for ix in idxs]),
            steps=node_steps),
        edge_halo=HaloIndex(
            send_idx=np.stack([ix.edge_halo.send_idx for ix in idxs]),
            steps=edge_steps),
        src_halo=np.stack([ix.src_halo for ix in idxs]),
        rev_halo=np.stack([ix.rev_halo for ix in idxs]),
        n_shards=gp_size)


class HaloFloor:
    """The halo plan of each batch with its widths floored by the widest
    seen so far (JAX's monotone ``steps_floor``)."""

    def __init__(self, n_shards: int):
        self.n_shards = n_shards
        self.steps = None

    def __call__(self, batch) -> DenseGPIndex:
        idx = make_dense_gp_index(batch, self.n_shards)
        steps = (idx.node_halo.steps, idx.edge_halo.steps)
        if self.steps is not None:
            floored = tuple(tuple(max(a, b) for a, b in zip(s, f))
                            for s, f in zip(steps, self.steps))
            if floored != steps:
                idx = make_dense_gp_index(batch, self.n_shards,
                                          force_steps=floored)
                steps = floored
        self.steps = steps
        return idx


@dataclass
class DenseGPRow:
    """One rank's row of a :class:`DenseGPIndex` as tensors."""

    node_send: torch.Tensor
    edge_send: torch.Tensor
    node_steps: Tuple[int, ...]
    edge_steps: Tuple[int, ...]
    src_halo: torch.Tensor
    rev_halo: torch.Tensor


def dense_index_row(idx: DenseGPIndex, index: int, device) -> DenseGPRow:
    def t(a):
        return torch.as_tensor(a[index].astype(np.int64)).to(device)

    return DenseGPRow(node_send=t(idx.node_halo.send_idx),
                      edge_send=t(idx.edge_halo.send_idx),
                      node_steps=tuple(idx.node_halo.steps),
                      edge_steps=tuple(idx.edge_halo.steps),
                      src_halo=t(idx.src_halo), rev_halo=t(idx.rev_halo))


def halo_exchange(table: torch.Tensor, send_idx: torch.Tensor,
                  steps: Sequence[int], axis: Axis) -> torch.Tensor:
    """[R_loc, F] local shard -> [R_loc + sum(steps), F] local + halo
    table: at each populated distance k one gather of the rows to send and
    one shift to rank c - k.  Differentiable (the gather transposes to a
    scatter-add, the shift to the shift back)."""
    d = len(steps) + 1
    parts = [table]
    off = 0
    with collective_exchange():
        for k in range(1, d):
            s = steps[k - 1]
            if s == 0:
                continue
            parts.append(ring_shift(table[send_idx[off:off + s]], axis,
                                    -k))
            off += s
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def shard_dense_batch(batch: GraphBatch, axis: Axis) -> GraphBatch:
    """This rank's block of a dense batch: node, edge and pair rows cut to
    its contiguous node block, the graph fields whole."""
    c, d = axis.index, axis.size
    fields = {}
    for names, rows in ((NODE_FIELDS, batch.z.shape[0]),
                        (EDGE_FIELDS, batch.src.shape[0]),
                        (LG_FIELDS, batch.lg_src.shape[0])):
        if rows % d:
            raise ValueError(f"{rows} rows do not divide the mesh size {d}")
        loc = rows // d
        fields.update({f: getattr(batch, f)[c * loc:(c + 1) * loc]
                       for f in names})
    return dataclasses.replace(batch, **fields, g_index=None)


class DenseGPNodeStage(EdgeGatedGraphConv):
    """The dense node stage with the src gather served from the halo
    (parameter names as the one-device stage's); aggregation K3."""

    def forward(self, x_loc, e_loc, idx: DenseGPRow, edge_mask_loc,
                axis: Axis):
        f = self.features
        n_loc = x_loc.shape[0]
        D = e_loc.shape[0] // n_loc
        cat = torch.cat([self.src_gate(x_loc), self.dst_update(x_loc)],
                        dim=-1)
        cat_e = halo_exchange(cat, idx.node_send, idx.node_steps,
                              axis)[idx.src_halo]
        sg_e, bh_e = cat_e[:, :f], cat_e[:, f:]
        dg = self.dst_gate(x_loc)
        m = (sg_e.reshape(n_loc, D, f) + dg[:, None, :]).reshape(-1, f) \
            + self.edge_gate(e_loc)
        h = dense_gated_aggregate(fold_mask(m, edge_mask_loc), bh_e, D)
        x_new = F.silu(self.norm_nodes(self.src_update(x_loc) + h))
        e_new = F.silu(self.norm_edges(m))
        return x_loc + x_new, e_loc + e_new


class DenseGPPairStage(EdgeGatedGraphConv):
    """The dense local-pair L-stage with the rev rides served from the
    halo; aggregation K4 (backward K5a, second order K5b).  With
    ``ALIGNN_TPU_FP8_LTABLES`` set the [L_loc, F] stream into the next
    layer goes through the e4m3 round trip, as on one device."""

    def forward(self, m_loc, z_loc, idx: DenseGPRow, lg_mask_loc,
                axis: Axis):
        f = self.features
        D = z_loc.shape[0] // m_loc.shape[0]
        n = m_loc.shape[0] // D
        sg = self.src_gate(m_loc)
        dg_r = halo_exchange(self.dst_gate(m_loc), idx.edge_send,
                             idx.edge_steps, axis)[idx.rev_halo]
        m2 = (sg.reshape(n, 1, D, f) + dg_r.reshape(n, D, 1, f)).reshape(
            -1, f) + self.edge_gate(z_loc)
        m2 = fold_mask(m2, lg_mask_loc)
        h_jt = dense_pair_aggregate(m2, self.dst_update(m_loc), D)
        h = halo_exchange(h_jt, idx.edge_send, idx.edge_steps,
                          axis)[idx.rev_halo]
        y_new = F.silu(self.norm_nodes(self.src_update(m_loc) + h))
        z_out = z_loc + F.silu(self.norm_edges(m2))
        if fp8_ltables_enabled():
            z_out = fp8_round_trip(z_out)
        return m_loc + y_new, z_out


class _DenseGPALIGNNConv(nn.Module):
    def __init__(self, features: int, dtype=None):
        super().__init__()
        self.node_update = DenseGPNodeStage(features, dtype=dtype)
        self.edge_update = DenseGPPairStage(features, dtype=dtype)

    def forward(self, x, y, z, idx, edge_mask_loc, lg_mask_loc, axis):
        x, m = self.node_update(x, y, idx, edge_mask_loc, axis)
        y, z = self.edge_update(m, z, idx, lg_mask_loc, axis)
        return x, y, z


class _DenseGPTrunk(nn.Module):
    def __init__(self, cfg, dtype=None):
        super().__init__()
        self.alignn_layers = cfg.alignn_layers
        self.gcn_layers = cfg.gcn_layers
        for i in range(cfg.alignn_layers):
            setattr(self, f"alignn_layers_{i}",
                    _DenseGPALIGNNConv(cfg.hidden_features, dtype))
        for i in range(cfg.gcn_layers):
            setattr(self, f"gcn_layers_{i}",
                    DenseGPNodeStage(cfg.hidden_features, dtype=dtype))

    def forward(self, x, y, z, idx, edge_mask_loc, lg_mask_loc, axis):
        for i in range(self.alignn_layers):
            x, y, z = getattr(self, f"alignn_layers_{i}")(
                x, y, z, idx, edge_mask_loc, lg_mask_loc, axis)
        for i in range(self.gcn_layers):
            x, y = getattr(self, f"gcn_layers_{i}")(x, y, idx,
                                                    edge_mask_loc, axis)
        return x, y


class DenseGPALIGNNAtomWise(ALIGNNAtomWise):
    """Node-block-sharded dense ALIGNN-FF core; the parameter tree is
    ALIGNNAtomWise's (a one-device state dict loads unchanged).
    ``forward(batch, r_loc, idx)`` takes the rank's block
    (:func:`shard_dense_batch`), its [E_loc, 3] bond vectors and its
    :class:`DenseGPRow`; ``atomwise_pred`` stays the local block."""

    def __init__(self, cfg, dtype=None, axis: Axis = None):
        super().__init__(cfg, dtype=dtype)
        self.trunk = _DenseGPTrunk(cfg, dtype)
        self.axis = axis

    @classmethod
    def sharing(cls, model: ALIGNNAtomWise, axis: Axis
                ) -> "DenseGPALIGNNAtomWise":
        """The dense GP model over `model`'s own parameters."""
        return share_parameters(
            cls(model.cfg, dtype=model.dtype, axis=axis).to(
                next(model.parameters()).device), model)

    def forward(self, batch: GraphBatch, r_loc: torch.Tensor,
                idx: DenseGPRow):
        cfg, axis = self.cfg, self.axis
        bondlength = torch.linalg.norm(r_loc, dim=1)
        cosines = bond_cosines_dense(r_loc, batch.dense_D)
        edge_scale = None
        rbf_input = bondlength
        if cfg.use_cutoff_function:
            envelope = cutoff_function_based_edges(
                bondlength, inner_cutoff=cfg.inner_cutoff,
                exponent=cfg.exponent)
            if cfg.multiply_cutoff:
                edge_scale = envelope
            else:
                rbf_input = envelope
        x, y, z = self.embeddings(batch, rbf_input, cosines, edge_scale)
        x, _y = self.trunk(x, y, z, idx, batch.edge_mask, batch.lg_mask,
                           axis)
        return atomwise_heads(self, batch, x, bondlength,
                              edge_group=axis.group, node_group=axis.group)


def _device_energy_forces_stress(model, model_cfg, batch: GraphBatch,
                                 idx: DenseGPRow, gp_size: int,
                                 create_graph: bool):
    """The per-rank E/F/S assembly: (res, forces_loc, stress).  The
    gradient of the replicated energy is divided by the axis size, as on
    the ring; the reverse forces ride the edge halo."""
    axis = model.axis
    D = batch.dense_D
    r_loc = batch.r.detach().requires_grad_(True)
    with torch.enable_grad():
        res = model(batch, r_loc, idx)
        energy = torch.sum(res["en_out"] * batch.graph_mask)
        (g_r,) = torch.autograd.grad(energy, r_loc,
                                     create_graph=create_graph)
    pair_forces = model_cfg.grad_multiplier * (g_r / gp_size)
    if model_cfg.force_mult_natoms:
        pair_forces = pair_forces * batch.n_nodes.sum()

    n_loc = batch.z.shape[0]
    forces_loc = pair_forces.reshape(n_loc, D, 3).sum(dim=1)
    if model_cfg.add_reverse_forces:
        # a masked consumer row maps to local row 0, a real row: mask the
        # ride (one device maps trash rows to themselves instead)
        pf_rev = halo_exchange(pair_forces, idx.edge_send, idx.edge_steps,
                               axis)[idx.rev_halo] * batch.edge_mask[:, None]
        forces_loc = forces_loc - pf_rev.reshape(n_loc, D, 3).sum(dim=1)

    if model_cfg.stresswise_weight != 0:
        outer = torch.einsum("ei,ej->eij", batch.r, pair_forces)
        per_graph = all_reduce_sum(segment_sum(
            outer, batch.edge_graph, batch.graph_mask.shape[0]), axis.group)
        div = 2.0 if not getattr(model_cfg, "batch_stress", True) else 1.0
        stress = (-model_cfg.stress_multiplier * EV_A3_TO_GPA * per_graph
                  / (div * torch.clamp_min(batch.volume, 1e-12)
                     [:, None, None]))
    else:
        stress = torch.zeros_like(batch.stress)
    return res, forces_loc, stress


def dense_gp_device_outputs(model, model_cfg, batch: GraphBatch,
                            idx: DenseGPRow, n_devices: int,
                            create_graph: bool = False):
    """One rank's dense-GP forward: (out, forces, stress, res), the forces
    gathered over the axis."""
    res, forces_loc, stress = _device_energy_forces_stress(
        model, model_cfg, batch, idx, n_devices, create_graph)
    return res["out"], all_gather(forces_loc, model.axis), stress, res


def make_dense_gp_forward(model: ALIGNNAtomWise, mesh: Mesh):
    """batch -> (out, forces, stress), the halo-exchange dense-GP E/F/S
    forward of `model`'s parameters over the mesh's graph axis (each rank
    passes the same whole dense batch)."""
    axis = mesh.axis(GRAPH_AXIS)
    gp = DenseGPALIGNNAtomWise.sharing(model, axis)
    floor = HaloFloor(axis.size)

    def fwd(batch: GraphBatch, idx: Optional[DenseGPIndex] = None):
        idx = floor(batch) if idx is None else idx
        local = shard_dense_batch(batch, axis)
        gp.eval()
        with ordered_collectives(batch.r.device):
            out, forces, stress, _ = dense_gp_device_outputs(
                gp, model.cfg, local, dense_index_row(idx, axis.index,
                                                      batch.r.device),
                axis.size)
        return out.detach(), forces.detach(), stress.detach()

    return fwd


def _masked_mean_psum(err, mask, group):
    """The masked mean of a node- or edge-sharded term: the local masked
    sum and count, summed over the ranks in one all-reduce, so the result
    equals the unsharded masked mean."""
    m = mask
    while m.dim() < err.dim():
        m = m[..., None]
    sums = all_reduce_sum(torch.stack(
        [torch.sum(err * m), torch.sum(m.expand_as(err))]), group)
    return sums[0] / torch.clamp_min(sums[1], 1.0)


def dense_gp_loss(res, forces_loc, stress, batch: GraphBatch, model_cfg,
                  classification: bool = False, group=None):
    """The 5-part atomwise loss over node-block shards: the graph terms
    read the replicated outputs, the node terms (forces, atomwise) reduce
    with :func:`_masked_mean_psum`, so the total equals
    :func:`~alignn_tpu_torch.train.losses.atomwise_loss` of the unsharded
    batch."""
    from alignn_tpu_torch.train.losses import l1_loss, masked_mean

    zero = batch.graph_mask.new_zeros((), dtype=torch.float32)
    loss1 = loss2 = loss3 = loss4 = loss5 = zero
    if model_cfg.output_features is not None and \
            model_cfg.graphwise_weight != 0:
        if classification:
            labels = batch.target[:, 0]
            p = res["out"][:, 0]
            bce = -(labels * torch.log(p + 1e-10)
                    + (1 - labels) * torch.log(1 - p + 1e-10))
            loss1 = model_cfg.graphwise_weight * masked_mean(
                bce, batch.graph_mask)
        else:
            tw = batch.target.shape[1]
            loss1 = model_cfg.graphwise_weight * l1_loss(
                res["out"][:, :tw], batch.target, batch.graph_mask)
    if model_cfg.atomwise_output_features > 0 and \
            model_cfg.atomwise_weight != 0:
        aw = batch.atomwise_target.shape[1]
        loss2 = model_cfg.atomwise_weight * _masked_mean_psum(
            torch.abs(res["atomwise_pred"][:, :aw] - batch.atomwise_target),
            batch.node_mask, group)
    if model_cfg.calculate_gradient and model_cfg.gradwise_weight != 0:
        loss3 = model_cfg.gradwise_weight * _masked_mean_psum(
            torch.abs(forces_loc - batch.forces), batch.node_mask, group)
    if model_cfg.stresswise_weight != 0:
        loss4 = model_cfg.stresswise_weight * l1_loss(
            stress, batch.stress, batch.graph_mask)
    if getattr(model_cfg, "additional_output_weight", 0) != 0 and \
            getattr(model_cfg, "additional_output_features", 0) > 0:
        fw = batch.additional.shape[1]
        loss5 = model_cfg.additional_output_weight * l1_loss(
            res["additional"][:, :fw], batch.additional, batch.graph_mask)
    total = loss1 + loss2 + loss3 + loss4 + loss5
    return {"loss": total, "loss1": loss1, "loss2": loss2, "loss3": loss3,
            "loss4": loss4, "loss5": loss5}


def make_dense_gp_train_step(model: ALIGNNAtomWise, mesh: Mesh,
                             classification: bool = False):
    """(state, dense batch[, idx]) -> (state, losses) over the mesh's
    graph axis: the full E/F/S objective (with the force grad-of-grad)
    with the dense layout node-block-sharded and halo-exchanged; the
    gradients and losses are averaged over the graph axis, then over the
    data axis where the mesh has one (the data x dense-GP step, each data
    row with its own micro-batch)."""
    from alignn_tpu_torch.parallel.dp_gp import gp_train_step

    axis = mesh.axis(GRAPH_AXIS)
    gp = DenseGPALIGNNAtomWise.sharing(model, axis)
    floor = HaloFloor(axis.size)

    def losses_of(batch: GraphBatch, idx: Optional[DenseGPIndex] = None):
        idx = floor(batch) if idx is None else idx
        local = shard_dense_batch(batch, axis)
        gp.train()
        res, forces_loc, stress = _device_energy_forces_stress(
            gp, model.cfg, local, dense_index_row(idx, axis.index,
                                                  batch.r.device),
            axis.size, create_graph=True)
        return dense_gp_loss(res, forces_loc, stress, local, model.cfg,
                             classification=classification,
                             group=axis.group)

    return gp_train_step(model, mesh, losses_of)


make_dp_dense_gp_train_step = make_dense_gp_train_step
