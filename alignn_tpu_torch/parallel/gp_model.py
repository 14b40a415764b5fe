"""The ring-pipelined graph-parallel ALIGNN-FF model (counterpart of
``alignn_tpu/parallel/gp_model.py``).

Each rank of a "graph" axis holds one shard of the edge space (layout in
:mod:`alignn_tpu_torch.parallel.gp_batch`).  The parameter tree is
:class:`~alignn_tpu_torch.nn.models.ALIGNNAtomWise`'s, module for module,
so a single-device state dict (or a JAX checkpoint through
:mod:`alignn_tpu_torch.nn.convert`) loads unchanged, and
:meth:`GPALIGNNAtomWise.sharing` runs a trained model's own parameters.

- The g stage (:class:`EdgeShardedGatedGraphConv`) keeps the node table
  replicated: each rank sums its edge shard's packed ``[sigma bh | sigma]``
  rows into the nodes with the sorted segment sum (K2 on the card) and the
  partial sums are all-reduced before the divide.
- The L(g) stage (:class:`RingEdgeGatedGraphConv`) walks the ring: the
  ``[E/G, 2F]`` gate/update buffer moves one rank along at each step while
  the step's L-edge group aggregates into ``num`` and ``den``, in f32, one
  K2 call a step.  ``ALIGNN_TPU_GP_RING=gather`` (:func:`ring_mode`) makes
  every arrived buffer first (:func:`ring_broadcast`), whose backward
  returns each step's cotangent by one independent shift.
"""

from __future__ import annotations

import dataclasses
import os

import torch
from torch import nn
from torch.nn import functional as F

from alignn_tpu_torch.graph.batch import GraphBatch, Incidence
from alignn_tpu_torch.nn.layers import ALIGNNConv, EdgeGatedGraphConv
from alignn_tpu_torch.nn.models import ALIGNNAtomWise, atomwise_heads
from alignn_tpu_torch.ops.basis import _clip_cos, cutoff_function_based_edges
from alignn_tpu_torch.ops.eggc import (gather_nodes, sorted_gather,
                                       sorted_segment_sum)
from alignn_tpu_torch.parallel.gp_batch import RingSteps
from alignn_tpu_torch.parallel import mesh as meshlib
from alignn_tpu_torch.parallel.mesh import (Axis, _audit_label, _backward_of,
                                            _chained, _next_token, _nbytes,
                                            _shift, all_reduce_sum,
                                            collective_exchange, ring_shift)


def ring_mode() -> str:
    """The reverse ring of the L-stage halo, read from
    ``ALIGNN_TPU_GP_RING`` as JAX reads it: "chain" (the default: the
    buffer moves one shift at a time and autograd reverses the chain) or
    "gather" (:func:`ring_broadcast`)."""
    return os.environ.get("ALIGNN_TPU_GP_RING", "chain")


class _RingBroadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf: torch.Tensor, axis: Axis, token):
        ctx.axis, ctx.audit_label = axis, _audit_label()
        bufs = [buf]
        for _ in range(1, axis.size):
            bufs.append(_shift(bufs[-1], axis, 1))
        return torch.stack(bufs), _next_token(token)

    @staticmethod
    def backward(ctx, g: torch.Tensor, _token_grad):
        # g[k] is the cotangent of the shard of rank c - k: each returns
        # to its producer by its own shift, independent of the others
        out = g[0]
        with _backward_of(ctx):
            for k in range(1, ctx.axis.size):
                out = out + ring_shift(g[k], ctx.axis, -k)
        return out, None, None


def ring_broadcast(buf: torch.Tensor, axis: Axis) -> torch.Tensor:
    """[S, W] local shard -> [G, S, W]: row k is the shard of rank
    (c - k) mod G, what arrives at ring step k of the chain.  Forward: the
    chain of G-1 neighbour shifts; backward: one shift by -k a row (each a
    :func:`~alignn_tpu_torch.parallel.mesh.ring_shift`, so the backward is
    differentiable again)."""
    rec = meshlib.RECORDER
    if rec is None or axis.size == 1:
        return _chained(_RingBroadcast, buf, axis)
    with rec.exchange():
        return rec.collective("shift", buf, 1, _nbytes(buf),
                              lambda: _chained(_RingBroadcast, buf, axis),
                              repeat=axis.size - 1, axis_size=axis.size)


def _step_gather(buf: torch.Tensor, st: Incidence) -> torch.Tensor:
    """buf[step src]: its transpose a sorted segment sum (K2)."""
    return gather_nodes(buf, st.src, st.src_perm, st.src_perm_inv,
                        st.src_sorted)


def ring_cosines(r_loc: torch.Tensor, ring: RingSteps,
                 axis: Axis) -> torch.Tensor:
    """Bond-angle cosines of the ring-ordered L-edges from the sharded
    bond vectors: step k reads the shard that has just arrived, so r is
    never replicated."""
    gather = ring_mode() == "gather"
    bufs = ring_broadcast(r_loc, axis) if gather else None
    buf = r_loc
    parts = []
    with collective_exchange():
        for k, st in enumerate(ring.steps):
            r1 = -_step_gather(bufs[k] if gather else buf, st)
            r2 = sorted_gather(r_loc, st.dst)
            num = torch.sum(r1 * r2, dim=1)
            den = torch.linalg.norm(r1, dim=1) * torch.linalg.norm(r2,
                                                                  dim=1)
            parts.append(_clip_cos(num / torch.clamp_min(den, 1e-12)))
            if not gather and k + 1 < ring.n_shards:
                buf = ring_shift(buf, axis, 1)
    return torch.cat(parts)


class EdgeShardedGatedGraphConv(EdgeGatedGraphConv):
    """The g stage on an edge shard (JAX's EdgeGatedGraphConv with an
    ``edge_axis``): x replicated, e and the incidence this rank's edges;
    the packed sums are all-reduced over the axis before the divide."""

    def forward(self, x: torch.Tensor, e: torch.Tensor, g: Incidence,
                axis: Axis):
        f = self.features
        cat_e = gather_nodes(
            torch.cat([self.src_gate(x), self.dst_update(x)], dim=-1),
            g.src, g.src_perm, g.src_perm_inv, g.src_sorted)
        sg_e, bh_e = cat_e[:, :f], cat_e[:, f:]
        m = sg_e + sorted_gather(self.dst_gate(x), g.dst) + self.edge_gate(e)
        sigma = torch.sigmoid(m)
        summed = all_reduce_sum(sorted_segment_sum(
            torch.cat([bh_e * sigma, sigma], dim=-1), g.dst), axis.group)
        h = summed[:, :f] / (summed[:, f:] + 1e-6)
        x_new = x + F.silu(self.norm_nodes(self.src_update(x) + h))
        e_new = e + F.silu(self.norm_edges(m))
        return x_new, e_new


class RingEdgeGatedGraphConv(EdgeGatedGraphConv):
    """EGGC on L(g) with the ring halo: node features are the bond
    messages m (this rank's [E/G, F] shard), edge features the angle
    features z (ring-ordered).  Padded ring columns carry mask 0 and drop
    out of both sums."""

    def forward(self, m_loc: torch.Tensor, z_ring: torch.Tensor,
                ring: RingSteps, axis: Axis):
        f = self.features
        e_loc = m_loc.shape[0]
        off = ring.offsets
        dst_gate = self.dst_gate(m_loc)
        edge_gate = self.edge_gate(z_ring)
        buf = torch.cat([self.src_gate(m_loc), self.dst_update(m_loc)],
                        dim=-1)
        gather = ring_mode() == "gather"
        bufs = ring_broadcast(buf, axis) if gather else None
        num = m_loc.new_zeros((e_loc, f), dtype=torch.float32)
        den = m_loc.new_zeros((e_loc, f), dtype=torch.float32)
        m_lg = []
        with collective_exchange():
            for k, st in enumerate(ring.steps):
                cat_r = _step_gather(bufs[k] if gather else buf, st)
                m_k = cat_r[:, :f] + sorted_gather(dst_gate, st.dst) \
                    + edge_gate[off[k]:off[k + 1]]
                sigma = torch.sigmoid(m_k) * ring.mask[off[k]:off[k + 1],
                                                       None]
                agg = sorted_segment_sum(torch.cat(
                    [sigma * cat_r[:, f:], sigma], dim=-1).float(), st.dst)
                num = num + agg[:, :f]
                den = den + agg[:, f:]
                m_lg.append(m_k)
                if not gather and k + 1 < ring.n_shards:
                    buf = ring_shift(buf, axis, 1)
        h = (num / (den + 1e-6)).to(m_loc.dtype)
        x_new = F.silu(self.norm_nodes(self.src_update(m_loc) + h))
        e_new = F.silu(self.norm_edges(torch.cat(m_lg)))
        return m_loc + x_new, z_ring + e_new


class _GPALIGNNConv(ALIGNNConv):
    """One ALIGNN layer: the all-reduced g stage, then the ring L-stage
    (module names as :class:`~alignn_tpu_torch.nn.layers.ALIGNNConv`)."""

    def __init__(self, features: int, dtype=None):
        nn.Module.__init__(self)
        self.node_update = EdgeShardedGatedGraphConv(features, dtype=dtype)
        self.edge_update = RingEdgeGatedGraphConv(features, dtype=dtype)

    def forward(self, x, y, z, g: Incidence, ring: RingSteps, axis: Axis):
        x, m = self.node_update(x, y, g, axis)
        y, z = self.edge_update(m, z, ring, axis)
        return x, y, z


class _GPTrunk(nn.Module):
    """ALIGNN + GCN stacks; module names as the model's ``_Trunk``."""

    def __init__(self, cfg, dtype=None):
        super().__init__()
        self.alignn_layers = cfg.alignn_layers
        self.gcn_layers = cfg.gcn_layers
        for i in range(cfg.alignn_layers):
            setattr(self, f"alignn_layers_{i}",
                    _GPALIGNNConv(cfg.hidden_features, dtype))
        for i in range(cfg.gcn_layers):
            setattr(self, f"gcn_layers_{i}",
                    EdgeShardedGatedGraphConv(cfg.hidden_features,
                                              dtype=dtype))

    def forward(self, batch: GraphBatch, x, y, z, ring: RingSteps,
                axis: Axis):
        for i in range(self.alignn_layers):
            x, y, z = getattr(self, f"alignn_layers_{i}")(
                x, y, z, batch.g_index, ring, axis)
        for i in range(self.gcn_layers):
            x, y = getattr(self, f"gcn_layers_{i}")(x, y, batch.g_index,
                                                    axis)
        return x, y


def share_parameters(dst: nn.Module, src: nn.Module) -> nn.Module:
    """Bind every parameter and buffer of `dst` to the tensor of the same
    name in `src` (the same parameter tree): `dst` then computes with,
    and its gradients land in, `src`'s own parameters."""
    names = dict(src.named_parameters())
    names.update(src.named_buffers())
    for name in list(dict(dst.named_parameters())) + \
            list(dict(dst.named_buffers())):
        owner, _, leaf = name.rpartition(".")
        mod = dst.get_submodule(owner) if owner else dst
        if leaf in mod._parameters:
            mod._parameters[leaf] = names[name]
        else:
            mod._buffers[leaf] = names[name]
    return dst


class GPALIGNNAtomWise(ALIGNNAtomWise):
    """Edge-sharded ALIGNN-FF core.

    ``forward(batch, r_loc, ring)``: `batch` carries this rank's edge
    shard (:func:`~alignn_tpu_torch.parallel.graph_parallel.shard_batch`)
    and the replicated node and graph fields, `r_loc` is the rank's
    [E/G, 3] bond-vector shard (the point the forces differentiate at) and
    `ring` its :class:`~alignn_tpu_torch.parallel.gp_batch.RingSteps`.
    Returns ALIGNNAtomWise's dict; out and en_out are replicated,
    ``bondlength`` is the local shard.  The envelope-weighted models have
    no ring path (JAX's ignores their weights) and raise.
    """

    def __init__(self, cfg, dtype=None, axis: Axis = None):
        if getattr(cfg, "envelope_edge_weights", False):
            raise ValueError("the ring-parallel model has no envelope "
                             "weights; train envelope models unsharded")
        super().__init__(cfg, dtype=dtype)
        self.trunk = _GPTrunk(cfg, dtype)
        self.axis = axis

    @classmethod
    def sharing(cls, model: ALIGNNAtomWise, axis: Axis
                ) -> "GPALIGNNAtomWise":
        """The GP model over `model`'s own parameters."""
        return share_parameters(
            cls(model.cfg, dtype=model.dtype, axis=axis).to(
                next(model.parameters()).device), model)

    def forward(self, batch: GraphBatch, r_loc: torch.Tensor,
                ring: RingSteps):
        cfg, axis = self.cfg, self.axis
        bondlength = torch.linalg.norm(r_loc, dim=1)
        cosines = ring_cosines(r_loc, ring, axis)
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
        # the ring-ordered mask stands in for lg_mask: its shape is the
        # ring cosines'
        x, y, z = self.embeddings(
            dataclasses.replace(batch, lg_mask=ring.mask), rbf_input,
            cosines, edge_scale)
        x, _y = self.trunk(batch, x, y, z, ring, axis)
        return atomwise_heads(self, batch, x, bondlength,
                              edge_group=axis.group)
