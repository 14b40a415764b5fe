"""Core modules: layer norm, MLP block, edge-gated graph convolution.

Counterpart of ``alignn_tpu/nn/layers.py`` on the sparse and the
dense-neighbourhood layouts.  Module and attribute names follow the flax
parameter tree (``src_gate``, ``norm_nodes``, ...), so
:mod:`alignn_tpu_torch.nn.convert` maps a checkpoint mechanically, and
one state dict drives both layouts.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from alignn_tpu_torch.graph.batch import Incidence
from alignn_tpu_torch.ops.basis import rbf_expand, rbf_params
from alignn_tpu_torch.ops.dense import (dense_gated_aggregate,
                                        dense_pair_aggregate, fold_mask)
from alignn_tpu_torch.ops.eggc import (gated_aggregate, gather_nodes,
                                       permute_rows, sorted_gather,
                                       weighted_aggregate)
from alignn_tpu_torch.ops.fp8 import fp8_ltables_enabled, fp8_round_trip
from alignn_tpu_torch.ops.fused_lstage import fused_pair_lstage


class Dense(nn.Linear):
    """flax's Dense: y = x @ kernel + bias with torch's default init,
    which is ``nn.Linear``'s (the checkpoint converter transposes the
    kernel).

    `dtype` is the compute dtype, as in JAX: x and the kernel are cast to
    it, the product comes out in it (f32 accumulation) and the bias, cast
    to it, is added after.  With ``dtype=None`` the operands promote as
    ``jnp.dot`` promotes them: a bf16 input against the f32 kernel
    computes in f32 (the output heads).  The parameters stay f32.
    """

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        if dt == self.weight.dtype:
            return F.linear(x.to(dt), self.weight, self.bias)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class MaskedLayerNorm(nn.Module):
    """Row-wise LayerNorm (eps 1e-5, affine).

    Statistics and affine run in at least f32; the output keeps the input
    dtype.
    """

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.epsilon = epsilon

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`mask` is unused: per-row statistics leave padded rows alone."""
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.weight + self.bias).to(x.dtype)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the rows whose mask is 1 (torch ``BatchNorm1d``
    semantics without its padded rows).

    In training the output normalises with the biased variance of the
    masked rows, and the running statistics (buffers ``mean`` and ``var``,
    the JAX tree's ``batch_stats``) move by momentum 0.1 towards the mean
    and the unbiased variance var * cnt / max(cnt - 1, 1), once per
    forward.  In eval the running statistics normalise.  Statistics and
    affine run in at least f32; the output keeps the input dtype.
    ``nn.BatchNorm1d`` would count the padded rows and the trash slot.
    With ``update_stats`` False (a layer's recompute under
    ``remat_layers``) the running statistics stay where they are.

    With a process ``group`` (JAX's ``axis_name``; set by the model's
    constructor, :func:`set_batchnorm_group`) the row count and the two
    sums are packed into one buffer and summed over the group's ranks
    before the statistics are formed, so that every rank normalises with
    the statistics of the whole data-parallel batch.  The sum is
    differentiable (:func:`~alignn_tpu_torch.parallel.mesh.
    all_reduce_sum`): one collective a layer forward and one backward,
    whose sum carries each rank's share of the other ranks' gradient.
    """

    def __init__(self, features: int, momentum: float = 0.1,
                 epsilon: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.momentum = momentum
        self.epsilon = epsilon
        self.update_stats = True
        self.group = None

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: Optional[bool] = None) -> torch.Tensor:
        """`train` None follows the module's mode (``model.train()``)."""
        train = self.training if train is None else train
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if not train:
            mean, var = self.mean.to(xf.dtype), self.var.to(xf.dtype)
        else:
            w = xf.new_ones(x.shape[0]) if mask is None else mask.to(xf.dtype)
            cnt = w.sum()
            sum_x = (xf * w[:, None]).sum(dim=0)
            sum_x2 = ((xf * xf) * w[:, None]).sum(dim=0)
            if self.group is not None:
                from alignn_tpu_torch.parallel.mesh import all_reduce_sum

                f = sum_x.shape[0]
                packed = all_reduce_sum(
                    torch.cat([cnt.reshape(1), sum_x, sum_x2]), self.group)
                cnt, sum_x, sum_x2 = packed[0], packed[1:f + 1], \
                    packed[f + 1:]
            cnt = torch.clamp_min(cnt, 1.0)
            mean = sum_x / cnt
            var = torch.clamp_min(sum_x2 / cnt - mean * mean, 0.0)
            if self.update_stats:
                with torch.no_grad():
                    m = self.momentum
                    unbiased = var * cnt / torch.clamp_min(cnt - 1.0, 1.0)
                    self.mean.copy_((1 - m) * self.mean + m * mean.float())
                    self.var.copy_((1 - m) * self.var + m * unbiased.float())
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.weight + self.bias).to(x.dtype)


NORMS = {"layernorm": MaskedLayerNorm, "batchnorm": MaskedBatchNorm}


def set_batchnorm_group(module: nn.Module, group) -> None:
    """Every :class:`MaskedBatchNorm` under `module` reduces its batch
    statistics over the ranks of `group` (None: this rank's batch alone).
    A LayerNorm model has none, and nothing changes."""
    for m in module.modules():
        if isinstance(m, MaskedBatchNorm):
            m.group = group


class RBFExpansion(nn.Module):
    """Gaussian RBF expansion (no parameters)."""

    def __init__(self, vmin: float = 0.0, vmax: float = 8.0,
                 bins: int = 40, lengthscale: float | None = None):
        super().__init__()
        centers, self.gamma = rbf_params(vmin, vmax, bins, lengthscale)
        self.register_buffer(
            "centers", torch.tensor(centers, dtype=torch.float32),
            persistent=False)

    def forward(self, distance: torch.Tensor) -> torch.Tensor:
        return rbf_expand(distance, self.centers, self.gamma)


class MLPLayer(nn.Module):
    """Linear (compute dtype `dtype`) -> LayerNorm or masked BatchNorm ->
    SiLU."""

    def __init__(self, in_features: int, features: int,
                 norm: str = "layernorm",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.linear = Dense(in_features, features, dtype=dtype)
        self.norm = NORMS[norm](features)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return F.silu(self.norm(self.linear(x), mask))


class DenseWiring(NamedTuple):
    """What the dense layers read of a dense batch (graph/dense.py)."""

    D: int                  # in-degree block
    edge_mask: torch.Tensor  # [N*D]
    lg_mask: torch.Tensor    # [N*D*D]
    rev: torch.Tensor        # [N*D] reverse-edge involution


class EdgeGatedGraphConv(nn.Module):
    """Edge-gated graph convolution, sparse layout:

        m_e   = W_sg x_src + W_dg x_dst + W_eg e
        h_i   = sum_{e->i} sigma(m_e) W_du x_src(e) / (sum sigma(m_e) + 1e-6)
        x'    = x + SiLU(LN(W_su x + h))
        e'    = e + SiLU(LN(m))

    ("dst_update" acts on source features: the reference's naming.)  The
    src-side gathers ride one concatenated gather whose transpose is a
    sorted segment sum (K2); the dst-side gather transposes into K2
    directly; the aggregation is K1.  ``windows`` = (src, dst, src_sorted)
    are the stage's static gather windows (0 = plain gather): with them the
    gathers, at every derivative order, run the windowed gather K8.

    With soft edge weights w (``edge_weight``: the envelope-weighted
    models, eALIGNN's inner-cutoff masks) the gates are sigma(m) * w and
    the aggregation divides by their sum plus ``soft_eps`` (JAX's
    ``soft_agg_eps``: 1e-3 for the envelope models, 1e-6 else): a zero
    weight removes the edge from both sums.  On the sparse layout that
    branch runs the packed sums through K2 (:func:`weighted_aggregate`)
    and bypasses K1; on the dense layout it is plain sums over the D
    block (node stage) or the s axis of the pairs (L-stage), as in JAX,
    and bypasses K3 and K4.

    With a :class:`DenseWiring` the node stage runs on the dense layout
    (aggregation K3), and :meth:`pair_stage` is the dense L-stage (K4), or
    with ``ALIGNN_TPU_FUSED_LSTAGE`` set, LayerNorm tails and no weights
    the fused L-stage (K6, K7).

    ``norm="batchnorm"`` (the property model) makes both tails masked
    BatchNorms: the node tail's statistics count the rows of
    `node_mask`, the edge tail's those of `edge_mask` (on the L-stage the
    nodes are g's edges and the edges its angle pairs).

    `dtype` is the five Dense layers' compute dtype (JAX's ``dtype``):
    with bf16 or f16 the gates and tables are in it, the kernels sum in
    f32, the norms' statistics are f32, and a soft-weighted sum comes out
    in f32 (the weights are f32), which promotes the residual stream as
    in JAX.
    """

    def __init__(self, features: int, norm: str = "layernorm",
                 soft_eps: float = 1e-6,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.features = features
        self.norm = norm
        self.soft_eps = soft_eps
        for name in ("src_gate", "dst_gate", "edge_gate", "src_update",
                     "dst_update"):
            setattr(self, name, Dense(features, features, dtype=dtype))
        self.norm_nodes = NORMS[norm](features)
        self.norm_edges = NORMS[norm](features)

    def forward(self, x: torch.Tensor, e: torch.Tensor, g: Incidence,
                dense: Optional[DenseWiring] = None,
                windows: Tuple[int, int, int] = (0, 0, 0),
                edge_weight: Optional[torch.Tensor] = None,
                node_mask: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None):
        if dense is not None:
            return self._dense_node_stage(x, e, g, dense, node_mask,
                                          edge_weight)
        f = self.features
        w_src, w_dst, w_src_sorted = windows
        cat_e = gather_nodes(
            torch.cat([self.src_gate(x), self.dst_update(x)], dim=-1),
            g.src, g.src_perm, g.src_perm_inv, g.src_sorted, w_src,
            w_src_sorted)
        sg_e, bh_e = cat_e[:, :f], cat_e[:, f:]
        dg_e = sorted_gather(self.dst_gate(x), g.dst, w_dst)
        m = sg_e + dg_e + self.edge_gate(e)
        # JAX's aggregation keeps its window only where its kernel runs
        # (edge_gated_aggregate_pallas: 128-row node tiles, F % 128 == 0)
        w_agg = w_dst if f % 128 == 0 and x.shape[0] % 128 == 0 else 0
        if edge_weight is None:
            h = gated_aggregate(m, bh_e, g.dst, w_agg)
        else:
            h = weighted_aggregate(
                bh_e, torch.sigmoid(m) * edge_weight[:, None], g.dst,
                self.soft_eps)
        x_new = x + F.silu(self.norm_nodes(self.src_update(x) + h,
                                           node_mask))
        e_new = e + F.silu(self.norm_edges(m, edge_mask))
        return x_new, e_new

    def _dense_node_stage(self, x, e, g: Incidence, dense: DenseWiring,
                          node_mask: Optional[torch.Tensor],
                          edge_weight: Optional[torch.Tensor] = None):
        """Node stage on the dense layout (JAX ``_dense_gather_aggregate``):
        the ``[sg | bh]`` src gather transposes into K2, the dst side is a
        block broadcast (transpose: a block sum), the slot mask folds into
        the logits, and the aggregation is K3, or with `edge_weight` the
        weighted sums over each D block."""
        f, D = self.features, dense.D
        n = x.shape[0]
        cat_e = gather_nodes(
            torch.cat([self.src_gate(x), self.dst_update(x)], dim=-1),
            g.src, g.src_perm, g.src_perm_inv, g.src_sorted)
        sg_e, bh_e = cat_e[:, :f], cat_e[:, f:]
        dg = self.dst_gate(x)
        m = (sg_e.reshape(n, D, f) + dg[:, None, :]).reshape(-1, f) \
            + self.edge_gate(e)
        m_agg = fold_mask(m, dense.edge_mask)
        if edge_weight is None:
            h = dense_gated_aggregate(m_agg, bh_e, D)
        else:
            h = self._weighted_sums(m_agg, edge_weight, bh_e.reshape(
                n, D, f), (n, D, f)).reshape(n, f)
        x_new = x + F.silu(self.norm_nodes(self.src_update(x) + h,
                                           node_mask))
        e_new = e + F.silu(self.norm_edges(m, dense.edge_mask))
        return x_new, e_new

    def _weighted_sums(self, m, w, bh, shape):
        """sum sigma(m) w bh / (sum sigma(m) w + soft_eps) over axis -2 of
        `shape`, in f32 (JAX's weighted dense branches), in m's dtype."""
        sigma = (torch.sigmoid(m.float()) * w.float()[:, None]).reshape(
            shape)
        num = (sigma * bh.float()).sum(dim=-2)
        return (num / (sigma.sum(dim=-2) + self.soft_eps)).to(m.dtype)

    def pair_stage(self, x: torch.Tensor, e: torch.Tensor,
                   dense: DenseWiring,
                   lg_weight: Optional[torch.Tensor] = None):
        """L-stage on the dense layout (JAX ``_dense_pair_lstage``).

        The L(g) nodes are g's edges (x: [N*D, F] in D-blocks by dst);
        the L-edges are the local pairs (e: [N*D*D, F], rows (j, t, s)).
        m2 = sg[j,s] + dg[rev[j*D+t]] + edge_gate(e), masked by lg_mask,
        aggregated over s by K4 into rows (j, t), which rev maps back to
        the edge rev[j*D+t].  As in JAX the edge tail normalises the
        mask-folded m2 (only masked pair rows see the shift).

        With `lg_weight` the aggregation is the weighted sums over s
        (plain sums, as in JAX).  With ``ALIGNN_TPU_FUSED_LSTAGE`` set (the
        JAX package's own switch, read per call as JAX reads it) a
        LayerNorm stage without weights runs fused instead; a BatchNorm or
        weighted stage stays here, as in JAX.  With
        ``ALIGNN_TPU_FP8_LTABLES`` set the edge output (the [L, F] stream
        into the next layer) goes through the e4m3 round trip here, not on
        the fused path, as in JAX.
        """
        if self.norm == "layernorm" and lg_weight is None and \
                os.environ.get("ALIGNN_TPU_FUSED_LSTAGE"):
            return self._fused_pair_stage(x, e, dense)
        f, D = self.features, dense.D
        n = x.shape[0] // D
        sg = self.src_gate(x)
        dg_r = permute_rows(self.dst_gate(x), dense.rev, dense.rev)
        bh = self.dst_update(x)
        m2 = (sg.reshape(n, 1, D, f) + dg_r.reshape(n, D, 1, f)).reshape(
            -1, f) + self.edge_gate(e)
        m2 = fold_mask(m2, dense.lg_mask)
        if lg_weight is None:
            h_jt = dense_pair_aggregate(m2, bh, D)
        else:
            h_jt = self._weighted_sums(m2, lg_weight, bh.reshape(
                n, 1, D, f), (n, D, D, f)).reshape(n * D, f)
        h = permute_rows(h_jt, dense.rev, dense.rev)
        x_new = x + F.silu(self.norm_nodes(self.src_update(x) + h,
                                           dense.edge_mask))
        e_new = e + F.silu(self.norm_edges(m2, dense.lg_mask))
        if fp8_ltables_enabled():
            e_new = fp8_round_trip(e_new)
        return x_new, e_new

    def _fused_pair_stage(self, x, e, dense: DenseWiring):
        """The fused L-stage (JAX ``_fused_dense_lstage``): edge_gate, the
        gates, the aggregation and the edge tail in K6, its backward K7.

        The edge mask of g folds into both sg and dg, which masks pair
        (t, s) iff lg_mask does (rev maps real edges to real edges).  It
        reads edge_gate and norm_edges, so one state dict drives both
        paths.
        """
        sg_f = fold_mask(self.src_gate(x), dense.edge_mask)
        dg_f = permute_rows(fold_mask(self.dst_gate(x), dense.edge_mask),
                            dense.rev, dense.rev)
        e_new, h_jt = fused_pair_lstage(
            e, self.edge_gate.weight.t(), self.edge_gate.bias, sg_f, dg_f,
            self.dst_update(x), self.norm_edges.weight, self.norm_edges.bias,
            dense.D)
        h = permute_rows(h_jt, dense.rev, dense.rev)
        x_new = x + F.silu(self.norm_nodes(self.src_update(x) + h))
        return x_new, e_new


class ALIGNNConv(nn.Module):
    """One ALIGNN layer: EGGC on g, then EGGC on L(g).  On the sparse
    layout with ``ALIGNN_TPU_FP8_LTABLES`` set the [L, F] output z goes
    through the e4m3 round trip (the dense layout's twin is in
    :meth:`EdgeGatedGraphConv.pair_stage`)."""

    def __init__(self, features: int, norm: str = "layernorm",
                 soft_eps: float = 1e-6,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.node_update = EdgeGatedGraphConv(features, norm, soft_eps, dtype)
        self.edge_update = EdgeGatedGraphConv(features, norm, soft_eps, dtype)

    def forward(self, x, y, z, g: Incidence, lg: Optional[Incidence],
                dense: Optional[DenseWiring] = None,
                windows: Tuple[int, int, int] = (0, 0, 0),
                lg_windows: Tuple[int, int, int] = (0, 0, 0),
                edge_weight: Optional[torch.Tensor] = None,
                lg_weight: Optional[torch.Tensor] = None,
                masks: Tuple[Optional[torch.Tensor], ...] = (None,) * 3):
        """`edge_weight` [E] weighs the node stage's edges, `lg_weight`
        [L] the line-graph stage's (soft weights).  `masks` = (node, edge,
        lg) row masks, read by BatchNorm tails."""
        node_mask, edge_mask, lg_mask = masks
        if dense is not None:
            # the dense L-stage is local pairs wired by rev: it reads no
            # line-graph index arrays
            x, m = self.node_update(x, y, g, dense, edge_weight=edge_weight,
                                    node_mask=node_mask)
            y, z = self.edge_update.pair_stage(m, z, dense, lg_weight)
            return x, y, z
        x, m = self.node_update(x, y, g, windows=windows,
                                edge_weight=edge_weight,
                                node_mask=node_mask, edge_mask=edge_mask)
        y, z = self.edge_update(m, z, lg, windows=lg_windows,
                                edge_weight=lg_weight,
                                node_mask=edge_mask, edge_mask=lg_mask)
        if fp8_ltables_enabled():
            z = fp8_round_trip(z)
        return x, y, z
