"""The ALIGNN property model and the ALIGNN-FF model with its E/F/S forward.

Counterpart of ``alignn_tpu/nn/models.py`` for ``ALIGNN`` (the property
model: masked BatchNorm, a graph-level head with a link function or a
classifier) and ``ALIGNNAtomWise`` (the force field, LayerNorm), on the
sparse and the dense-neighbourhood layouts (a batch with
``dense_D > 0``, graph/dense.py).  Both share the embedding stack and
the trunk.  Angle cosines are recomputed from the bond vectors `r`
inside the forward, so the force field's gradient of the energy with
respect to `r` carries the 3-body terms; forces and the virial stress come from that
gradient (:func:`atomwise_forward`), or with ``include_pos_deriv`` from
the gradient with respect to the atom positions.  Envelope-weighted
models (``envelope_edge_weights``) weigh every aggregation by a smooth
envelope of the bond lengths (:func:`envelope_weights`), sparse layout
only.  A model with ``extra_features`` reads per-structure features
(``batch.extra_features``) into its output head
(:func:`extra_features_head`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from alignn_tpu_torch.graph.batch import GraphBatch
from alignn_tpu_torch.nn.layers import (ALIGNNConv, Dense, DenseWiring,
                                        EdgeGatedGraphConv, MaskedBatchNorm,
                                        MaskedLayerNorm, MLPLayer,
                                        RBFExpansion, set_batchnorm_group)
from alignn_tpu_torch.ops.basis import (bond_cosines, bond_cosines_dense,
                                        cutoff_function_based_edges)
from alignn_tpu_torch.ops.eggc import SOFT_AGG_EPS, gather_nodes, \
    permute_rows, sorted_gather
from alignn_tpu_torch.ops.gather import windows_enabled
from alignn_tpu_torch.ops.segment import graph_readout_mean, segment_sum

EV_A3_TO_GPA = 160.21766208  # 1 eV/Angstrom^3 in GPa


@dataclasses.dataclass(frozen=True)
class ALIGNNConfig:
    """Hyperparameters of the property model (same fields as the JAX
    package)."""

    name: str = "alignn"
    alignn_layers: int = 4
    gcn_layers: int = 4
    atom_input_features: int = 92
    edge_input_features: int = 80
    triplet_input_features: int = 40
    embedding_features: int = 64
    hidden_features: int = 256
    output_features: int = 1
    link: str = "identity"  # identity | log | logit
    zero_inflated: bool = False
    classification: bool = False
    num_classes: int = 2
    extra_features: int = 0
    remat_layers: bool = False

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ALIGNNConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass(frozen=True)
class ALIGNNAtomWiseConfig:
    """Hyperparameters of the FF model (same fields as the JAX package)."""

    name: str = "alignn_atomwise"
    alignn_layers: int = 4
    gcn_layers: int = 4
    atom_input_features: int = 92
    edge_input_features: int = 80
    triplet_input_features: int = 40
    embedding_features: int = 64
    hidden_features: int = 256
    output_features: int = 1
    grad_multiplier: float = -1.0
    calculate_gradient: bool = True
    atomwise_output_features: int = 0
    graphwise_weight: float = 1.0
    gradwise_weight: float = 1.0
    stresswise_weight: float = 0.0
    atomwise_weight: float = 0.0
    link: str = "identity"
    zero_inflated: bool = False
    classification: bool = False
    force_mult_natoms: bool = False
    energy_mult_natoms: bool = True
    include_pos_deriv: bool = False
    use_cutoff_function: bool = False
    inner_cutoff: float = 3.0
    stress_multiplier: float = 1.0
    add_reverse_forces: bool = True
    lg_on_fly: bool = True
    batch_stress: bool = True
    multiply_cutoff: bool = False
    use_penalty: bool = True
    extra_features: int = 0
    exponent: int = 5
    penalty_factor: float = 0.1
    penalty_threshold: float = 1.0
    additional_output_features: int = 0
    additional_output_weight: float = 0.0
    remat_layers: bool = False
    envelope_edge_weights: bool = False
    envelope_cutoff: float = 0.0

    def __post_init__(self):
        if self.gradwise_weight == 0:
            object.__setattr__(self, "calculate_gradient", False)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ALIGNNAtomWiseConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def _link_init_bias(link: str):
    """The output bias a link function starts from (None: the default
    draw): log(0.7) for the log link, the reference's average band gap."""
    if link == "log":
        return float(math.log(0.7))
    return None


def _init_link_bias(model: nn.Module):
    """Set ``fc.bias`` to the link's start value, where it has one (not
    for classification, whose head JAX builds without it)."""
    cfg = model.cfg
    value = None if cfg.classification or cfg.extra_features \
        else _link_init_bias(cfg.link)
    if value is not None:
        with torch.no_grad():
            model.fc.bias.fill_(value)


def _apply_link(out: torch.Tensor, link: str) -> torch.Tensor:
    if link == "log":
        return torch.exp(out)
    if link == "logit":
        return torch.sigmoid(out)
    return out


class _Embeddings(nn.Module):
    """Atom / bond / angle embedding stack; BatchNorm statistics count the
    node, edge and line-graph masks' rows.  `dtype` is the MLPs' compute
    dtype (the RBF expansions stay f32)."""

    def __init__(self, cfg, norm: str = "layernorm",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        hid, emb = cfg.hidden_features, cfg.embedding_features
        kw = dict(norm=norm, dtype=dtype)
        self.atom_embedding = MLPLayer(cfg.atom_input_features, hid, **kw)
        self.edge_rbf = RBFExpansion(0.0, 8.0, cfg.edge_input_features)
        self.edge_embedding_0 = MLPLayer(cfg.edge_input_features, emb, **kw)
        self.edge_embedding_1 = MLPLayer(emb, hid, **kw)
        self.angle_rbf = RBFExpansion(-1.0, 1.0, cfg.triplet_input_features)
        self.angle_embedding_0 = MLPLayer(cfg.triplet_input_features, emb,
                                          **kw)
        self.angle_embedding_1 = MLPLayer(emb, hid, **kw)

    def forward(self, batch: GraphBatch, bondlength, cosines,
                edge_scale=None):
        x = self.atom_embedding(batch.atom_features, batch.node_mask)
        y = self.edge_embedding_1(self.edge_embedding_0(
            self.edge_rbf(bondlength), batch.edge_mask), batch.edge_mask)
        if edge_scale is not None:
            y = y * edge_scale[:, None]
        z = self.angle_embedding_1(self.angle_embedding_0(
            self.angle_rbf(cosines), batch.lg_mask), batch.lg_mask)
        return x, y, z


class _Trunk(nn.Module):
    """ALIGNN conv stack + GCN stack.  Soft aggregation weights divide by
    their sum plus 1e-3 in an envelope-weighted model and 1e-6 otherwise
    (eALIGNN's inner-cutoff masks), as in JAX.  With ``remat_layers``
    each layer runs under :func:`remat` (JAX's per-layer ``nn.remat``)."""

    def __init__(self, cfg, norm: str = "layernorm",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.alignn_layers = cfg.alignn_layers
        self.gcn_layers = cfg.gcn_layers
        self.remat = bool(getattr(cfg, "remat_layers", False))
        eps = SOFT_AGG_EPS if getattr(cfg, "envelope_edge_weights", False) \
            else 1e-6
        for i in range(cfg.alignn_layers):
            setattr(self, f"alignn_layers_{i}",
                    ALIGNNConv(cfg.hidden_features, norm, eps, dtype))
        for i in range(cfg.gcn_layers):
            setattr(self, f"gcn_layers_{i}",
                    EdgeGatedGraphConv(cfg.hidden_features, norm, eps, dtype))

    def forward(self, batch: GraphBatch, x, y, z, edge_weight=None,
                lg_weight=None, edge_mask=None, lg_mask=None):
        """`edge_mask` / `lg_mask` stand in for the batch's masks where
        the layers read them (eALIGNN passes its inner-cutoff masks)."""
        edge_mask = batch.edge_mask if edge_mask is None else edge_mask
        lg_mask = batch.lg_mask if lg_mask is None else lg_mask
        dense = DenseWiring(batch.dense_D, edge_mask, lg_mask,
                            batch.rev) if batch.dense_D else None
        # the batch's static gather windows, read with the switch as JAX
        # reads it (a dense batch's are 0)
        if windows_enabled():
            wins = (batch.win_src, batch.win_dst, batch.win_src_sorted)
            lg_wins = (batch.win_lg_src, batch.win_lg_dst,
                       batch.win_lg_src_sorted)
        else:
            wins = lg_wins = (0, 0, 0)
        masks = (batch.node_mask, edge_mask, lg_mask)
        run = remat if self.remat else _call
        for i in range(self.alignn_layers):
            x, y, z = run(getattr(self, f"alignn_layers_{i}"),
                          x, y, z, batch.g_index, batch.lg_index, dense, wins,
                          lg_wins, edge_weight, lg_weight, masks)
        for i in range(self.gcn_layers):
            x, y = run(getattr(self, f"gcn_layers_{i}"),
                       x, y, batch.g_index, dense, wins, edge_weight,
                       batch.node_mask, edge_mask)
        return x, y


def _call(layer: nn.Module, *args):
    return layer(*args)


def remat(layer: nn.Module, *args):
    """``layer(*args)`` keeping only its inputs for the backward, which
    runs the layer again (JAX's ``nn.remat`` per layer, as
    ``torch.utils.checkpoint`` without reentry, so the force loss's
    gradient of a gradient goes through it).  Only the first run moves
    BatchNorm running statistics: JAX's functional remat moves them once
    a step, and the recompute (once for each backward that passes the
    layer) must not move them again."""
    runs = []

    def run(*a):
        runs.append(1)
        if len(runs) == 1:
            return layer(*a)
        norms = [m for m in layer.modules() if isinstance(m, MaskedBatchNorm)]
        for m in norms:
            m.update_stats = False
        try:
            return layer(*a)
        finally:
            for m in norms:
                m.update_stats = True

    return checkpoint(run, *args, use_reentrant=False)


def add_extra_features_head(model: nn.Module, cfg, norm: str,
                            dtype: Optional[torch.dtype] = None):
    """The submodules of Gong et al.'s extra-features head on `model`
    itself, under the flax names: ``extra_feature_embedding`` (an MLP
    over the Fx per-structure features), then ``fc1`` and ``fc2`` (MLPs
    over the readout concatenated with it, in the compute dtype) and the
    ``fc3`` Dense (no dtype: it promotes, as in JAX)."""
    fx = cfg.extra_features
    width = cfg.hidden_features + fx
    model.extra_feature_embedding = MLPLayer(fx, fx, norm, dtype)
    model.fc1 = MLPLayer(width, width, norm, dtype)
    model.fc2 = MLPLayer(width, width, norm, dtype)
    model.fc3 = Dense(width, cfg.output_features)


def extra_features_head(model: nn.Module, h: torch.Tensor,
                        batch: GraphBatch) -> torch.Tensor:
    """[G, output_features] from the readout `h` and the batch's
    per-structure features (JAX ``extra_features_head``); BatchNorm
    statistics count the rows of ``graph_mask``."""
    gm = batch.graph_mask
    feats = model.extra_feature_embedding(batch.extra_features, gm)
    hh = model.fc1(torch.cat([h, feats], dim=1), gm)
    return model.fc3(model.fc2(hh, gm))


class ALIGNN(nn.Module):
    """Property model (BatchNorm flavour): ``forward(batch)`` returns
    [G, output_features] through the link function, or for classification
    [G, num_classes] log-probabilities; slot G-1 is the trash slot.

    BatchNorm follows the module's mode: ``model.train()`` normalises by
    the batch's masked statistics and moves the running ones, once per
    forward; ``model.eval()`` normalises by the running statistics.

    `dtype` is the compute dtype of the embeddings and the trunk (JAX's
    ``dtype``; None or float32 for f32, bfloat16, float16); the output
    head computes in f32.  The parameters stay f32.  `group` (JAX's
    ``axis_name``) is the process group over which the BatchNorm layers
    reduce their batch statistics in data-parallel training (None: this
    rank's batch).
    """

    def __init__(self, cfg: ALIGNNConfig,
                 dtype: Optional[torch.dtype] = None, group=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embeddings = _Embeddings(cfg, "batchnorm", dtype)
        self.trunk = _Trunk(cfg, "batchnorm", dtype)
        if cfg.extra_features:
            add_extra_features_head(self, cfg, "batchnorm", dtype)
        else:
            self.fc = Dense(cfg.hidden_features, cfg.num_classes
                            if cfg.classification else cfg.output_features)
            _init_link_bias(self)
        set_batchnorm_group(self, group)

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        cfg = self.cfg
        bondlength = torch.linalg.norm(batch.r, dim=1)
        cosines = bond_cosines_dense(batch.r, batch.dense_D) \
            if batch.dense_D else \
            bond_cosines(batch.r, batch.lg_src, batch.lg_dst)
        x, y, z = self.embeddings(batch, bondlength, cosines)
        x, _y = self.trunk(batch, x, y, z)
        h = graph_readout_mean(x, batch.node_graph, batch.n_nodes)
        out = _apply_link(extra_features_head(self, h, batch)
                          if cfg.extra_features else self.fc(h), cfg.link)
        if cfg.classification:
            out = torch.log_softmax(out, dim=1)
        return out


class ALIGNNAtomWise(nn.Module):
    """FF model core.  ``forward(batch, r)`` takes the bond vectors so that
    callers can differentiate the energy with respect to them.

    Returns a dict with `out` [G, T], `en_out` [G] (energy entering the
    force computation, incl. natoms multiplication and the short-bond
    penalty), `atomwise_pred` [N, A], `additional` [G, Fadd] and
    `bondlength` [E].  `dtype` as in :class:`ALIGNN`: the heads compute
    in f32, so the energy, forces and stress are f32.  `group` is taken as
    JAX's ``axis_name`` is; the model's norms are LayerNorms, which reduce
    nothing across ranks.
    """

    def __init__(self, cfg: ALIGNNAtomWiseConfig,
                 dtype: Optional[torch.dtype] = None, group=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embeddings = _Embeddings(cfg, dtype=dtype)
        self.trunk = _Trunk(cfg, dtype=dtype)
        add_atomwise_heads(self, cfg, dtype=dtype)
        set_batchnorm_group(self, group)

    def forward(self, batch: GraphBatch, r: torch.Tensor):
        cfg = self.cfg
        bondlength = torch.linalg.norm(r, dim=1)
        cosines = bond_cosines_dense(r, batch.dense_D) if batch.dense_D \
            else bond_cosines(r, batch.lg_src, batch.lg_dst)
        edge_scale = None
        rbf_input = bondlength
        if cfg.use_cutoff_function:
            envelope = cutoff_function_based_edges(
                bondlength, inner_cutoff=cfg.inner_cutoff,
                exponent=cfg.exponent)
            if cfg.multiply_cutoff:
                edge_scale = envelope   # y = embedding(bondlength) * env
            else:
                rbf_input = envelope    # bondlength replaced by env
        x, y, z = self.embeddings(batch, rbf_input, cosines, edge_scale)
        edge_w = lg_w = None
        if cfg.envelope_edge_weights:
            edge_w, lg_w = envelope_weights(cfg, batch, bondlength)
        x, _y = self.trunk(batch, x, y, z, edge_w, lg_w)
        return atomwise_heads(self, batch, x, bondlength)


def envelope_weights(cfg: ALIGNNAtomWiseConfig, batch: GraphBatch,
                     bondlength: torch.Tensor):
    """The aggregation weights of an envelope-weighted model: the smooth
    envelope at the graph cutoff on each bond, edge_w [E], and on each
    bond pair the product of its two bonds' weights, lg_w [L].  Both are
    differentiable in r, so the forces carry d(envelope)/dr, and a bond
    crossing the cutoff leaves the energy continuous.  The pair gathers
    transpose into K2 (sorted dst, argsorted src)."""
    if cfg.envelope_cutoff <= 0:
        raise ValueError(
            "envelope_edge_weights requires envelope_cutoff > 0 "
            "(set it to the graph-build cutoff)")
    if batch.dense_D:
        raise ValueError(
            "envelope_edge_weights runs the sparse layout (the "
            "dense pair kernels take binary masks, not soft "
            "weights); build with dense_neighborhoods=false")
    # evaluated in f64: the polynomial's terms (up to 35 x^6 at exponent
    # 5) cancel towards its triple root at the cutoff, and in f32 that
    # rounding alone moves the forces of Si_envelope as far as the
    # serving tolerance against the reference package
    edge_w = cutoff_function_based_edges(
        bondlength.double(), inner_cutoff=cfg.envelope_cutoff,
        exponent=cfg.exponent).to(bondlength.dtype) * batch.edge_mask
    lg, col = batch.lg_index, edge_w[:, None]
    w_src = gather_nodes(col, lg.src, lg.src_perm, lg.src_perm_inv,
                         lg.src_sorted)
    w_dst = sorted_gather(col, lg.dst)
    return edge_w, (w_src * w_dst)[:, 0] * batch.lg_mask


def init_parameters(model: nn.Module,
                    generator: torch.Generator) -> nn.Module:
    """Redraw every parameter from `generator` (a CPU generator, so the
    draws do not depend on the device) with the modules' default laws:
    Dense weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)) as
    ``nn.Linear`` draws them, norm scale 1 and bias 0 (BatchNorm running
    mean 0 and variance 1), and the output bias of a log link log(0.7),
    as JAX initialises it."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                for p in (m.weight, m.bias):
                    p.copy_(torch.empty(p.shape).uniform_(
                        -bound, bound, generator=generator))
            elif isinstance(m, (MaskedLayerNorm, MaskedBatchNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, MaskedBatchNorm):
                    m.mean.zero_()
                    m.var.fill_(1.0)
    if hasattr(model, "cfg"):
        _init_link_bias(model)
    return model


def add_atomwise_heads(model: nn.Module, cfg, fc_out=None,
                       dtype: Optional[torch.dtype] = None):
    """The output heads of a force field on `model` (JAX
    ``atomwise_heads``'s submodules): ``fc`` (`fc_out` wide, by default 1
    for a classifier and else ``output_features``) or the extra-features
    head, then ``fc_additional_output`` and ``fc_atomwise`` where asked
    for.  The Dense heads have no compute dtype (they promote to f32, as
    in JAX); the extra-features head's MLPs take `dtype`."""
    hid = cfg.hidden_features
    if cfg.extra_features:
        add_extra_features_head(model, cfg, "layernorm", dtype)
    else:
        if fc_out is None:
            fc_out = 1 if cfg.classification else cfg.output_features
        model.fc = Dense(hid, fc_out)
        _init_link_bias(model)
    if cfg.additional_output_features > 0:
        model.fc_additional_output = Dense(
            hid, cfg.additional_output_features)
    if cfg.atomwise_output_features > 0:
        model.fc_atomwise = Dense(hid, cfg.atomwise_output_features)


def atomwise_heads(model: nn.Module, batch: GraphBatch,
                   x: torch.Tensor, bondlength: torch.Tensor,
                   classify=torch.sigmoid, edge_group=None,
                   node_group=None) -> Dict[str, torch.Tensor]:
    """Readout, output heads, penalty and the energy `en_out`; a
    classifier's output goes through `classify`.

    Under graph parallelism (JAX's ``edge_axis``/``node_axis``) the
    bond lengths are this rank's shard and `edge_group` sums the penalty
    over the ranks; with `node_group` the node table `x` is a shard too,
    the per-graph sums of the readout are summed over the ranks, and
    ``atomwise_pred`` stays a shard."""
    cfg = model.cfg
    if node_group is not None:
        from alignn_tpu_torch.parallel.mesh import all_reduce_sum

        sums = all_reduce_sum(segment_sum(x, batch.node_graph,
                                          batch.n_nodes.shape[0]),
                              node_group)
        h = sums / torch.clamp_min(batch.n_nodes, 1.0)[:, None]
    else:
        h = graph_readout_mean(x, batch.node_graph, batch.n_nodes)
    out = extra_features_head(model, h, batch) if cfg.extra_features \
        else model.fc(h)
    result: Dict[str, torch.Tensor] = {}
    if cfg.additional_output_features > 0:
        result["additional"] = model.fc_additional_output(h)
    else:
        result["additional"] = out.new_zeros((h.shape[0], 1))
    if cfg.atomwise_output_features > 0:
        result["atomwise_pred"] = model.fc_atomwise(x)
    else:
        result["atomwise_pred"] = out.new_zeros((x.shape[0], 1))

    en_out = out[:, 0] if cfg.output_features == 1 else out.sum(dim=1)
    if cfg.energy_mult_natoms:
        en_out = en_out * batch.n_nodes
    if cfg.use_penalty:
        penalties = torch.where(
            bondlength < cfg.penalty_threshold,
            cfg.penalty_factor * (cfg.penalty_threshold - bondlength),
            torch.zeros_like(bondlength)) * batch.edge_mask
        # the reference adds the batch-total penalty to every graph's
        # energy -- kept as is
        total = penalties.sum()
        if edge_group is not None:
            from alignn_tpu_torch.parallel.mesh import all_reduce_sum

            total = all_reduce_sum(total, edge_group)
        en_out = en_out + total

    out = _apply_link(out, cfg.link)
    if cfg.classification:
        out = classify(out)
    result["out"] = out
    result["en_out"] = en_out
    result["bondlength"] = bondlength
    return result


def compute_cartesian_r(batch: GraphBatch, frac_coords=None) -> torch.Tensor:
    """Bond vectors from fractional coords + lattice:
    r_e = cart(dst) + images_e @ lattice - cart(src); padded edges get the
    unit-x pad displacement so their norm stays differentiable."""
    frac = batch.frac_coords if frac_coords is None else frac_coords
    cart = torch.einsum("ni,nij->nj", frac, batch.lattice[batch.node_graph])
    img_cart = torch.einsum("ei,eij->ej", batch.images,
                            batch.lattice[batch.edge_graph])
    r = cart[batch.dst] + img_cart - cart[batch.src]
    mask = batch.edge_mask[:, None]
    pad_r = torch.zeros_like(r)
    pad_r[:, 0] = 1.0
    return r * mask + pad_r * (1.0 - mask)


def atomwise_forward(model: ALIGNNAtomWise, batch: GraphBatch,
                     create_graph: bool = False) -> Dict[str, torch.Tensor]:
    """Energy, forces and stress: forces and the virial come from the
    gradient of the summed energy with respect to the bond vectors.

      pair_forces = grad_multiplier * dE/dr
      forces_i    = sum_{e: dst=i} pf_e - sum_{e: src=i} pf_e
      stress_g    = -stress_mult * 160.2177 * (r_g^T pf_g) / V_g

    Serving passes ``create_graph=False``.  A training step passes True:
    its loss holds the forces and stress, so its backward runs through
    this gradient (the second order of every op of the model).  The
    stress reads ``batch.r``, a constant, as the JAX function does.
    """
    cfg = model.cfg
    num_graphs = batch.graph_mask.shape[0]
    if not cfg.calculate_gradient:
        res = model(batch, batch.r)
        res["grad"] = batch.r.new_zeros((batch.z.shape[0], 3))
        res["stresses"] = batch.r.new_zeros((num_graphs, 3, 3))
        return res
    if cfg.include_pos_deriv:
        return _pos_deriv_forward(model, batch, create_graph)

    r = batch.r.detach().requires_grad_(True)
    with torch.enable_grad():
        res = model(batch, r)
        energy = torch.sum(res["en_out"] * batch.graph_mask)
        (g_r,) = torch.autograd.grad(energy, r, create_graph=create_graph)
    res["grad"], res["stresses"] = forces_and_stress(cfg, batch, g_r)
    return res


def forces_and_stress(cfg: ALIGNNAtomWiseConfig, batch: GraphBatch,
                      g_r: torch.Tensor):
    """(forces [N, 3], stress [G, 3, 3]) from g_r = dE/dr: the linear
    force assembly and virial of :func:`atomwise_forward`."""
    num_graphs = batch.graph_mask.shape[0]
    pair_forces = cfg.grad_multiplier * g_r
    if cfg.force_mult_natoms:
        pair_forces = pair_forces * batch.n_nodes.sum()

    num_nodes = batch.z.shape[0]
    if batch.dense_D:
        # dense layout: the in-edges of node i are block i, its out-edges
        # the rev of block i, so both sums are block sums
        D = batch.dense_D
        forces = pair_forces.reshape(num_nodes, D, 3).sum(dim=1)
        if cfg.add_reverse_forces:
            pf_rev = permute_rows(pair_forces, batch.rev, batch.rev)
            forces = forces - pf_rev.reshape(num_nodes, D, 3).sum(dim=1)
    else:
        forces = segment_sum(pair_forces, batch.dst, num_nodes)
        if cfg.add_reverse_forces:
            forces = forces - segment_sum(pair_forces, batch.src, num_nodes)

    if cfg.stresswise_weight != 0:
        outer = torch.einsum("ei,ej->eij", batch.r, pair_forces)
        per_graph = segment_sum(outer, batch.edge_graph, num_graphs)
        div = 1.0 if cfg.batch_stress else 2.0
        stress = (-cfg.stress_multiplier * EV_A3_TO_GPA * per_graph
                  / (div * torch.clamp_min(batch.volume, 1e-12)
                     [:, None, None]))
    else:
        stress = batch.r.new_zeros((num_graphs, 3, 3))
    return forces, stress


def _pos_deriv_forward(model: ALIGNNAtomWise, batch: GraphBatch,
                       create_graph: bool) -> Dict[str, torch.Tensor]:
    """``include_pos_deriv``: forces from the gradient with respect to the
    fractional coordinates, mapped to cartesian by inv(lattice)^T per
    node.  As in the JAX package (after the reference) the energy it
    differentiates is multiplied by the batch's total node count, and the
    stress is zero."""
    cfg = model.cfg
    frac = batch.frac_coords.detach().requires_grad_(True)
    with torch.enable_grad():
        res = model(batch, compute_cartesian_r(batch, frac))
        energy = torch.sum(res["en_out"] * batch.graph_mask) \
            * batch.n_nodes.sum()
        (g_frac,) = torch.autograd.grad(energy, frac,
                                        create_graph=create_graph)
    # inv_ex: the values of inv, without its check on the host (a sync
    # that a captured train step may not make)
    inv_lat = torch.linalg.inv_ex(batch.lattice)[0][batch.node_graph]
    g_cart = torch.einsum("ni,nji->nj", g_frac, inv_lat)
    res["grad"] = cfg.grad_multiplier * g_cart * batch.node_mask[:, None]
    res["stresses"] = batch.r.new_zeros((batch.graph_mask.shape[0], 3, 3))
    return res
