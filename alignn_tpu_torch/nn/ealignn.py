"""eALIGNN: the force field that recomputes its bonds inside the forward.

Counterpart of ``alignn_tpu/nn/ealignn.py``:

- the bond vectors are recomputed from the fractional coordinates and
  the lattice (:func:`~alignn_tpu_torch.nn.models.compute_cartesian_r`),
  so the same graph indices serve a moved geometry;
- bonds longer than ``inner_cutoff`` are pruned as masks:
  ``keep`` = (bondlength <= inner_cutoff) * edge_mask weighs every
  aggregation on g, and ``lg_keep`` = keep[lg_src] * keep[lg_dst] every
  aggregation on L(g).  The weights divide by their sum plus 1e-6, so a
  pruned bond leaves both sums, and they take the layers' soft-weight
  branches (K2 on the sparse layout, plain sums on the dense one), never
  K1, K3, K4 or the fused L-stage;
- energy and forces come from one backward over the fractional
  coordinates and over ``delta`` = 0 added to r (:func:`ealignn_forward`);
  the forces are multiplied by the batch's total node count and,
  optionally, lose their net torque per graph (:func:`remove_net_torque`).

The parameter tree is flat, as JAX's: ``atom_embedding``,
``edge_embedding_0/1``, ``angle_embedding_0/1``, ``alignn_layers_i``,
``gcn_layers_i`` and the output heads sit on the model itself.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from alignn_tpu_torch.graph.batch import GraphBatch
from alignn_tpu_torch.nn.layers import set_batchnorm_group
from alignn_tpu_torch.nn.models import (EV_A3_TO_GPA, _Embeddings, _Trunk,
                                        add_atomwise_heads, atomwise_heads,
                                        compute_cartesian_r)
from alignn_tpu_torch.ops.basis import bond_cosines, bond_cosines_dense
from alignn_tpu_torch.ops.segment import segment_sum


@dataclasses.dataclass(frozen=True)
class eALIGNNAtomWiseConfig:
    """Hyperparameters of eALIGNN (the same fields and defaults as the JAX
    package)."""

    name: str = "ealignn_atomwise"
    alignn_layers: int = 2
    gcn_layers: int = 2
    atom_input_features: int = 92
    edge_input_features: int = 80
    triplet_input_features: int = 40
    embedding_features: int = 64
    hidden_features: int = 64
    output_features: int = 1
    calculate_gradient: bool = True
    atomwise_output_features: int = 0
    graphwise_weight: float = 1.0
    gradwise_weight: float = 1.0
    stresswise_weight: float = 0.0
    atomwise_weight: float = 0.0
    classification: bool = False
    energy_mult_natoms: bool = True
    remove_torque: bool = True
    inner_cutoff: float = 4.0
    use_penalty: bool = True
    extra_features: int = 0
    penalty_factor: float = 0.1
    penalty_threshold: float = 1.0
    additional_output_features: int = 0
    additional_output_weight: float = 0.0
    stress_multiplier: float = 1.0
    grad_multiplier: float = -1.0
    link: str = "identity"
    zero_inflated: bool = False
    force_mult_natoms: bool = False
    include_pos_deriv: bool = False
    use_cutoff_function: bool = False
    add_reverse_forces: bool = True
    lg_on_fly: bool = True
    batch_stress: bool = True
    multiply_cutoff: bool = False
    exponent: int = 5

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "eALIGNNAtomWiseConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def remove_net_torque(cart: torch.Tensor, forces: torch.Tensor,
                      node_graph: torch.Tensor, node_mask: torch.Tensor,
                      n_nodes: torch.Tensor) -> torch.Tensor:
    """`forces` less the least-norm correction r x mu that zeroes each
    graph's net torque about its centre of mass: (S - s I + 1e-8 I) mu =
    -tau per graph, S the sum of r r^T and s of |r|^2 (one batched 3x3
    solve; the ridge keeps an empty or one-atom graph solvable)."""
    g = n_nodes.shape[0]
    w = node_mask[:, None]
    com = segment_sum(cart * w, node_graph, g) / \
        torch.clamp_min(n_nodes, 1.0)[:, None]
    r = (cart - com[node_graph]) * w
    tau = segment_sum(torch.cross(r, forces * w, dim=1), node_graph, g)
    s = segment_sum((r * r).sum(dim=1, keepdim=True) * w, node_graph,
                    g)[:, 0]
    big_s = segment_sum(torch.einsum("ni,nj->nij", r, r) * w[:, :, None],
                        node_graph, g)
    eye = torch.eye(3, dtype=cart.dtype, device=cart.device)
    m = big_s - s[:, None, None] * eye + 1e-8 * eye
    # solve_ex: solve's values without its host-side check (no sync)
    mu = torch.linalg.solve_ex(m, -tau[..., None])[0][..., 0]
    return forces + torch.cross(r, mu[node_graph], dim=1) * w


def _log_softmax(out: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(out, dim=1)


class eALIGNNAtomWise(nn.Module):
    """eALIGNN (LayerNorm).  ``forward(batch, frac_coords, r=None)``
    recomputes the bond vectors from `frac_coords` (default the batch's)
    unless `r` is given, and returns the dict of
    :func:`~alignn_tpu_torch.nn.models.atomwise_heads` with ``r`` and
    ``keep`` besides.  `dtype` is the compute dtype of the embeddings and
    the trunk, as in :class:`~alignn_tpu_torch.nn.models.ALIGNNAtomWise`;
    the weighted sums stay f32 whatever it is, as in JAX.  JAX's eALIGNN
    has no per-layer remat, and neither has this one.  `group` is taken as
    JAX's ``axis_name`` is (LayerNorm: nothing reduces across ranks)."""

    def __init__(self, cfg: eALIGNNAtomWiseConfig,
                 dtype: Optional[torch.dtype] = None, group=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        for part in (_Embeddings(cfg, dtype=dtype), _Trunk(cfg, dtype=dtype)):
            for name, module in part.named_children():
                setattr(self, name, module)
        self.alignn_layers = cfg.alignn_layers
        self.gcn_layers = cfg.gcn_layers
        self.remat = False
        add_atomwise_heads(self, cfg, fc_out=cfg.output_features,
                           dtype=dtype)
        set_batchnorm_group(self, group)

    def forward(self, batch: GraphBatch, frac_coords=None, r=None):
        cfg = self.cfg
        if r is None:
            r = compute_cartesian_r(batch, frac_coords)
        bondlength = torch.linalg.norm(r, dim=1)
        keep = (bondlength <= cfg.inner_cutoff).to(r.dtype) * batch.edge_mask
        lg_keep = keep[batch.lg_src] * keep[batch.lg_dst] * batch.lg_mask
        cosines = bond_cosines_dense(r, batch.dense_D) if batch.dense_D \
            else bond_cosines(r, batch.lg_src, batch.lg_dst)
        # the flat tree holds the submodules these two read
        x, y, z = _Embeddings.forward(self, batch, bondlength, cosines)
        x, _y = _Trunk.forward(self, batch, x, y, z, keep, lg_keep, keep,
                               lg_keep)
        res = atomwise_heads(self, batch, x, bondlength,
                             classify=_log_softmax)
        res["r"] = r
        res["keep"] = keep
        return res


def ealignn_forward(model: eALIGNNAtomWise, batch: GraphBatch,
                    create_graph: bool = False) -> Dict[str, torch.Tensor]:
    """Energy, forces and stress of eALIGNN, as JAX's ``ealignn_forward``.

    One backward of the summed energy over the fractional coordinates and
    over ``delta`` = 0 added to the recomputed r gives both gradients:
    forces = -dE/dfrac inv(lattice)^T x (the batch's total node count),
    torque removed per graph with ``remove_torque``; the virial stress
    pairs r with the pair forces -dE/ddelta x the same count, per graph.
    A training step passes ``create_graph=True`` (its loss holds the
    forces and stress).
    """
    cfg = model.cfg
    num_graphs = batch.graph_mask.shape[0]
    zero_stress = batch.r.new_zeros((num_graphs, 3, 3))
    if not cfg.calculate_gradient:
        res = model(batch, batch.frac_coords)
        res["grad"] = batch.r.new_zeros((batch.z.shape[0], 3))
        res["stresses"] = zero_stress
        return res
    frac = batch.frac_coords.detach().requires_grad_(True)
    delta = torch.zeros_like(batch.r, requires_grad=True)
    with torch.enable_grad():
        r = compute_cartesian_r(batch, frac) + delta
        res = model(batch, frac, r=r)
        energy = torch.sum(res["en_out"] * batch.graph_mask)
        g_frac, g_delta = torch.autograd.grad(energy, (frac, delta),
                                              create_graph=create_graph)
    res["r"] = r = r.detach()
    # inv_ex: the values of inv, without its check on the host (a sync
    # that a captured train step may not make)
    inv_lat = torch.linalg.inv_ex(batch.lattice)[0][batch.node_graph]
    total = batch.n_nodes.sum()
    forces = -torch.einsum("ni,nji->nj", g_frac, inv_lat) * total \
        * batch.node_mask[:, None]
    if cfg.remove_torque:
        cart = torch.einsum("ni,nij->nj", batch.frac_coords,
                            batch.lattice[batch.node_graph])
        forces = remove_net_torque(cart, forces, batch.node_graph,
                                   batch.node_mask, batch.n_nodes)
    res["grad"] = forces
    if cfg.stresswise_weight != 0:
        outer = torch.einsum("ei,ej->eij", r, -g_delta * total)
        per_graph = segment_sum(outer, batch.edge_graph, num_graphs)
        res["stresses"] = (-cfg.stress_multiplier * EV_A3_TO_GPA * per_graph
                           / torch.clamp_min(batch.volume, 1e-12)
                           [:, None, None])
    else:
        res["stresses"] = zero_stress
    return res
