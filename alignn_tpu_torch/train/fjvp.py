"""The forward-over-reverse train step of the E/F/S loss (counterpart of
``alignn_tpu/train/fjvp.py``).

The standard step differentiates the 5-part loss in reverse mode; the
forces F = -dE/dr are a gradient themselves, so their terms cost reverse
over reverse.  Two exact identities restructure that outer gradient:

1. For the L1 criterion the loss gradient through a head H is
   <u_H, dH/dtheta> with u_H = w sign(H - H*) mask / count, constant in
   theta almost everywhere, so u_H can be a constant of the step.
2. The force and stress heads are linear in the pair-force table, so
   <u_F, F> + <u_S, S> = <v, dE/dr> for a closed-form v [E, 3]
   (:func:`pairforce_cotangent`), and <v, dE/dr> is one forward-mode
   tangent of the energy along v.

The gradient is then one reverse sweep over the forward and its tangent:

    grads = grad_theta [ <u_out, out> + <u_aw, aw> + <u_add, add>
                         + <tangent of E along v, mask> ]

JAX measured this to lose to reverse over reverse (``fjvp.py:31-49``:
+19 % flops on its TPU step): the loss needs F's value, so the first-order
reverse pass is paid in both, and fjvp adds the tangent.  The port pays
one forward more than JAX: JAX linearizes once and reuses the residuals
for the tangent, while forward mode here (``torch.autograd.forward_ad``)
carries the tangent alongside a second primal forward, started once v is
known from the first pass.  The step is opt-in through this API, as in
JAX, and not wired into the trainer.

On the card the primal values go through the kernels, and so do the
tangents: each autograd Function of the sparse and dense paths has a
forward-mode rule (``ops/eggc.py``, ``ops/dense.py``).  Scope, as in JAX:
ALIGNNAtomWise, criterion "l1", r-gradient forces, no classification.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.autograd import forward_ad

from alignn_tpu_torch.graph.batch import GraphBatch
from alignn_tpu_torch.nn.models import (EV_A3_TO_GPA, ALIGNNAtomWise,
                                        forces_and_stress)
from alignn_tpu_torch.train.losses import atomwise_loss


def _l1_cotangent(pred: torch.Tensor, target: torch.Tensor,
                  mask: torch.Tensor, weight: float) -> torch.Tensor:
    """d(weight * masked_mean(|pred - target|)) / d(pred): the constants
    reverse mode uses (``losses.masked_mean``)."""
    m = mask
    while m.dim() < pred.dim():
        m = m[..., None]
    m = m.expand_as(pred)
    den = torch.clamp_min(m.sum(), 1.0)
    return weight * torch.sign(pred - target) * m / den


def pairforce_cotangent(res: Dict[str, torch.Tensor], batch: GraphBatch,
                        cfg) -> torch.Tensor:
    """v [E, 3] with <v, dE/dr> = <u_F, F> + <u_S, S>: the transpose of
    the force assembly and the virial onto the dE/dr table, with the
    grad_multiplier, force_mult_natoms and stress factors folded in."""
    u_f = _l1_cotangent(res["grad"], batch.forces, batch.node_mask,
                        cfg.gradwise_weight)
    if batch.dense_D:
        v_pf = u_f.repeat_interleave(batch.dense_D, dim=0)
        if cfg.add_reverse_forces:
            v_pf = v_pf - v_pf[batch.rev]
    else:
        v_pf = u_f[batch.dst]
        if cfg.add_reverse_forces:
            v_pf = v_pf - u_f[batch.src]
    if cfg.stresswise_weight != 0:
        u_s = _l1_cotangent(res["stresses"], batch.stress, batch.graph_mask,
                            cfg.stresswise_weight)
        div = 2.0 if not getattr(cfg, "batch_stress", True) else 1.0
        scale = (-cfg.stress_multiplier * EV_A3_TO_GPA
                 / (div * torch.clamp_min(batch.volume, 1e-12)))
        u_s_e = (u_s * scale[:, None, None])[batch.edge_graph]
        v_pf = v_pf + torch.einsum("ei,eij->ej", batch.r, u_s_e)
    v_gr = cfg.grad_multiplier * v_pf
    if cfg.force_mult_natoms:
        v_gr = v_gr * batch.n_nodes.sum()
    return v_gr


def make_train_step_fjvp(model, criterion: str = "l1",
                         classification: bool = False,
                         group=None) -> Callable:
    """(state, batch) -> (state, losses), forward over reverse; a drop-in
    for ``make_train_step`` on the ALIGNN-FF recipe (eager, updating the
    model in place).  With a process `group` the gradients and losses are
    averaged over its ranks.  Raises outside the identities' conditions."""
    if not isinstance(model, ALIGNNAtomWise):
        raise ValueError("fjvp step supports ALIGNNAtomWise only")
    cfg = model.cfg
    if classification:
        raise ValueError("fjvp step is for regression (L1) training")
    if criterion != "l1":
        raise ValueError("fjvp step requires the (L1) a.e.-linearity")
    if cfg.include_pos_deriv or not cfg.calculate_gradient:
        raise ValueError("fjvp step requires r-gradient forces")
    force_on = cfg.gradwise_weight != 0 or cfg.stresswise_weight != 0

    def step(state, batch: GraphBatch):
        from alignn_tpu_torch.train.state import _check_state, build_grads

        _check_state(state, model)
        flats = build_grads(model)
        state.optimizer.zero_grad(set_to_none=False)
        model.train()
        losses, v = _first_order(model, batch, force_on)
        s = _tangent_objective(model, batch, v)
        s.backward()
        stacked = torch.stack([x.detach().float().reshape(())
                               for x in losses.values()])
        if group is not None:
            from alignn_tpu_torch.parallel.mesh import all_reduce_mean_

            for flat in flats:
                all_reduce_mean_(flat, group)
            all_reduce_mean_(stacked, group)
        state.optimizer.step()
        state.step += 1
        return state, dict(zip(losses, stacked.unbind()))

    return step


def _first_order(model, batch: GraphBatch, force_on: bool):
    """(losses, v): the primal forward, dE/dr by one reverse pass (no
    graph kept), the forces and stress, the losses, and the pair-force
    cotangent v (None without a force or stress term)."""
    cfg = model.cfg
    r = batch.r.detach().requires_grad_(force_on)
    with torch.enable_grad():
        res = model(batch, r)
        if force_on:
            energy = torch.sum(res["en_out"] * batch.graph_mask)
            (g_r,) = torch.autograd.grad(energy, r)
    res = {k: x.detach() for k, x in res.items()}
    if force_on:
        res["grad"], res["stresses"] = forces_and_stress(cfg, batch, g_r)
    else:
        res["grad"] = torch.zeros_like(batch.forces)
        res["stresses"] = torch.zeros_like(batch.stress)
    losses = atomwise_loss(res, batch, cfg)
    v = pairforce_cotangent(res, batch, cfg) if force_on else None
    return losses, v


def _tangent_objective(model, batch: GraphBatch,
                       v: Optional[torch.Tensor]) -> torch.Tensor:
    """The scalar whose parameter gradient is the step's: the energy's
    tangent along v (one forward with r dual) and the direct heads'
    <u, H>, u from the primal values."""
    cfg = model.cfg
    s = batch.r.new_zeros((), dtype=torch.float32)
    with forward_ad.dual_level():
        r = batch.r.detach() if v is None else \
            forward_ad.make_dual(batch.r.detach(), v)
        res = model(batch, r)
        if v is not None:
            tangent = forward_ad.unpack_dual(res["en_out"]).tangent
            s = s + torch.sum(tangent * batch.graph_mask)
        prim = {k: forward_ad.unpack_dual(x).primal for k, x in res.items()}
    heads = []
    if cfg.output_features is not None and cfg.graphwise_weight != 0:
        tw = batch.target.shape[1]
        heads.append((prim["out"][:, :tw], batch.target, batch.graph_mask,
                      cfg.graphwise_weight))
    if cfg.atomwise_output_features > 0 and cfg.atomwise_weight != 0:
        aw = batch.atomwise_target.shape[1]
        heads.append((prim["atomwise_pred"][:, :aw], batch.atomwise_target,
                      batch.node_mask, cfg.atomwise_weight))
    if getattr(cfg, "additional_output_weight", 0) != 0 and \
            getattr(cfg, "additional_output_features", 0) > 0:
        fw = batch.additional.shape[1]
        heads.append((prim["additional"][:, :fw], batch.additional,
                      batch.graph_mask, cfg.additional_output_weight))
    for pred, target, mask, weight in heads:
        u = _l1_cotangent(pred.detach(), target, mask, weight)
        s = s + torch.sum(u * pred)
    return s
