"""The first training steps in plain PyTorch: the loss, its gradients and
AdamW, with the one-cycle learning rate.

- Force field (ALIGNN-FF): loss = graphwise_weight * mean_g |E_g/n_g - t_g|
  + gradwise_weight * mean over atoms and axes |F - F_t|, the forces taken
  with ``create_graph`` so that the loss's gradient runs through them.
  The loss is a sum over structures, so it is taken structure by
  structure and the gradients are summed, which keeps the double
  backward's memory to one structure's (valid while no bond is shorter
  than the penalty threshold, where the published penalty couples the
  batch; checked).
- Property model (ALIGNN, BatchNorm on batch statistics): the criterion
  over the batch's outputs, whole batch at once.
- AdamW as ``torch.optim.AdamW`` defines it (beta 0.9, 0.999, eps 1e-8,
  decoupled decay p <- p (1 - lr wd) before the moment update), no decay
  on biases and norm parameters (the published ``group_decay``).
- The learning rate of an epoch: torch's ``OneCycleLR`` (cosine, 30 %
  warm-up, div 25, final div 1e4) stepped once an epoch, over
  ``epochs * steps_per_epoch`` steps (``onecycle``) or over ``epochs``
  (``onecycle_full``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from reference import model as rmodel


def onecycle(max_lr: float, total: int, step: int) -> float:
    initial = max_lr / 25.0
    final = initial / 1e4
    up_end = max(0.3 * total - 1.0, 1e-12)
    down_end = total - 1.0
    step = min(float(step), down_end)

    def cos(a, b, pct):
        return b + (a - b) / 2.0 * (math.cos(math.pi * pct) + 1.0)

    if step <= up_end:
        return cos(initial, max_lr, min(max(step / up_end, 0.0), 1.0))
    return cos(max_lr, final, min(max((step - up_end)
                                      / max(down_end - up_end, 1e-12),
                                      0.0), 1.0))


def epoch_lr(scheduler: str, lr: float, epochs: int, epoch: int,
             steps_per_epoch: int) -> float:
    if scheduler == "onecycle":
        return onecycle(lr, epochs * steps_per_epoch, epoch)
    if scheduler == "onecycle_full":
        return onecycle(lr, epochs, epoch)
    return lr


def loss_and_grads(params, cfg: dict, train: dict, graphs: list,
                   property_model: bool, device
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(loss, {name: gradient}) of one batch of labelled reference graphs
    (each graph carries ``target`` and, for the force field, ``forces``)."""
    names = list(params)
    leaves = [params[n].detach().requires_grad_(True) for n in names]
    p = dict(zip(names, leaves))
    if property_model:
        b = rmodel.batch_tensors(graphs, device)
        out, _bond = rmodel.forward(p, cfg, b, b["r"], property_model=True)
        t = torch.as_tensor([g.target for g in graphs], dtype=out.dtype,
                            device=device)
        crit = {"l1": torch.abs, "mse": torch.square}[train["criterion"]]
        loss = crit(out[:, 0] - t).mean()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        total = float(loss.detach())
    else:
        n_tot = sum(len(g.z) for g in graphs)
        gw, fw = cfg["graphwise_weight"], cfg["gradwise_weight"]
        grads, total = None, 0.0
        for g in graphs:
            if np.linalg.norm(g.r, axis=1).min() < cfg["penalty_threshold"]:
                raise ValueError("a bond under the penalty threshold couples "
                                 "the batch's structures")
            b = rmodel.batch_tensors([g], device)
            out, _e, forces = rmodel.energy_forces(p, cfg, b, b["r"],
                                                   create_graph=True)
            ft = torch.as_tensor(g.forces, dtype=forces.dtype, device=device)
            loss = gw * (out[0] - g.target).abs() / len(graphs) \
                + fw * (forces - ft).abs().sum() / (3 * n_tot)
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = gs if grads is None else [
                a if b_ is None else (b_ if a is None else a + b_)
                for a, b_ in zip(grads, gs)]
            total += float(loss.detach())
    return total, {n: (torch.zeros_like(leaf) if g is None else g.detach())
                   for n, leaf, g in zip(names, leaves, grads)}


def follow(params0, cfg: dict, train: dict, batches: List[list],
           property_model: bool, lr: float, device, moments=None,
           steps_taken: int = 0) -> dict:
    """len(batches) AdamW steps from `params0`: each step's loss, the
    first step's gradients and the parameters' change over all the steps
    (numpy, by name).  The optimizer starts fresh, or from `moments`
    ({name: (first, second)}) after `steps_taken` steps."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    wd = train["weight_decay"]
    p = {k: v.detach().clone() for k, v in params0.items()}
    if moments is None:
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    else:
        m = {k: moments[k][0].clone() for k in p}
        v2 = {k: moments[k][1].clone() for k in p}
    losses, first = [], None
    for step, graphs in enumerate(batches, start=steps_taken + 1):
        loss, grads = loss_and_grads(p, cfg, train, graphs, property_model,
                                     device)
        losses.append(loss)
        if first is None:
            first = {k: g.cpu().double().numpy() for k, g in grads.items()}
        bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
        for k in p:
            if rmodel.decays(k):
                p[k] = p[k] * (1 - lr * wd)
            m[k] = b1 * m[k] + (1 - b1) * grads[k]
            v2[k] = b2 * v2[k] + (1 - b2) * grads[k] ** 2
            denom = torch.sqrt(v2[k]) / math.sqrt(bc2) + eps
            p[k] = p[k] - (lr / bc1) * m[k] / denom
    change = {k: (p[k] - params0[k]).cpu().double().numpy() for k in p}
    return {"losses": losses, "grads": first, "change": change}


def counted_leaves(grads: Dict[str, np.ndarray]) -> List[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    norms = {k: float(np.linalg.norm(g)) for k, g in grads.items()}
    med = float(np.median(list(norms.values())))
    return [k for k, n in norms.items() if n >= 1e-3 * med]
