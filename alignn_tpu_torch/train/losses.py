"""Masked loss functions and the multi-head weighted training loss.

Counterpart of ``alignn_tpu/train/losses.py``.  Every mean runs over the
real (mask 1) rows only, so the padded slots of a batch never reach a
gradient.  Kept from the reference: the ``alignn_atomwise`` loss is L1
whatever the configured criterion; classification is NLL over log-softmax
rows (property model) or BCE over sigmoid outputs (atomwise model);
stress and additional targets are per graph.
"""

from __future__ import annotations

from typing import Any, Dict

import torch


def _expand(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    while mask.dim() < like.dim():
        mask = mask[..., None]
    return mask


def masked_mean(err: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of `err` over the rows where mask == 1 (err may have trailing
    dims; the count is of masked *elements*, the rows broadcast)."""
    mask = _expand(mask, err)
    num = torch.sum(err * mask)
    den = torch.clamp_min(torch.sum(mask.expand_as(err)), 1.0)
    return num / den


def l1_loss(pred, target, mask):
    return masked_mean(torch.abs(pred - target), mask)


def mse_loss(pred, target, mask):
    return masked_mean((pred - target) ** 2, mask)


def poisson_loss(pred, target, mask):
    """``torch.nn.PoissonNLLLoss(log_input=True)``: exp(pred) - target pred."""
    return masked_mean(torch.exp(pred) - target * pred, mask)


def zig_loss(pred, target, mask):
    """Zero-inflated loss: BCE on the zero indicator plus L1 on the
    positive magnitudes.  An extension of the JAX package (the reference
    names ``zig`` but never routes it), reproduced as it is there."""
    p_zero = torch.sigmoid(pred)
    is_pos = (target > 0).to(pred.dtype)
    bce = -(is_pos * torch.log(p_zero + 1e-10)
            + (1 - is_pos) * torch.log(1 - p_zero + 1e-10))
    mag = torch.abs(pred - target) * is_pos
    return masked_mean(bce + mag, mask)


def nll_loss(log_probs, labels, mask):
    """NLLLoss over log-softmax rows; labels [G], integral values."""
    picked = torch.gather(log_probs, 1, labels[:, None].long())[:, 0]
    return -masked_mean(picked, mask)


CRITERIA = {"l1": l1_loss, "mse": mse_loss, "poisson": poisson_loss,
            "zig": zig_loss}


def _sanitize(pred: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero the padded rows before any nonlinearity.

    The trash slot can carry large values; ``exp``/``log`` criteria would
    turn them into inf, and inf * mask(0) is NaN, so the mask has to act
    on the inputs.
    """
    return torch.where(_expand(mask, pred) > 0, pred,
                       torch.zeros_like(pred))


def property_loss(out: torch.Tensor, batch, criterion: str,
                  classification: bool) -> torch.Tensor:
    """Loss of a property model's output [G, T] (or log-probabilities)."""
    if classification:
        return nll_loss(out, batch.target[:, 0], batch.graph_mask)
    tw = batch.target.shape[1]
    return CRITERIA[criterion](_sanitize(out[:, :tw], batch.graph_mask),
                               batch.target, batch.graph_mask)


def atomwise_loss(result: Dict[str, torch.Tensor], batch, model_cfg: Any,
                  classification: bool = False) -> Dict[str, torch.Tensor]:
    """The 5-part weighted loss of the FF model: `loss` and `loss1`..`loss5`
    (graph target, atomwise target, forces, stress, additional output).
    The criterion is L1, as in the reference."""
    crit = l1_loss
    zero = batch.graph_mask.new_zeros((), dtype=torch.float32)
    loss1 = loss2 = loss3 = loss4 = loss5 = zero

    if model_cfg.output_features is not None and \
            model_cfg.graphwise_weight != 0:
        if classification:
            labels = batch.target[:, 0]
            p = result["out"][:, 0]          # sigmoid probabilities
            bce = -(labels * torch.log(p + 1e-10)
                    + (1 - labels) * torch.log(1 - p + 1e-10))
            loss1 = model_cfg.graphwise_weight * masked_mean(
                bce, batch.graph_mask)
        else:
            tw = batch.target.shape[1]
            loss1 = model_cfg.graphwise_weight * crit(
                result["out"][:, :tw], batch.target, batch.graph_mask)
    if model_cfg.atomwise_output_features > 0 and \
            model_cfg.atomwise_weight != 0:
        aw = batch.atomwise_target.shape[1]
        loss2 = model_cfg.atomwise_weight * crit(
            result["atomwise_pred"][:, :aw], batch.atomwise_target,
            batch.node_mask)
    if model_cfg.calculate_gradient and model_cfg.gradwise_weight != 0:
        loss3 = model_cfg.gradwise_weight * crit(
            result["grad"], batch.forces, batch.node_mask)
    if model_cfg.stresswise_weight != 0:
        loss4 = model_cfg.stresswise_weight * crit(
            result["stresses"], batch.stress, batch.graph_mask)
    if getattr(model_cfg, "additional_output_weight", 0) != 0 and \
            getattr(model_cfg, "additional_output_features", 0) > 0:
        fw = batch.additional.shape[1]
        loss5 = model_cfg.additional_output_weight * crit(
            result["additional"][:, :fw], batch.additional,
            batch.graph_mask)
    total = loss1 + loss2 + loss3 + loss4 + loss5
    return {"loss": total, "loss1": loss1, "loss2": loss2, "loss3": loss3,
            "loss4": loss4, "loss5": loss5}
