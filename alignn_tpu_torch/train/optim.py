"""Optimizer construction: decay mask, AdamW/SGD, OneCycle learning rates.

Counterpart of ``alignn_tpu/train/optim.py``.  :func:`build_optimizer`
returns an :class:`OptimizerSpec`, which :func:`OptimizerSpec.init` turns
into a ``torch.optim`` optimizer over a model's parameters, as an optax
transformation is initialised on a parameter tree.  The learning rate is
host data: :func:`set_lr` writes it into the parameter groups, the way the
JAX trainer injects the per-epoch OneCycle value.

On the card the optimizer is built to be captured in a CUDA graph with the
train step (``train/state.py``): the learning rate of each group is a
one-element f32 tensor on the device that :func:`set_lr` fills in place
(a captured graph reads it at every replay; a Python float would be baked
in), AdamW is ``capturable`` (its step counts and bias corrections stay
on the device) and SGD is ``fused`` (its foreach update would read a
tensor learning rate on the host).  On the CPU the learning rate stays a
Python float and the update is torch's default one.

- ``adamw`` is ``torch.optim.AdamW`` (decoupled decay, the update of
  ``optax.adamw``).
- ``sgd`` is ``torch.optim.SGD`` with momentum 0.9 and coupled decay (the
  gradient plus wd * p enters the momentum), the update of
  ``optax.add_decayed_weights`` followed by ``optax.sgd``.

With a decay mask the decayed and the undecayed tensors go to two
parameter groups, the second with weight decay 0.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch import nn


def no_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """{parameter name: True where weight decay applies}.

    The reference's ``group_decay``: biases and every parameter of a
    module whose name holds ``norm`` (LayerNorm/BatchNorm scale and bias)
    are left out.  The port names its modules after the flax tree, so this
    picks the same tensors as the JAX mask does.
    """
    def decide(name: str) -> bool:
        parts = name.split(".")
        return parts[-1] != "bias" and not any("norm" in p for p in parts)

    return {name: decide(name) for name, _ in model.named_parameters()}


@dataclass(frozen=True)
class OptimizerSpec:
    """What :func:`build_optimizer` chose; :meth:`init` builds it."""

    name: str
    learning_rate: float
    weight_decay: float
    decay_mask: Optional[Dict[str, bool]] = None   # None: decay everything

    def init(self, model: nn.Module) -> torch.optim.Optimizer:
        named = list(model.named_parameters())
        if self.decay_mask is None:
            groups = [{"params": [p for _, p in named],
                       "weight_decay": self.weight_decay}]
        else:
            if set(self.decay_mask) != {n for n, _ in named}:
                raise ValueError("the decay mask was built for another "
                                 "model's parameters")
            groups = [{"params": [p for n, p in named
                                  if self.decay_mask[n] == decays],
                       "weight_decay": self.weight_decay if decays else 0.0}
                      for decays in (True, False)
                      if decays in self.decay_mask.values()]
        device = named[0][1].device if named else torch.device("cpu")
        if device.type != "cuda":
            if self.name == "adamw":
                return torch.optim.AdamW(groups, lr=self.learning_rate)
            return torch.optim.SGD(groups, lr=self.learning_rate,
                                   momentum=0.9)
        for g in groups:
            g["lr"] = torch.tensor(self.learning_rate, dtype=torch.float32,
                                   device=device)
        if self.name == "adamw":
            return torch.optim.AdamW(groups, lr=groups[0]["lr"],
                                     capturable=True)
        return torch.optim.SGD(groups, lr=groups[0]["lr"], momentum=0.9,
                               fused=True)


def build_optimizer(optimizer: str = "adamw", learning_rate: float = 1e-2,
                    weight_decay: float = 0.0,
                    model: Optional[nn.Module] = None) -> OptimizerSpec:
    """AdamW or SGD; with `model`, its :func:`no_decay_mask` applies."""
    if optimizer not in ("adamw", "sgd"):
        raise ValueError(f"unknown optimizer: {optimizer}")
    return OptimizerSpec(optimizer, float(learning_rate),
                         float(weight_decay),
                         None if model is None else no_decay_mask(model))


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Write the learning rate into every parameter group (host side): in
    place where the group holds it as a device tensor, with no sync."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(float(lr))
        else:
            group["lr"] = float(lr)


def onecycle_lr(max_lr: float, total_steps: int, pct_start: float = 0.3,
                div_factor: float = 25.0,
                final_div_factor: float = 1e4) -> Callable[[int], float]:
    """torch OneCycleLR (cos anneal, three_phase=False) as a fn of step.

    Mirrors torch's phase arithmetic bit-for-bit: the warm-up phase ends at
    the *float* ``pct_start * total_steps - 1`` (torch does not round), and
    each phase anneals with ``end + (start - end)/2 * (cos(pi*pct) + 1)``.
    """
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    up_end = max(float(pct_start * total_steps) - 1.0, 1e-12)
    down_end = float(total_steps) - 1.0
    down_span = max(down_end - up_end, 1e-12)

    def _cos(start, end, pct):
        return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)

    def schedule(step):
        # host-side (the trainer injects the LR value per epoch), so plain
        # float64 python math — bit-parity with torch needs the precision
        step = min(float(step), down_end)
        if step <= up_end:
            return _cos(initial_lr, max_lr,
                        min(max(step / up_end, 0.0), 1.0))
        return _cos(max_lr, min_lr,
                    min(max((step - up_end) / down_span, 0.0), 1.0))

    return schedule


def epoch_lr(scheduler: str, learning_rate: float, epochs: int,
             epoch: int, steps_per_epoch: int = 1) -> float:
    """Host-side LR for `epoch` under the reference's stepping convention.

    ``"onecycle"`` — parity with `alignn/train.py:219-227` + `:395`: the
    schedule horizon is ``epochs * steps_per_epoch`` but it is stepped once
    per epoch, so only the first ``1/steps_per_epoch`` of the cycle is ever
    traversed.  ``"onecycle_full"`` — traverse the complete cycle over
    ``epochs`` (round-1 behavior, kept as an explicit option).
    """
    if scheduler == "onecycle":
        horizon = max(epochs, 1) * max(steps_per_epoch, 1)
        return float(onecycle_lr(learning_rate, horizon)(epoch))
    if scheduler == "onecycle_full":
        return float(onecycle_lr(learning_rate, max(epochs, 1))(epoch))
    return float(learning_rate)
