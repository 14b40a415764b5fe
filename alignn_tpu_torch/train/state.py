"""Train state and the train/eval step factories.

Counterpart of ``alignn_tpu/train/state.py``.  One training step of the
force field is its forward with ``create_graph=True`` (the forces are
-dE/dr, or for eALIGNN -dE/dfrac through the lattice, so the loss
differentiates through that gradient), the weighted loss, one backward
and one optimizer update.  One step of the property
model (``ALIGNN``) runs its forward in train mode, which moves the
BatchNorm running statistics once, then ``property_loss`` (NLL over the
log-probabilities for a classifier); its eval step runs in eval
mode.  The losses come back as tensors on the batch's device: nothing in
a step copies to the host or waits for the device.

Both steps are compiled as JAX's are jitted: a
:class:`~alignn_tpu_torch.ff.step_loop.CompiledStep` per step keeps one
CUDA graph per batch signature (the bucket: segments at their item
capacity, gather windows at the loader's floor), captured on the card after two
eager sightings and replayed for every later batch of the bucket; the
train and eval graphs of a model share one memory pool.  The graph holds
the addresses of the parameters, their gradients (built once, before any
capture, and zeroed in place), the optimizer's state and its
device-tensor learning rate (``train/optim.py``).  A capture or replay
error raises; ``cuda_graph=False`` runs the eager step, and on the CPU
the compiled step runs eagerly over the same static batches.  There is
no donation.

The data-parallel step (``make_train_step(..., group=...)``, JAX's
``make_dp_train_step``, :mod:`alignn_tpu_torch.parallel.dp`) is the same
step with two collectives after the backward: one all-reduce over the flat
buffer that holds every gradient (:func:`build_grads`), then one over the
stacked losses, each a SUM divided by the world size (JAX's ``pmean``).
Every rank then applies the same update.  The collectives are recorded in
the step's CUDA graph, as the BatchNorm sums of a property model
(``nn/layers.py``) are.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import torch
from torch import nn

from alignn_tpu_torch.ff.step_loop import CompiledStep
from alignn_tpu_torch.graph.batch import GraphBatch
from alignn_tpu_torch.nn.ealignn import eALIGNNAtomWise, ealignn_forward
from alignn_tpu_torch.nn.layers import MaskedBatchNorm
from alignn_tpu_torch.nn.models import ALIGNNAtomWise, atomwise_forward
from alignn_tpu_torch.tracing import span
from alignn_tpu_torch.train.losses import atomwise_loss, property_loss
from alignn_tpu_torch.train.optim import OptimizerSpec, set_lr


@dataclass
class TrainState:
    """The step count, the model (its parameters and BatchNorm buffers)
    and its optimizer."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        """The BatchNorm running statistics ({} for a LayerNorm model)."""
        return {f"{name}.{key}": getattr(m, key)
                for name, m in self.model.named_modules()
                if isinstance(m, MaskedBatchNorm) for key in ("mean", "var")}

    def set_lr(self, lr: float) -> "TrainState":
        """Write the learning rate (host side, per epoch)."""
        set_lr(self.optimizer, lr)
        return self


def create_train_state(model: nn.Module, sample_batch: GraphBatch,
                       tx: OptimizerSpec) -> TrainState:
    """The model on the sample batch's device, with a fresh optimizer.

    The port's modules are initialised when they are built (from a
    ``torch.Generator`` or a carried-over state dict), so unlike the JAX
    function this draws nothing; BatchNorm statistics live in the model's
    buffers.
    """
    model.to(sample_batch.r.device)
    return TrainState(step=0, model=model, optimizer=tx.init(model))


def _forward_and_loss(model: nn.Module, batch: GraphBatch, criterion: str,
                      classification: bool, create_graph: bool
                      ) -> Tuple[Dict[str, torch.Tensor],
                                 Dict[str, torch.Tensor]]:
    """(losses, predictions); `create_graph` keeps the force pass
    differentiable for a training step."""
    if isinstance(model, (ALIGNNAtomWise, eALIGNNAtomWise)):
        forward = ealignn_forward if isinstance(model, eALIGNNAtomWise) \
            else atomwise_forward
        res = forward(model, batch, create_graph=create_graph)
        return atomwise_loss(res, batch, model.cfg,
                             classification=classification), res
    out = model(batch)
    return ({"loss": property_loss(out, batch, criterion, classification)},
            {"out": out})


def _check_state(state: TrainState, model: nn.Module):
    if state.model is not model:
        raise ValueError("the train state holds another model than the one "
                         "the step was made for")


def build_grads(model: nn.Module) -> List[torch.Tensor]:
    """Give every parameter a gradient tensor, once, and return the flat
    buffers (one a dtype) whose views they are.

    The step zeroes the gradients in place and the backward accumulates
    into them, so a captured graph keeps their addresses; a parameter that
    this loss does not reach (the last L-stage's pair features) keeps a
    zero gradient, so that weight decay still applies, as in optax.  The
    data-parallel step all-reduces each flat buffer in one collective.  A
    gradient that is already there is copied into its view."""
    params = list(model.parameters())
    built = model.__dict__.get("_grad_views")
    if built is not None and len(built[1]) == len(params) and all(
            p.grad is v for p, v in zip(params, built[1])):
        return built[0]
    by_dtype: Dict[torch.dtype, List[nn.Parameter]] = {}
    for p in params:
        by_dtype.setdefault(p.dtype, []).append(p)
    flats, views = [], {}
    for dtype, group in by_dtype.items():
        flat = torch.zeros(sum(p.numel() for p in group), dtype=dtype,
                           device=group[0].device)
        off = 0
        for p in group:
            view = flat[off:off + p.numel()].view_as(p)
            if p.grad is not None:
                view.copy_(p.grad)
            p.grad = views[id(p)] = view
            off += p.numel()
        flats.append(flat)
    model.__dict__["_grad_views"] = (flats, [views[id(p)] for p in params])
    return flats


def make_train_step(model: nn.Module, criterion: str = "l1",
                    classification: bool = False,
                    cuda_graph: bool = True, group=None) -> Callable:
    """(state, batch) -> (state, losses), updating the model in place;
    compiled per batch signature (``cuda_graph=False``: the eager
    step).  With a process `group` the gradients and losses are averaged
    over its ranks before the update (the data-parallel step)."""
    optimizer = None   # the state's, bound at its first step
    flats: List[torch.Tensor] = []   # build_grads' buffers

    def fn(batch: GraphBatch):
        optimizer.zero_grad(set_to_none=False)
        model.train()
        losses, _res = _forward_and_loss(model, batch, criterion,
                                         classification, create_graph=True)
        losses["loss"].backward()
        losses = {k: v.detach() for k, v in losses.items()}
        if group is not None:
            from alignn_tpu_torch.parallel.mesh import all_reduce_mean_

            for flat in flats:
                all_reduce_mean_(flat, group)
            mean = all_reduce_mean_(torch.stack(list(losses.values())),
                                    group)
            losses = dict(zip(losses, mean.unbind()))
        optimizer.step()
        return losses

    compiled = CompiledStep(fn, pool_key=model, name="train_step") \
        if cuda_graph else fn

    def step(state: TrainState, batch: GraphBatch):
        nonlocal optimizer
        with span("train_step"):
            _check_state(state, model)
            if optimizer is not state.optimizer:
                # graphs hold the optimizer's tensors: a new one, new
                # graphs
                optimizer = state.optimizer
                if cuda_graph:
                    compiled.clear()
            flats[:] = build_grads(model)
            losses = compiled(batch)
            state.step += 1
        return state, losses

    step.compiled = compiled if cuda_graph else None
    return step


def make_eval_step(model: nn.Module, criterion: str = "l1",
                   classification: bool = False,
                   cuda_graph: bool = True) -> Callable:
    """(state, batch) -> (losses, predictions), with no parameter graph;
    compiled per batch signature (``cuda_graph=False``: eager)."""

    def fn(batch: GraphBatch):
        model.eval()
        with torch.no_grad():   # the force pass enables grad on r itself
            losses, res = _forward_and_loss(model, batch, criterion,
                                            classification,
                                            create_graph=False)
        return ({k: v.detach() for k, v in losses.items()},
                {k: v.detach() for k, v in res.items()})

    compiled = CompiledStep(fn, pool_key=model, name="eval_step") \
        if cuda_graph else fn

    def step(state: TrainState, batch: GraphBatch):
        with span("eval_step"):
            _check_state(state, model)
            return compiled(batch)

    step.compiled = compiled if cuda_graph else None
    return step
