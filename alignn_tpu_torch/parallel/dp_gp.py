"""Data x graph parallelism over a 2-D mesh (counterpart of
``alignn_tpu/parallel/dp_gp.py``).

The mesh is ("data", "graph"): each data row holds its own micro-batch
(``BucketedLoader(num_shards=D, shard_index=<data index>)``, every rank of
the row the same one), and within a row the micro-batch's edge and L-edge
spaces shard over the graph axis (the ring of
:mod:`alignn_tpu_torch.parallel.graph_parallel`).  The gradients and
losses are averaged over the graph axis (each rank's gradient is G times
its share, as JAX's psum transposes) and then over the data axis.  The
step runs eagerly: the ring's host-staged shifts and its per-batch host
index cannot live in a CUDA graph.  Its collectives run in one order on
every rank (:func:`~alignn_tpu_torch.parallel.mesh.ordered_collectives`).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from alignn_tpu_torch.graph.batch import GraphBatch
from alignn_tpu_torch.nn.models import ALIGNNAtomWise
from alignn_tpu_torch.parallel.gp_batch import ring_steps
from alignn_tpu_torch.parallel.graph_parallel import (GRAPH_AXIS, RingFloor,
                                                      gp_device_outputs,
                                                      shard_batch)
from alignn_tpu_torch.parallel.mesh import (Mesh, all_reduce_mean_,
                                            ordered_collectives)
from alignn_tpu_torch.train.losses import atomwise_loss

DATA_AXIS = "data"


def gp_train_step(model: ALIGNNAtomWise, mesh: Mesh,
                  losses_of: Callable[..., Dict[str, torch.Tensor]]
                  ) -> Callable:
    """(state, batch[, index]) -> (state, losses): `losses_of` computes
    this rank's loss dict with a differentiable force pass; the gradients
    (one flat buffer a dtype) and the losses are averaged over the graph
    axis, then the data axis where the mesh has one, and the optimizer
    steps.  The parameters stay bit-identical across the ranks."""
    from alignn_tpu_torch.train.state import _check_state, build_grads

    groups = [mesh.axis(GRAPH_AXIS).group]
    if DATA_AXIS in mesh.axes:
        groups.append(mesh.axis(DATA_AXIS).group)

    def step(state, batch: GraphBatch, index=None):
        _check_state(state, model)
        flats = build_grads(model)
        state.optimizer.zero_grad(set_to_none=False)
        with ordered_collectives(batch.r.device):
            losses = losses_of(batch, index)
            losses["loss"].backward()
        stacked = torch.stack([v.detach().float().reshape(())
                               for v in losses.values()])
        for group in groups:
            for flat in flats:
                all_reduce_mean_(flat, group)
            all_reduce_mean_(stacked, group)
        state.optimizer.step()
        state.step += 1
        return state, dict(zip(losses, stacked.unbind()))

    return step


def make_dp_gp_train_step(model: ALIGNNAtomWise, mesh: Mesh,
                          classification: bool = False) -> Callable:
    """(state, this row's micro-batch[, ring]) -> (state, losses) on a
    (data, graph) mesh, or a 1-D graph mesh: the edge-sharded
    GPALIGNNAtomWise with the ring halo over `model`'s parameters.  The
    ring index is built on the host from the batch (a monotone floor on
    its widths) unless one is passed."""
    from alignn_tpu_torch.parallel.gp_model import GPALIGNNAtomWise

    axis = mesh.axis(GRAPH_AXIS)
    gp = GPALIGNNAtomWise.sharing(model, axis)
    floor = RingFloor(axis.size)

    def losses_of(batch: GraphBatch, ring=None):
        ring = floor(batch) if ring is None else ring
        local = shard_batch(batch, axis)
        steps = ring_steps(ring, axis.index, local.src.shape[0],
                           batch.src.device)
        gp.train()
        _out, forces, stress, res = gp_device_outputs(
            gp, model.cfg, local, steps, axis.size, create_graph=True)
        res["grad"] = forces
        res["stresses"] = stress
        return atomwise_loss(res, local, model.cfg,
                             classification=classification)

    return gp_train_step(model, mesh, losses_of)
