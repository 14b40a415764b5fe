"""Edge-partitioned graph parallelism (counterpart of
``alignn_tpu/parallel/graph_parallel.py``).

The line-graph term |L(g)| ~ sum_i deg(i)^2 bounds the crystal one device
can hold, so the edge and L-edge index spaces of one batch are split over
the ranks of a "graph" mesh axis:

- the node table x is replicated; each g-stage aggregation all-reduces its
  partial segment sums (:mod:`alignn_tpu_torch.parallel.gp_model`);
- everything edge-indexed (r, the bond features y, the bond messages m)
  lives on its owner rank, ``E/G`` rows each (:func:`shard_batch`); the
  L(g) stage walks the ring;
- forces: dE/dr is local, the +/- segment sums run on the local shard and
  the [N, 3] force table is all-reduced.

Where JAX slices the batch by ``shard_map`` specs (``batch_specs``), each
rank here gets the whole batch and keeps its shard (:func:`shard_batch`);
the fields that split are :data:`EDGE_FIELDS` and :data:`LG_FIELDS`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import torch

from alignn_tpu_torch.graph.batch import GraphBatch, _incidence
from alignn_tpu_torch.nn.models import EV_A3_TO_GPA, ALIGNNAtomWise
from alignn_tpu_torch.ops.segment import segment_sum
from alignn_tpu_torch.parallel.gp_batch import (host, make_ring_index,
                                                ring_steps)
from alignn_tpu_torch.parallel.mesh import (Axis, Mesh, all_reduce_sum,
                                            ordered_collectives)

GRAPH_AXIS = "graph"

# which GraphBatch fields shard over the edge axis
EDGE_FIELDS = ("src", "dst", "r", "images", "edge_graph", "edge_mask")
LG_FIELDS = ("lg_src", "lg_dst", "lg_mask")


def check_divisible(batch: GraphBatch, n_devices: int):
    e = batch.src.shape[0]
    lg = batch.lg_src.shape[0]
    if e % n_devices or lg % n_devices:
        raise ValueError(
            f"edge ({e}) / L-edge ({lg}) counts must divide the mesh "
            f"size {n_devices}; adjust bucket quanta")


def shard_batch(batch: GraphBatch, axis: Axis) -> GraphBatch:
    """This rank's view of `batch`: the edge and L-edge fields cut to its
    contiguous shard, the node and graph fields whole.  The g-stage
    incidence is rebuilt over the shard (its src argsort and the CSR of
    its ascending dst over all N nodes); there is no line-graph incidence
    (the ring carries it) and no gather window."""
    check_divisible(batch, axis.size)
    c, d = axis.index, axis.size
    e_loc = batch.src.shape[0] // d
    l_loc = batch.lg_src.shape[0] // d
    fields = {f: getattr(batch, f)[c * e_loc:(c + 1) * e_loc]
              for f in EDGE_FIELDS}
    fields.update({f: getattr(batch, f)[c * l_loc:(c + 1) * l_loc]
                   for f in LG_FIELDS})
    n = batch.z.shape[0]
    g = _incidence(host(fields["src"]), host(fields["dst"]), n, n,
                   batch.src.device)
    return dataclasses.replace(
        batch, **fields, g_index=g, lg_index=None,
        **{w: 0 for w in ("win_src", "win_dst", "win_src_sorted",
                          "win_lg_src", "win_lg_dst", "win_lg_src_sorted")})


def gp_device_outputs(model, model_cfg, batch: GraphBatch, ring,
                      n_devices: int, create_graph: bool = False):
    """One rank's ring-GP forward: (out, forces, stress, res).

    `batch` is the rank's shard (:func:`shard_batch`), `ring` its
    :class:`~alignn_tpu_torch.parallel.gp_batch.RingSteps`.  The forces
    come from dE/d(r_local) divided by the axis size: the energy is
    replicated by all-reduces whose backward all-reduces again, so each
    rank's gradient is G times its share (as JAX's psum transposes).
    `create_graph` keeps that gradient differentiable (a train step)."""
    axis = model.axis
    r_loc = batch.r.detach().requires_grad_(True)
    with torch.enable_grad():
        res = model(batch, r_loc, ring)
        energy = torch.sum(res["en_out"] * batch.graph_mask)
        (g_r,) = torch.autograd.grad(energy, r_loc,
                                     create_graph=create_graph)
    pair_forces = model_cfg.grad_multiplier * (g_r / n_devices)
    if model_cfg.force_mult_natoms:
        pair_forces = pair_forces * batch.n_nodes.sum()

    num_nodes = batch.z.shape[0]
    forces = segment_sum(pair_forces, batch.dst, num_nodes)
    if model_cfg.add_reverse_forces:
        forces = forces - segment_sum(pair_forces, batch.src, num_nodes)
    forces = all_reduce_sum(forces, axis.group)

    if model_cfg.stresswise_weight != 0:
        outer = torch.einsum("ei,ej->eij", batch.r, pair_forces)
        per_graph = all_reduce_sum(segment_sum(
            outer, batch.edge_graph, batch.graph_mask.shape[0]), axis.group)
        stress = (-model_cfg.stress_multiplier * EV_A3_TO_GPA * per_graph
                  / torch.clamp_min(batch.volume, 1e-12)[:, None, None])
    else:
        stress = torch.zeros_like(batch.stress)
    return res["out"], forces, stress, res


class RingFloor:
    """The ring index of each batch with its step widths floored by the
    widest seen so far (JAX's monotone ``steps_floor``)."""

    def __init__(self, n_shards: int):
        self.n_shards = n_shards
        self.steps = None

    def __call__(self, batch: GraphBatch):
        ring = make_ring_index(batch, self.n_shards)
        if self.steps is not None:
            floored = tuple(max(a, b) for a, b in zip(ring.steps,
                                                      self.steps))
            if floored != ring.steps:
                ring = make_ring_index(batch, self.n_shards, steps=floored)
        self.steps = ring.steps
        return ring


def make_gp_forward(model: ALIGNNAtomWise, mesh: Mesh):
    """batch -> (out, forces, stress), the ring-GP E/F/S forward of
    `model`'s parameters over the mesh's graph axis.  Every rank passes
    the same whole batch on its device; the ring index is built on the
    host at each call (``ring=`` passes one) with a monotone floor on its
    step widths, and the outputs are replicated."""
    from alignn_tpu_torch.parallel.gp_model import GPALIGNNAtomWise

    axis = mesh.axis(GRAPH_AXIS)
    gp = GPALIGNNAtomWise.sharing(model, axis)
    floor = RingFloor(axis.size)

    def fwd(batch: GraphBatch, ring=None):
        ring = floor(batch) if ring is None else ring
        local = shard_batch(batch, axis)
        steps = ring_steps(ring, axis.index, local.src.shape[0],
                           batch.src.device)
        gp.eval()
        with ordered_collectives(batch.r.device):
            out, forces, stress, _ = gp_device_outputs(
                gp, model.cfg, local, steps, axis.size)
        return out.detach(), forces.detach(), stress.detach()

    return fwd


def edges_per_second_scaling(model: ALIGNNAtomWise, batch: GraphBatch,
                             mesh_sizes=(1, 2, 4, 8),
                             iters: int = 5) -> Dict[int, float]:
    """Edges (plus L-edges) a second of the GP forward on the first n
    ranks of the group, for each n in `mesh_sizes` up to the world size
    (a benchmark aid).  Every rank calls it; a rank outside a mesh of n
    waits for it; the rates come back on the ranks that ran."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    n_edges = batch.src.shape[0] + batch.lg_src.shape[0]
    out = {}
    for n in mesh_sizes:
        if n > world:
            continue
        group = dist.new_group(list(range(n)))
        if rank < n:
            check_divisible(batch, n)
            mesh = Mesh(world_size=n, rank=rank, device=batch.r.device,
                        backend=dist.get_backend(), group=group,
                        axis_names=(GRAPH_AXIS,), shape=(n,),
                        axes={GRAPH_AXIS: Axis(GRAPH_AXIS, group,
                                               tuple(range(n)), rank)})
            fwd = make_gp_forward(model, mesh)
            ring = make_ring_index(batch, n)
            fwd(batch, ring)
            _sync(batch.r)
            t0 = time.perf_counter()
            for _ in range(iters):
                fwd(batch, ring)
            _sync(batch.r)
            out[n] = n_edges / ((time.perf_counter() - t0) / iters)
        dist.barrier()
    return out


def _sync(x: torch.Tensor):
    if x.is_cuda:
        torch.cuda.synchronize(x.device)

