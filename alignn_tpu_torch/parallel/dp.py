"""The data-parallel train step and trainer (counterpart of
``alignn_tpu/parallel/dp.py``).

JAX runs one SPMD program: the batch arrives stacked ``[D, ...]``, the
state is replicated, the gradients are ``pmean``-ed over the mesh and
every device applies the same update.  The port runs one process a device:
each rank's loader yields its own shard of the step
(``BucketedLoader(num_shards=D, shard_index=rank)``), each rank holds the
whole state, and the step averages the gradients and the losses with one
all-reduce each (``train/state.py``), so every rank applies the same
update and the parameters stay bit-identical across ranks.  The BatchNorm
statistics of the property model reduce across ranks through the model's
process group (``nn/layers.py``), as JAX's through its ``axis_name``.

The collective is written out rather than left to
``nn.parallel.DistributedDataParallel``: it is JAX's design, and DDP's
reducer hooks sit badly with the force step's double backward and with
the step's CUDA graph.

With ``mesh_shape {"data": D, "graph": G}`` (G > 1) the trainer takes the
2-D step instead: each data row edge-partitions its micro-batch over G
ranks, the ring of :mod:`alignn_tpu_torch.parallel.dp_gp` for a sparse
loader and the dense halo of :mod:`alignn_tpu_torch.parallel.dense_gp`
for a dense one.
"""

from __future__ import annotations

from typing import Callable, Optional

from alignn_tpu_torch.parallel.mesh import Mesh, make_mesh
from alignn_tpu_torch.train.state import make_train_step


def make_dp_train_step(model, mesh: Mesh, criterion: str = "l1",
                       classification: bool = False,
                       cuda_graph: bool = True) -> Callable:
    """(state, this rank's shard) -> (state, losses averaged over the
    ranks): the compiled train step (one CUDA graph per bucket, the
    collectives inside it) with the gradients averaged over `mesh`."""
    return make_train_step(model, criterion=criterion,
                           classification=classification,
                           cuda_graph=cuda_graph, group=mesh.group)


def train_model_dp(config, train_loader, val_loader, test_loader=None,
                   n_devices: Optional[int] = None,
                   restart_params_path: Optional[str] = None,
                   restart_state_path: Optional[str] = None):
    """:func:`~alignn_tpu_torch.train.trainer.train_model` with the
    data-parallel step, on every rank of the initialised group.

    The mesh spans `n_devices`, else ``config.mesh_shape["data"]``, else
    every rank, as in JAX; it must span the whole group, and the train
    loader's ``num_shards`` must equal it.  Rank 0 alone writes the
    artifacts."""
    from alignn_tpu_torch.train import trainer

    mesh_shape = getattr(config, "mesh_shape", None) or {}
    g_size = int(mesh_shape.get("graph", 1))
    if g_size > 1:
        return _train_model_dp_gp(config, train_loader, val_loader,
                                  test_loader, mesh_shape, n_devices,
                                  restart_params_path, restart_state_path)
    mesh = make_mesh(n_devices if n_devices is not None else
                     mesh_shape.get("data"))
    if train_loader.num_shards != mesh.size:
        raise ValueError(
            f"train loader num_shards={train_loader.num_shards} != mesh "
            f"size {mesh.size}; build loaders with num_shards={mesh.size}")
    if train_loader.shard_index != mesh.rank:
        raise ValueError(f"rank {mesh.rank} holds the train loader of "
                         f"shard {train_loader.shard_index}")

    def step_factory(model, criterion, classification):
        return make_dp_train_step(model, mesh, criterion=criterion,
                                  classification=classification)

    return trainer.train_model(
        config, train_loader, val_loader, test_loader,
        restart_params_path=restart_params_path,
        restart_state_path=restart_state_path,
        train_step_factory=step_factory, model_axis_name=mesh.group)


def _train_model_dp_gp(config, train_loader, val_loader, test_loader,
                       mesh_shape, n_devices, restart_params_path,
                       restart_state_path):
    """The trainer over a (data, graph) mesh: rank ``d * G + g`` trains
    data shard d, edge-partitioned over its row's G ranks; only rank 0
    writes."""
    from alignn_tpu_torch.parallel.dense_gp import \
        make_dp_dense_gp_train_step
    from alignn_tpu_torch.parallel.dp_gp import make_dp_gp_train_step
    from alignn_tpu_torch.train import trainer

    check_graph_axis_model(config)
    g_size = int(mesh_shape["graph"])
    if "data" in mesh_shape:
        d_size = int(mesh_shape["data"])
    else:
        d_size = (n_devices or _world()) // g_size
    mesh = make_mesh(d_size * g_size, axis_names=("data", "graph"),
                     shape=(d_size, g_size))
    if train_loader.num_shards != d_size:
        raise ValueError(
            f"train loader num_shards={train_loader.num_shards} != data "
            f"mesh size {d_size}")
    if train_loader.shard_index != mesh.axis("data").index:
        raise ValueError(f"rank {mesh.rank} holds the train loader of "
                         f"shard {train_loader.shard_index}")

    def step_factory(model, criterion, classification):
        if getattr(train_loader.spec, "dense_D", 0):
            return make_dp_dense_gp_train_step(
                model, mesh, classification=classification)
        return make_dp_gp_train_step(model, mesh,
                                     classification=classification)

    return trainer.train_model(
        config, train_loader, val_loader, test_loader,
        restart_params_path=restart_params_path,
        restart_state_path=restart_state_path,
        train_step_factory=step_factory)


def check_graph_axis_model(config) -> None:
    """Raise unless ``config.model`` can be edge-partitioned over a graph
    axis: only the atomwise model has a graph-parallel step."""
    from alignn_tpu_torch.nn.models import ALIGNNAtomWiseConfig

    if not isinstance(config.model, ALIGNNAtomWiseConfig):
        raise ValueError(
            "graph-axis parallelism requires an atomwise model "
            "(the property model has no edge-partitioned step)")


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size()
