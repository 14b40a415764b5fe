"""Folder training CLI (counterpart of ``alignn_tpu/cli/train.py``).

    python -m alignn_tpu_torch.cli.train --root_dir DATA \
        --config_name config.json --output_dir out [--device cpu]

Reads ``id_prop.{csv,json,json.zip}`` and the structures of a folder,
builds the loaders (graph cache under ``<output_dir>/graph_cache`` with
``use_cache``) and runs :func:`~alignn_tpu_torch.train.trainer.
train_model` on ``--device`` (``cuda`` by default).  ``--resume auto``
continues from ``<output_dir>/restart.mpk``; ``--restart_model_path``
starts from a weights file.  ``--profile DIR`` trains nothing: it builds
the model, its train state and the compiled train step on the first
training batch, profiles that step (:func:`~alignn_tpu_torch.profiler.
profile_step`: 2 wait, 2 warm-up and 6 traced steps, the trace in
``DIR/trace.json``) and prints and returns the result.

``--devices N`` trains data-parallel over N ranks, one a device
(:func:`~alignn_tpu_torch.parallel.dp.train_model_dp`): under ``torchrun``
this process is one of them and joins the group from its environment;
otherwise it spawns N ranks that meet at a free localhost port, NCCL on
the card and gloo with ``--device cpu``.  Each rank's train loader takes
``num_shards=N`` and its own shard; rank 0 writes the artifacts and its
summary is returned (the other ranks write nothing to the output
directory).  With the config's ``mesh_shape {"data": D, "graph": G}``
(N = D G) rank ``d * G + g`` takes data shard d, which its row's G ranks
edge-partition (sparse ring or dense halo, ``parallel/dp_gp.py``,
``parallel/dense_gp.py``).  On the card N may not exceed the visible
GPUs: NCCL refuses two ranks on one device.  ``--profile`` with ``--devices N``
profiles shard 0's single-device step in this process, as JAX does.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import socket
import sys
import tempfile
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from alignn_tpu_torch import resolve_device
from alignn_tpu_torch.config import TrainingConfig
from alignn_tpu_torch.data.dataset import load_folder_records
from alignn_tpu_torch.data.loader import get_train_val_loaders
from alignn_tpu_torch.parallel.dp import check_graph_axis_model
from alignn_tpu_torch.parallel.mesh import initialize_distributed
from alignn_tpu_torch.train.trainer import train_model


def train_for_folder(
    root_dir: str = "examples/sample_data",
    config_name: str = "config.json",
    classification_threshold: Optional[float] = None,
    batch_size: Optional[int] = None,
    epochs: Optional[int] = None,
    id_key: str = "jid",
    target_key: str = "total_energy",
    atomwise_key: str = "forces",
    gradwise_key: str = "forces",
    stresswise_key: str = "stresses",
    additional_output_key: str = "additional_output",
    file_format: str = "poscar",
    restart_model_path: Optional[str] = None,
    resume: Optional[str] = None,
    output_dir: Optional[str] = None,
    devices: int = 1,
    profile: Optional[str] = None,
    device=None,
) -> Dict[str, Any]:
    """Train from a folder of structures and id_prop targets; returns the
    trainer's summary (rank 0's with ``devices`` > 1), with the loaders'
    ``graph_stats``."""
    kwargs = dict(locals())
    if not os.path.exists(config_name):
        raise FileNotFoundError(
            f"config file not found: {config_name} "
            "(pass --config_name pointing at a TrainingConfig json)")
    device = resolve_device(device)
    config = TrainingConfig.from_json(config_name)
    rank = 0
    if devices > 1 and not profile:
        if int((config.mesh_shape or {}).get("graph", 1)) > 1:
            check_graph_axis_model(config)    # before any rank spawns
        if not dist.is_initialized():
            if device.type == "cuda" and \
                    devices > torch.cuda.device_count():
                raise ValueError(
                    f"--devices {devices} with {torch.cuda.device_count()} "
                    f"visible GPU(s): NCCL refuses two ranks on one device "
                    f'(ROADMAP.md §1 "Not ported, by decision")')
            if "WORLD_SIZE" not in os.environ:
                return _spawn_ranks(devices, kwargs)
            initialize_distributed(device=device)     # a torchrun rank
        if dist.get_world_size() != devices:
            raise ValueError(f"--devices {devices} in a group of "
                             f"{dist.get_world_size()} ranks")
        rank = dist.get_rank()
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    if classification_threshold is not None:
        config.classification_threshold = float(classification_threshold)
    if output_dir is not None:
        config.output_dir = output_dir
    if batch_size is not None:
        config.batch_size = int(batch_size)
    if epochs is not None:
        config.epochs = int(epochs)

    m = config.model
    train_grad = getattr(m, "calculate_gradient", False) and \
        getattr(m, "gradwise_weight", 0) != 0
    train_stress = getattr(m, "calculate_gradient", False) and \
        getattr(m, "stresswise_weight", 0) != 0
    train_atom = getattr(m, "atomwise_weight", 0) != 0
    train_additional = getattr(m, "additional_output_features", 0) > 0 and \
        getattr(m, "additional_output_weight", 0) != 0
    records = load_folder_records(
        root_dir, target_key=target_key, id_key=id_key,
        atomwise_key=atomwise_key, gradwise_key=gradwise_key,
        stresswise_key=stresswise_key,
        additional_output_key=additional_output_key,
        file_format=file_format, train_atom=train_atom,
        train_grad=train_grad, train_stress=train_stress,
        train_additional_output=train_additional)
    print("len dataset", len(records))

    # a multi-output csv sets the model's output width
    if isinstance(records[0]["target"], list):
        widths = {len(r["target"]) for r in records}
        if len(widths) != 1:
            raise ValueError("Make sure the outputs are of same size.")
        config.model = dataclasses.replace(
            config.model, output_features=widths.pop())

    # ranks other than 0 build their loaders after rank 0 has, from its
    # graph cache where there is one, and write their copies of the split
    # files (ids, mad, baseline) to a directory of their own
    sharded = devices > 1 and not profile
    # a (data, graph) mesh: the ranks of a data row share its shard
    g_size = int((config.mesh_shape or {}).get("graph", 1))
    split_dir = config.output_dir
    if sharded and rank > 0:
        dist.barrier()
        split_dir = tempfile.mkdtemp(prefix=f"rank{rank}_splits_")
    tr, va, te, _mad = get_train_val_loaders(
        records,
        id_tag=id_key,
        atom_features=config.atom_features,
        neighbor_strategy=config.neighbor_strategy,
        cutoff=config.cutoff,
        cutoff_extra=config.cutoff_extra,
        max_neighbors=config.max_neighbors,
        use_canonize=config.use_canonize,
        compute_line_graph=config.compute_line_graph,
        batch_size=config.batch_size,
        split_seed=config.random_seed or 123,
        train_ratio=config.train_ratio,
        val_ratio=config.val_ratio,
        test_ratio=config.test_ratio,
        n_train=config.n_train,
        n_val=config.n_val,
        n_test=config.n_test,
        keep_data_order=config.keep_data_order,
        classification_threshold=config.classification_threshold,
        target_multiplication_factor=config.target_multiplication_factor,
        standard_scalar_and_pca=config.standard_scalar_and_pca,
        output_dir=split_dir,
        num_workers=config.num_workers,
        target_width=getattr(config.model, "output_features", 1),
        atomwise_width=getattr(m, "atomwise_output_features", 0),
        additional_width=getattr(m, "additional_output_features", 0),
        extra_width=getattr(m, "extra_features", 0),
        bucket_slack=config.bucket_slack,
        dense=config.dense_neighborhoods,
        cache_dir=(os.path.join(config.output_dir, "graph_cache")
                   if config.use_cache else None),
        per_species_energy_baseline=config.per_species_energy_baseline,
        lg_cutoff=config.lg_cutoff,
        device=device,
        num_shards=max(devices // g_size, 1),
        shard_index=rank // g_size,
    )
    if sharded and rank == 0:
        dist.barrier()
    elif sharded:
        shutil.rmtree(split_dir, ignore_errors=True)
    if profile:
        return _profile(config, tr, profile)
    restart_state_path = None
    if resume:
        restart_state_path = (os.path.join(config.output_dir, "restart.mpk")
                              if resume == "auto" else resume)
        if not os.path.exists(restart_state_path):
            print(f"[resume] no checkpoint at {restart_state_path}; "
                  f"starting fresh")
            restart_state_path = None
    if sharded:
        from alignn_tpu_torch.parallel.dp import train_model_dp

        summary = train_model_dp(config, tr, va, te, n_devices=devices,
                                 restart_params_path=restart_model_path,
                                 restart_state_path=restart_state_path)
    else:
        summary = train_model(config, tr, va, te,
                              restart_params_path=restart_model_path,
                              restart_state_path=restart_state_path)
    summary["graph_stats"] = tr.graph_stats
    return summary


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_ranks(devices: int, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Run :func:`train_for_folder` on `devices` spawned ranks; rank 0's
    summary (without its ``state``)."""
    import torch.multiprocessing as mp

    queue = mp.get_context("spawn").SimpleQueue()
    ranks = mp.start_processes(_rank_main, args=(devices, _free_port(),
                                                 kwargs, queue),
                               nprocs=devices, start_method="spawn",
                               join=False)
    summary = None
    done = False
    while not done:     # read while joining: a large put would block
        done = ranks.join(timeout=1.0)    # raises if a rank failed
        if summary is None and not queue.empty():
            summary = queue.get()
    return summary


def _rank_main(rank: int, world: int, port: int, kwargs: Dict[str, Any],
               queue) -> None:
    """One spawned rank: join the group, train, hand rank 0's summary
    back."""
    device = resolve_device(kwargs["device"])
    if device.type == "cpu":   # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    initialize_distributed(f"localhost:{port}", world, rank, device=device)
    try:
        summary = train_for_folder(**kwargs)
        if rank == 0:
            queue.put({k: v for k, v in summary.items() if k != "state"})
    finally:
        dist.destroy_process_group()


def _profile(config: TrainingConfig, train_loader, logdir: str
             ) -> Dict[str, Any]:
    """One compiled train step profiled on the first training batch, as
    the trainer would build it (seeded weights in the config's compute
    dtype, its optimizer and decay mask)."""
    import torch

    from alignn_tpu_torch.nn.models import init_parameters
    from alignn_tpu_torch.profiler import profile_step
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import (create_train_state,
                                              make_train_step)
    from alignn_tpu_torch.train.trainer import COMPUTE_DTYPES, build_model

    model = init_parameters(
        build_model(config.model, dtype=COMPUTE_DTYPES[config.dtype]),
        torch.Generator().manual_seed(config.random_seed or 123))
    batch = next(iter(train_loader))
    state = create_train_state(model, batch, build_optimizer(
        config.optimizer, config.learning_rate, config.weight_decay,
        model=model))
    classification = config.classification_threshold is not None or \
        getattr(config.model, "classification", False)
    step = make_train_step(model, criterion=config.criterion,
                           classification=classification)
    spec = train_loader.spec
    edges = (spec.n_edges + spec.n_lg_edges) if spec else None
    result = profile_step(step, state, batch, logdir=logdir,
                          edges_per_batch=edges)
    print(result)
    return result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="alignn_tpu_torch training (folder mode)")
    p.add_argument("--root_dir", default="./",
                   help="folder with id_prop.csv/json and structure files")
    p.add_argument("--config_name", default="config.json")
    p.add_argument("--file_format", default="poscar",
                   choices=["poscar", "cif", "xyz", "pdb"])
    p.add_argument("--classification_threshold", default=None, type=float)
    p.add_argument("--batch_size", default=None, type=int)
    p.add_argument("--epochs", default=None, type=int)
    p.add_argument("--id_key", default="jid")
    p.add_argument("--target_key", default="total_energy")
    p.add_argument("--atomwise_key", default="forces")
    p.add_argument("--force_key", default="forces", dest="gradwise_key")
    p.add_argument("--stresswise_key", default="stresses")
    p.add_argument("--additional_output_key", default="additional_output")
    p.add_argument("--output_dir", default=None)
    p.add_argument("--restart_model_path", default=None,
                   help="start from the weights of this .mpk")
    p.add_argument("--resume", default=None,
                   help='whole-state resume: "auto" = '
                        "<output_dir>/restart.mpk, or a path")
    p.add_argument("--devices", default=1, type=int,
                   help="data-parallel ranks, one a device (NCCL on the "
                        "card, gloo with --device cpu)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="profile one compiled train step on the first "
                        "training batch (torch.profiler trace in "
                        "DIR/trace.json) instead of training")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda or cpu)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return train_for_folder(
        root_dir=args.root_dir,
        config_name=args.config_name,
        classification_threshold=args.classification_threshold,
        batch_size=args.batch_size,
        epochs=args.epochs,
        id_key=args.id_key,
        target_key=args.target_key,
        atomwise_key=args.atomwise_key,
        gradwise_key=args.gradwise_key,
        stresswise_key=args.stresswise_key,
        additional_output_key=args.additional_output_key,
        file_format=args.file_format,
        restart_model_path=args.restart_model_path,
        resume=args.resume,
        output_dir=args.output_dir,
        devices=args.devices,
        profile=args.profile,
        device=args.device,
    )


if __name__ == "__main__":
    main(sys.argv[1:])
