"""One gloo rank of alignn_tpu_torch's graph-parallel paths on a 2 x 2 mesh.

    python tests/torch_port_gp_worker.py RANK WORLD PORT OUTDIR

Four ranks form the ("data", "graph") mesh of shape (2, 2); data row d
holds micro-batch d of :func:`micro_batches` (sparse and dense).  With the
weights of ``OUTDIR/init.mpk`` each rank runs, and writes to
``OUTDIR/rank<RANK>.npz``:

- the ring-GP E/F/S forward of its row's batch over the row's graph axis,
  in chain and in gather mode, and one train step of the 1-D graph mesh
  (its gradients, before the update, and losses);
- the same for the dense-halo forward and train step;
- one data x graph train step, sparse (ring) and dense (halo), whose
  gradients average the two rows;
- ``ring_broadcast`` against the chain of shifts: values, gradients and
  gradients of gradients, and ``all_gather``'s gradient;
- ``edges_per_second_scaling`` on the first one and two ranks;
- folder training through ``cli.train``'s ``train_for_folder`` on the
  2 x 2 mesh (:func:`folder_runs`).

``tests/test_torch_port_gp.py`` holds them against JAX's single-device
model.  Imports no jax.
"""

import dataclasses
import os
import sys

import numpy as np

MODEL = {"name": "alignn_atomwise", "alignn_layers": 1, "gcn_layers": 1,
         "hidden_features": 32, "embedding_features": 16,
         "graphwise_weight": 1.0, "gradwise_weight": 10.0,
         "stresswise_weight": 0.1}
CELLS_PER_ROW = 2


def micro_batches(device="cpu"):
    """([sparse batch of row 0, row 1], [dense batch of row 0, row 1]):
    rattled rocksalt cells, one bucket for both rows."""
    import torch

    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.graph.build import rocksalt_graphs
    from alignn_tpu_torch.graph.dense import (dense_batch_graphs,
                                              dense_spec_for_graphs)

    graphs = rocksalt_graphs(2 * CELLS_PER_ROW, seed=11, rattle=0.05)
    rows = [graphs[:CELLS_PER_ROW], graphs[CELLS_PER_ROW:]]
    spec = BucketSpec.for_graphs(graphs, CELLS_PER_ROW)
    dspec = dense_spec_for_graphs(graphs, CELLS_PER_ROW)
    dev = torch.device(device)
    return ([batch_graphs(r, spec, dev) for r in rows],
            [dense_batch_graphs(r, dspec, dev) for r in rows], rows,
            (spec, dspec))


def grads_of(model) -> dict:
    return {f"g/{k}": p.grad.detach().numpy().copy()
            for k, p in model.named_parameters()}


def main(rank: int, world: int, port: int, outdir: str) -> None:
    import torch
    import torch.distributed as dist

    from alignn_tpu_torch.config import model_config_from_dict
    from alignn_tpu_torch.nn.convert import state_dict_from_flax
    from alignn_tpu_torch.nn.models import ALIGNNAtomWise
    from alignn_tpu_torch.parallel import mesh as meshlib
    from alignn_tpu_torch.parallel.dense_gp import (
        make_dense_gp_forward, make_dp_dense_gp_train_step)
    from alignn_tpu_torch.parallel.dp_gp import make_dp_gp_train_step
    from alignn_tpu_torch.parallel.graph_parallel import (
        edges_per_second_scaling, make_gp_forward)
    from alignn_tpu_torch.train.checkpoint import load_params_with_meta
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import create_train_state

    torch.set_num_threads(1)
    meshlib.initialize_distributed(f"localhost:{port}", world, rank,
                                   device="cpu")
    mesh = meshlib.make_mesh(world, ("data", "graph"), (2, 2))
    row = mesh.axis("data").index
    row_mesh = dataclasses.replace(mesh, axis_names=("graph",),
                                   shape=(2,),
                                   axes={"graph": mesh.axis("graph")})
    cfg = model_config_from_dict(MODEL)
    params, _s, _m = load_params_with_meta(os.path.join(outdir,
                                                        "init.mpk"))
    weights = state_dict_from_flax(params)
    sparse, dense, _rows, _specs = micro_batches()
    out = {}

    def fresh():
        model = ALIGNNAtomWise(cfg)
        model.load_state_dict(weights)
        return model

    def train(name, make_step, batch, on_mesh):
        model = fresh()
        state = create_train_state(model, batch,
                                   build_optimizer("adamw", 1e-3, 1e-5))
        _state, losses = make_step(model, on_mesh)(state, batch)
        out.update({f"{name}/{k}": v for k, v in grads_of(model).items()})
        out[f"{name}/losses"] = np.asarray([float(losses[k]) for k in
                                            sorted(losses)])

    try:
        for mode in ("chain", "gather"):
            os.environ["ALIGNN_TPU_GP_RING"] = mode
            fo, ff, fs = make_gp_forward(fresh(), row_mesh)(sparse[row])
            out.update({f"ring_{mode}/out": fo.numpy(),
                        f"ring_{mode}/forces": ff.numpy(),
                        f"ring_{mode}/stress": fs.numpy()})
            train(f"ring_{mode}_step", make_dp_gp_train_step,
                  sparse[row], row_mesh)
        os.environ.pop("ALIGNN_TPU_GP_RING")
        fo, ff, fs = make_dense_gp_forward(fresh(), row_mesh)(dense[row])
        out.update({"dense/out": fo.numpy(), "dense/forces": ff.numpy(),
                    "dense/stress": fs.numpy()})
        train("dense_step", make_dp_dense_gp_train_step, dense[row],
              row_mesh)
        train("dp_ring_step", make_dp_gp_train_step, sparse[row], mesh)
        train("dp_dense_step", make_dp_dense_gp_train_step, dense[row],
              mesh)
        out.update(collectives(mesh.axis("graph"), rank))
        rates = edges_per_second_scaling(fresh(), sparse[row], (1, 2), 1)
        out["edges_per_second"] = np.asarray([rates.get(n, 0.0)
                                              for n in (1, 2)])
        folder_runs(rank, outdir)
        out["loss_keys"] = np.asarray(sorted(
            ["loss", "loss1", "loss2", "loss3", "loss4", "loss5"]))
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def folder_runs(rank: int, outdir: str) -> None:
    """``train_for_folder(devices=4)`` in this group on
    ``OUTDIR/folder`` with ``OUTDIR/config_<layout>.json`` (a 2 x 2
    mesh_shape), into a directory of the rank's own; which GP step the
    trainer took, its step losses and what the rank wrote, in
    ``OUTDIR/folder_rank<RANK>.json``."""
    import json

    from alignn_tpu_torch.cli.train import train_for_folder
    from alignn_tpu_torch.parallel import dense_gp, dp_gp

    made = []

    def tap(name, make):
        def wrapped(*a, **kw):
            made.append(name)
            return make(*a, **kw)
        return wrapped

    dp_gp.make_dp_gp_train_step = tap("ring", dp_gp.make_dp_gp_train_step)
    dense_gp.make_dp_dense_gp_train_step = tap(
        "dense", dense_gp.make_dp_dense_gp_train_step)
    listing = {}
    for layout in ("sparse", "dense"):
        run = os.path.join(outdir, f"folder_{layout}_rank{rank}")
        summary = train_for_folder(
            root_dir=os.path.join(outdir, "folder"),
            config_name=os.path.join(outdir, f"config_{layout}.json"),
            target_key="total_energy", output_dir=run, devices=4,
            device="cpu")
        listing[layout] = {
            "step": made[-1], "step_losses": summary["step_losses"],
            "files": sorted(os.listdir(run)) if os.path.isdir(run) else []}
    with open(os.path.join(outdir, f"folder_rank{rank}.json"), "w") as f:
        json.dump(listing, f)


def collectives(axis, rank: int) -> dict:
    """ring_broadcast and the chain of ring shifts on the same input: the
    values, the gradient of sum(w * y^2) and the gradient of <grad, v>;
    and all_gather's gradient of sum(w * y)."""
    import torch

    from alignn_tpu_torch.parallel.gp_model import ring_broadcast
    from alignn_tpu_torch.parallel.mesh import all_gather, ring_shift

    gen = torch.Generator().manual_seed(100 + rank)
    x0 = torch.randn(5, 3, generator=gen, dtype=torch.float64)
    w = torch.randn(axis.size, 5, 3, generator=gen, dtype=torch.float64)
    v = torch.randn(5, 3, generator=gen, dtype=torch.float64)
    res = {}
    for name in ("broadcast", "chain"):
        x = x0.clone().requires_grad_(True)
        if name == "broadcast":
            y = ring_broadcast(x, axis)
        else:
            ys = [x]
            for _ in range(1, axis.size):
                ys.append(ring_shift(ys[-1], axis, 1))
            y = torch.stack(ys)
        (g,) = torch.autograd.grad((w * y * y).sum(), x, create_graph=True)
        (gg,) = torch.autograd.grad((g * v).sum(), x)
        res.update({f"{name}/y": y.detach().numpy(),
                    f"{name}/g": g.detach().numpy(),
                    f"{name}/gg": gg.numpy()})
    x = x0.clone().requires_grad_(True)
    y = all_gather(x, axis)
    (g,) = torch.autograd.grad((w.reshape(-1, 3) * y).sum(), x)
    res.update({"all_gather/y": y.detach().numpy(),
                "all_gather/g": g.numpy(), "inputs/x": x0.numpy(),
                "inputs/w": w.numpy(), "inputs/v": v.numpy()})
    return res


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
