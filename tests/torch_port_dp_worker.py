"""One gloo rank of alignn_tpu_torch's data-parallel train step.

    python tests/torch_port_dp_worker.py RANK WORLD PORT OUTDIR

For each case of :data:`CASES` the rank reads the initial weights
``OUTDIR/<case>.mpk``, trains one epoch (2 steps) of
``make_dp_train_step`` on its shard of :func:`dataset`
(``BucketedLoader(num_shards=WORLD, shard_index=RANK)``) and writes its
losses, parameters and BatchNorm statistics to
``OUTDIR/<case>_rank<RANK>.npz``.  ``tests/test_torch_port_dp.py`` holds
them against JAX's ``make_dp_train_step`` on a 2-device mesh.  Then it
runs ``train_model_dp`` for one epoch of the property case with the
output directory ``OUTDIR/run_rank<RANK>`` and lists what each rank wrote
there in ``OUTDIR/run_rank<RANK>.json``.  Imports no jax.
"""

import json
import os
import sys

import numpy as np

MODEL = {"alignn_layers": 1, "gcn_layers": 1, "hidden_features": 32,
         "embedding_features": 16}
# case: (model config, optimizer, learning rate).  The property model
# (BatchNorm: the statistics and their gradient cross the ranks) takes SGD:
# its biases that feed a BatchNorm have a gradient of 0 but for rounding,
# which AdamW would scale up to steps of about lr in either package.
CASES = {
    "property": ({"name": "alignn", **MODEL}, "sgd", 0.05),
    "efs": ({"name": "alignn_atomwise", **MODEL, "graphwise_weight": 1.0,
             "gradwise_weight": 10.0, "stresswise_weight": 0.1},
            "adamw", 1e-3),
}
N_CELLS, BATCH, WD = 16, 4, 1e-5     # 2 steps an epoch on 2 ranks


def dataset():
    """(graphs, ids): 16 labelled rattled rocksalt cells."""
    from alignn_tpu_torch.graph.build import rocksalt_graphs

    graphs = rocksalt_graphs(N_CELLS, seed=3, rattle=0.03)
    return graphs, [f"cell-{i}" for i in range(N_CELLS)]


def flat_state(model) -> dict:
    """{"p/<path>" or "s/<path>": array} of the model's flax trees."""
    from alignn_tpu_torch.nn.convert import flax_from_module

    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out[prefix + k] = np.asarray(v)

    params, stats = flax_from_module(model)
    walk(params, "p/")
    walk(stats, "s/")
    return out


def main(rank: int, world: int, port: int, outdir: str) -> None:
    import torch
    import torch.distributed as dist

    from alignn_tpu_torch.config import model_config_from_dict
    from alignn_tpu_torch.data.dataset import GraphDataset
    from alignn_tpu_torch.data.loader import BucketedLoader
    from alignn_tpu_torch.nn.convert import state_dict_from_flax
    from alignn_tpu_torch.parallel.dp import make_dp_train_step
    from alignn_tpu_torch.parallel.mesh import (initialize_distributed,
                                                make_mesh)
    from alignn_tpu_torch.train.checkpoint import load_params_with_meta
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import create_train_state
    from alignn_tpu_torch.train.trainer import build_model

    torch.set_num_threads(2)
    initialize_distributed(f"localhost:{port}", world, rank, device="cpu")
    mesh = make_mesh(world)
    graphs, ids = dataset()
    try:
        for case, (cfg, opt, lr) in CASES.items():
            model = build_model(model_config_from_dict(cfg),
                                group=mesh.group)
            params, stats, _ = load_params_with_meta(
                os.path.join(outdir, f"{case}.mpk"))
            model.load_state_dict(state_dict_from_flax(
                params, batch_stats=stats))
            loader = BucketedLoader(
                GraphDataset(graphs, ids), BATCH, shuffle=True,
                num_shards=world, shard_index=rank, prefetch=0,
                device="cpu")
            step = make_dp_train_step(model, mesh)
            state = None
            losses = []
            for batch in loader:
                if state is None:
                    state = create_train_state(model, batch, build_optimizer(
                        opt, lr, WD))
                state, out = step(state, batch)
                losses.append([float(out[k]) for k in sorted(out)])
            np.savez(os.path.join(outdir, f"{case}_rank{rank}.npz"),
                     losses=np.asarray(losses),
                     loss_keys=np.asarray(sorted(out)),
                     ids=np.asarray(loader.batch_ids()),
                     **flat_state(model))
        run_trainer(rank, world, outdir, graphs, ids)
    finally:
        dist.destroy_process_group()


def run_trainer(rank: int, world: int, outdir: str, graphs, ids) -> None:
    """One epoch of ``train_model_dp`` (8 train cells, 4 val, 4 test) into
    a directory of this rank's own; what the rank wrote, listed."""
    from alignn_tpu_torch.config import TrainingConfig
    from alignn_tpu_torch.data.dataset import GraphDataset
    from alignn_tpu_torch.data.loader import BucketedLoader
    from alignn_tpu_torch.parallel.dp import train_model_dp

    run = os.path.join(outdir, f"run_rank{rank}")
    config = TrainingConfig.from_dict({
        "epochs": 1, "batch_size": BATCH, "model": CASES["property"][0],
        "output_dir": run, "n_early_stopping": 1})

    def loader(lo, hi, batch, **kw):
        return BucketedLoader(GraphDataset(graphs[lo:hi], ids[lo:hi]),
                              batch, device="cpu", prefetch=0, **kw)

    summary = train_model_dp(
        config, loader(0, 8, BATCH, shuffle=True, num_shards=world,
                       shard_index=rank),
        loader(8, 12, BATCH), loader(12, 16, 1))
    with open(run + ".json", "w") as f:
        json.dump({"files": sorted(os.listdir(run)),
                   "step_losses": summary["step_losses"]}, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
