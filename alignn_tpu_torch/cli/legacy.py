"""Legacy config-file training CLI (counterpart of
``alignn_tpu/cli/legacy.py``, the reference's ``alignn/cli.py``).

Trains straight from a TrainingConfig json whose ``dataset`` is read by
name from the local dataset cache (:func:`~alignn_tpu_torch.data.
figshare.load_dataset`), into a scratch ``--checkpoint_dir``, then writes
``metrics.json`` (the training summary; the reference torch.saves it as
metrics.pt) and ``fullconfig.json`` (the resolved config) beside the
config file and copies the ``.mpk`` checkpoints there.  ``--profile``
profiles one compiled train step instead of training (trace under
``<config dir>/torch_trace``).

    python -m alignn_tpu_torch.cli.legacy [config.json] [--progress]
        [--checkpoint_dir DIR] [--profile] [--tensorboard] [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys


def _loaders(config, device):
    """The three loaders of the config's dataset, read by name."""
    from alignn_tpu_torch.data.figshare import load_dataset
    from alignn_tpu_torch.data.loader import get_train_val_loaders

    records = load_dataset(config.dataset)
    for r in records:
        r["target"] = r.get(config.target)
    return get_train_val_loaders(
        records, target="target", id_tag=config.id_tag,
        atom_features=config.atom_features,
        neighbor_strategy=config.neighbor_strategy,
        cutoff=config.cutoff, max_neighbors=config.max_neighbors,
        batch_size=config.batch_size, n_train=config.n_train,
        n_val=config.n_val, n_test=config.n_test,
        train_ratio=config.train_ratio, val_ratio=config.val_ratio,
        test_ratio=config.test_ratio,
        keep_data_order=config.keep_data_order,
        output_dir=config.output_dir, num_workers=config.num_workers,
        device=device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config", nargs="?", default=None,
                   help="TrainingConfig json (default: a small built-in "
                        "smoke config, reference cli.py:38)")
    p.add_argument("--progress", action="store_true")
    p.add_argument("--checkpoint_dir", default="/tmp/models")
    p.add_argument("--store_outputs", action="store_true")
    p.add_argument("--tensorboard", action="store_true",
                   help="accepted for the reference's surface; traces go "
                        "through --profile instead")
    p.add_argument("--profile", action="store_true",
                   help="profile one train step instead of training "
                        "(reference profile_dgl route, cli.py:46-48)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda or cpu)")
    args = p.parse_args(argv)

    from alignn_tpu_torch import resolve_device
    from alignn_tpu_torch.config import TrainingConfig

    device = resolve_device(args.device)
    if args.config is None:
        model_dir = os.getcwd()
        config = TrainingConfig(epochs=10, n_train=32, n_val=32,
                                batch_size=16)
    else:
        model_dir = os.path.dirname(os.path.abspath(args.config))
        with open(args.config) as f:
            config = TrainingConfig(**json.load(f))
    if args.tensorboard:
        print("tensorboard logging is not supported; use --profile "
              "(torch.profiler traces)", file=sys.stderr)
    config.progress = args.progress or config.progress
    config.store_outputs = args.store_outputs or config.store_outputs
    # train into the scratch directory, then copy back (cli.py:67-70)
    config.output_dir = args.checkpoint_dir
    os.makedirs(args.checkpoint_dir, exist_ok=True)

    train_loader, val_loader, test_loader, _mad = _loaders(config, device)
    if args.profile:
        from alignn_tpu_torch.cli.train import _profile

        return _profile(config, train_loader,
                        os.path.join(model_dir, "torch_trace"))

    from alignn_tpu_torch.train.trainer import train_model

    hist = train_model(config, train_loader, val_loader, test_loader)
    metrics = {k: v for k, v in hist.items() if k != "state"}
    with open(os.path.join(model_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f, default=str)
    with open(os.path.join(model_dir, "fullconfig.json"), "w") as f:
        json.dump(config.to_dict(), f, indent=2, default=str)
    if os.path.abspath(args.checkpoint_dir) != os.path.abspath(model_dir):
        for ckpt in glob.glob(os.path.join(args.checkpoint_dir, "*.mpk")):
            shutil.copy(ckpt, os.path.join(model_dir,
                                           os.path.basename(ckpt)))
    return hist


if __name__ == "__main__":
    main()
