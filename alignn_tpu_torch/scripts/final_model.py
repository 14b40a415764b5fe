#!/usr/bin/env python
"""Train a deployment model on (almost) all data (counterpart of
``alignn_tpu/scripts/final_model.py``): after model selection, retrain
with about all records as train (a small val split for early stopping,
no test holdout).
"""

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--records_json", required=True)
    p.add_argument("--config", default=None,
                   help="TrainingConfig json overrides")
    p.add_argument("--output_dir", default="final_model")
    p.add_argument("--val_frac", type=float, default=0.02)
    p.add_argument("--device", default=None,
                   help="torch device to train on (default cuda)")
    args = p.parse_args(argv)

    from alignn_tpu_torch.config import TrainingConfig
    from alignn_tpu_torch.data.loader import get_train_val_loaders
    from alignn_tpu_torch.train.trainer import train_model

    with open(args.records_json) as f:
        records = json.load(f)
    overrides = {}
    if args.config:
        with open(args.config) as f:
            overrides = json.load(f)
    n = len(records)
    n_val = max(int(n * args.val_frac), 1)
    n_train = n - n_val - 1
    overrides.update(dict(n_train=n_train, n_val=n_val, n_test=1,
                          output_dir=args.output_dir))
    cfg = TrainingConfig(**overrides)
    tr, va, te, _ = get_train_val_loaders(
        records, batch_size=cfg.batch_size, n_train=n_train, n_val=n_val,
        n_test=1, keep_data_order=cfg.keep_data_order,
        neighbor_strategy=cfg.neighbor_strategy, cutoff=cfg.cutoff,
        max_neighbors=cfg.max_neighbors, output_dir=args.output_dir,
        device=args.device)
    summary = train_model(cfg, tr, va, te)
    print(json.dumps({k: v for k, v in summary.items() if k != "state"},
                     default=str))
    return summary


if __name__ == "__main__":
    main()
