#!/usr/bin/env python
"""Train the same target with cgcnn and with cfid atom features and
compare (counterpart of ``alignn_tpu/scripts/compare_cfid.py``).
"""

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--records_json", required=True)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--output_dir", default="cfid_compare")
    p.add_argument("--device", default=None,
                   help="torch device to train on (default cuda)")
    args = p.parse_args(argv)

    from alignn_tpu_torch.config import TrainingConfig
    from alignn_tpu_torch.data.loader import get_train_val_loaders
    from alignn_tpu_torch.nn.models import ALIGNNConfig
    from alignn_tpu_torch.train.trainer import train_model

    with open(args.records_json) as f:
        records = json.load(f)
    results = {}
    for feats, width in (("cgcnn", 92), ("cfid", 438)):
        out = f"{args.output_dir}/{feats}"
        cfg = TrainingConfig(
            epochs=args.epochs, batch_size=args.batch_size,
            atom_features=feats, output_dir=out,
            model=ALIGNNConfig(name="alignn",
                               atom_input_features=width))
        tr, va, te, mad = get_train_val_loaders(
            records, batch_size=args.batch_size, atom_features=feats,
            output_dir=out, device=args.device)
        summary = train_model(cfg, tr, va, te)
        results[feats] = {"test_mae": summary.get("test_mae"),
                          "mad": mad}
        print(feats, results[feats])
    with open(f"{args.output_dir}/comparison.json", "w") as f:
        json.dump(results, f)
    return results


if __name__ == "__main__":
    main()
