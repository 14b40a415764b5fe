#!/usr/bin/env python
"""Cross-prediction split files between two datasets/targets (counterpart
of ``alignn_tpu/scripts/make_test_split_cross_pred.py``).

Fixes a common id split so that models trained on target A can be
evaluated on the same test ids for target B.
"""

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--records_json", required=True)
    p.add_argument("--id_tag", default="jid")
    p.add_argument("--split_seed", type=int, default=123)
    p.add_argument("--train_ratio", type=float, default=0.8)
    p.add_argument("--val_ratio", type=float, default=0.1)
    p.add_argument("--test_ratio", type=float, default=0.1)
    p.add_argument("--output", default="cross_pred_split.json")
    args = p.parse_args(argv)

    from alignn_tpu_torch.data.splits import get_id_train_val_test

    with open(args.records_json) as f:
        records = json.load(f)
    tr, va, te = get_id_train_val_test(
        total_size=len(records), split_seed=args.split_seed,
        train_ratio=args.train_ratio, val_ratio=args.val_ratio,
        test_ratio=args.test_ratio, keep_data_order=False)
    ids = [r[args.id_tag] for r in records]
    with open(args.output, "w") as f:
        json.dump({"id_train": [ids[i] for i in tr],
                   "id_val": [ids[i] for i in va],
                   "id_test": [ids[i] for i in te]}, f)
    print(f"wrote {args.output}: {len(tr)}/{len(va)}/{len(te)}")


if __name__ == "__main__":
    main()
