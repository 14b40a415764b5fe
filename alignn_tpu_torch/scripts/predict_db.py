#!/usr/bin/env python
"""Bulk prediction over a dataset with a trained model (counterpart of
``alignn_tpu/scripts/predict_db.py``): load records (a dataset name from
the local cache, or a local json of records), run the trained checkpoint
over every structure, dump an id -> prediction json.
"""

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_dir", required=True,
                   help="training output dir (config.json + best_model.mpk)")
    p.add_argument("--dataset", default=None,
                   help="dataset name (data/figshare.py, from the cache)")
    p.add_argument("--records_json", default=None,
                   help="local json list of records instead of --dataset")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--output", default="predictions_db.json")
    p.add_argument("--device", default=None,
                   help="torch device of the model (default cuda)")
    args = p.parse_args(argv)

    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.zoo import load_model_dir, predict_structures

    if args.records_json:
        with open(args.records_json) as f:
            records = json.load(f)
    elif args.dataset:
        from alignn_tpu_torch.data.figshare import load_dataset

        records = load_dataset(args.dataset)
    else:
        raise SystemExit("need --dataset or --records_json")
    if args.limit:
        records = records[: args.limit]

    model, _cfg = load_model_dir(args.model_dir, args.device)
    atoms_list = [Atoms.from_dict(rec["atoms"]) for rec in records]
    preds = predict_structures(model, atoms_list)
    out = {rec.get("jid", str(i)): preds[i].tolist()
           for i, rec in enumerate(records)}
    with open(args.output, "w") as f:
        json.dump(out, f)
    print(f"wrote {args.output} ({len(out)} predictions)")
    return out


if __name__ == "__main__":
    main()
