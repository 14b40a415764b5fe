"""Prediction CLI (counterpart of ``alignn_tpu/cli/predict.py``).

    python -m alignn_tpu_torch.cli.predict --model_path out \
        --file_path POSCAR [--device cpu]

Predicts with a local trained model directory for one structure file or
every file of a folder, one JSON line each.  ``--list_models`` prints the
reference zoo's names; zoo models are not downloaded here, so
``--model_path`` is required to predict.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from alignn_tpu_torch.data.dataset import STRUCTURE_READERS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="alignn_tpu_torch prediction")
    p.add_argument("--model_path", default=None,
                   help="local trained model directory")
    p.add_argument("--file_path", default="POSCAR",
                   help="a structure file, or a folder of them")
    p.add_argument("--file_format", default="poscar",
                   choices=sorted(STRUCTURE_READERS))
    p.add_argument("--cutoff", default=8.0, type=float)
    p.add_argument("--max_neighbors", default=12, type=int)
    p.add_argument("--batch_size", default=32, type=int)
    p.add_argument("--list_models", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (cuda or cpu)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from alignn_tpu_torch.zoo import (get_all_models, load_model_dir,
                                      predict_structures)

    if args.list_models:
        for name, meta in sorted(get_all_models().items()):
            print(name, meta["output_features"])
        return None
    if not args.model_path:
        raise SystemExit("--model_path is required: zoo models are not "
                         "downloaded (see --list_models for their names)")
    model, _cfg = load_model_dir(args.model_path, args.device)
    if os.path.isdir(args.file_path):
        files = sorted(glob.glob(os.path.join(args.file_path, "*")))
    else:
        files = [args.file_path]
    atoms_list = [STRUCTURE_READERS[args.file_format](f) for f in files]
    out = predict_structures(model, atoms_list, cutoff=args.cutoff,
                             max_neighbors=args.max_neighbors,
                             batch_size=args.batch_size)
    rows = [{"file": f, "prediction": o.tolist()} for f, o in zip(files, out)]
    for row in rows:
        print(json.dumps(row))
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
