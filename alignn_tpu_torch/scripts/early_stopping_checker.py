"""Early-stopping checker (counterpart of
``alignn_tpu/scripts/early_stopping_checker.py``).

Reads history_val.json from a (possibly running) training output dir and
reports whether validation has stopped improving for N epochs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _losses(history_val) -> list:
    return [row[0] if isinstance(row, list) else row for row in history_val]


def should_stop(history_val, patience: int = 50) -> bool:
    """True if the best val loss is older than `patience` epochs."""
    losses = _losses(history_val)
    if len(losses) <= patience:
        return False
    best_epoch = min(range(len(losses)), key=lambda i: losses[i])
    return (len(losses) - 1 - best_epoch) >= patience


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--output_dir", default=".")
    p.add_argument("--patience", default=50, type=int)
    args = p.parse_args(argv)
    path = os.path.join(args.output_dir, "history_val.json")
    if not os.path.exists(path):
        print(json.dumps({"stop": False, "reason": "no history yet"}))
        return 0
    with open(path) as f:
        hist = json.load(f)
    losses = _losses(hist)
    print(json.dumps({"stop": should_stop(hist, args.patience),
                      "epochs": len(losses),
                      "best_val": min(losses) if losses else None,
                      "patience": args.patience}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
