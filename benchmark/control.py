"""The controls of ``correct``: the reference put in the program's place,
computed in the nearest precision below the configuration's (TF32
products for the f32 cells), and judged by each cell's own comparison
against the f32 reference.  The benchmark's runs never run it.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]

prints one JSON line a seed with the numbers the cell compares, on the
card at the cell's own sizes: the first three training steps on the
first three batches of the seed's data set, from the seed's weights.
``--mode half_batch`` plants a fault in the reference instead: half of
each batch left out, the mean taken over the rest.

``--window`` (training) runs the cell itself with a one-epoch window on
each seed, and reads the control and the half-batch fault for the
window's first three steps, from the program's state where the window
began; each line also carries the run's own readings (``program``).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import tempfile

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))


def train_readings(cell, seed: int, mode: str) -> dict:
    import torch

    from entries import train as etrain
    from reference import model as rmodel
    from reference import train as rtrain

    t, tr = cell.traffic, cell.config["training"]
    prop = cell.model_cfg["name"] == "alignn"
    gen = importlib.import_module(f"traffic.{t['generator']}")
    structures = gen.training_set(t["dataset"], seed)
    bsz = tr["batch_size"]
    g = torch.Generator(device=cell.device).manual_seed(seed)
    params0 = rmodel.init_params(cell.model_cfg, prop, g, cell.device)
    lr = rtrain.epoch_lr(tr["scheduler"], tr["learning_rate"],
                         t["warm_epochs"] + t["max_window_epochs"], 0,
                         t["dataset"]["n_train"] // bsz)
    case = etrain.Case(params0, None, 0, [structures[k * bsz:(k + 1) * bsz]
                                          for k in range(3)], lr,
                       None, None, None)
    return _against_reference(cell, case, prop, mode, "")


def _against_reference(cell, case, prop: bool, mode: str, prefix: str):
    from entries import train as etrain

    ref = etrain.follow(cell, case, prop)
    ctl = etrain.follow(cell, case, prop, tf32=mode == "tf32",
                        half_batch=mode == "half_batch")
    checks = etrain.compare(cell, ref, ctl["losses"], ctl["grads"],
                            ctl["change"], prefix)
    return {c.name: c.value for c in checks}


def window_readings(cell, seed: int, modes) -> dict:
    from entries import train as etrain

    cell.seed = seed
    out = etrain.run(cell)
    prop = cell.model_cfg["name"] == "alignn"
    case = out.cases["window_"]
    readings = {"program": {c.name: c.value for c in out.checks},
                "window_replays": out.counters["window_checked_replays"]}
    for mode in modes:
        readings[mode] = _against_reference(cell, case, prop, mode,
                                            "window_")
    return readings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--mode", default="tf32", choices=("tf32", "half_batch"),
                    help="what stands in for the program: the reference in "
                    "TF32 (the control), or with a planted fault")
    ap.add_argument("--window", action="store_true",
                    help="training: the window's steps, from a run of the "
                    "cell; the control and the half-batch fault")
    args = ap.parse_args(argv)
    sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]
    import run as brun
    import torch

    if not torch.cuda.is_available():
        print("the controls run on the card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    probe = brun.parse(["--workload", args.workload, "--seed", "0",
                        "--seconds", "1"])
    for seed in args.seeds:
        with tempfile.TemporaryDirectory(prefix="control_") as work_dir:
            _bench, _w, cell = brun.make_cell(probe, "cuda", work_dir)
            if args.window:
                out = window_readings(cell, seed, ("tf32", "half_batch"))
            else:
                out = train_readings(cell, seed, args.mode)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "mode": "window" if args.window else args.mode,
                          "readings": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
