"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's configuration, traffic and metrics are found by name from
``BENCHMARK.json`` (``harness/spec.py``); the traffic file names the
entry (``entries/<entry>.py``) that drives the program.  With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the device's busy and window
seconds and a breakdown.  Every run checks what its timed path produced
against the plain reference and prints each number compared beside its
limit, last on standard error and last in the line.

The run needs the card: without CUDA, or with fewer cards than the cell
asks for, it exits with code 3 and prints no result.  It exits with
code 4 and no result if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "alignn_tpu")


def prepare_environment():
    """Build and kernel caches at fixed paths inside the checkout (the
    program builds its own into ``build/alignn_tpu_torch``); the program
    and the harness importable."""
    build = os.path.join(ROOT, "build")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    for path in (BENCH_DIR, ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``alignn_tpu_torch`` is not
    ``alignn_tpu``)."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def make_cell(args, device: str, work_dir: str):
    from harness import spec
    from harness.cell import Cell

    bench = spec.benchmark()
    w = spec.workload(bench, args.workload)
    config = spec.config_of(bench, w["config"])
    traffic = spec.traffic_of(w["traffic"])
    limits = spec.load_json(os.path.join(BENCH_DIR, "limits",
                                         f"{args.workload}.json"))
    cell = Cell(name=args.workload, config=config, traffic=traffic,
                limits=limits,
                seed=args.seed, seconds=args.seconds,
                traced=bool(args.trace), device=device,
                t_process=T_PROCESS, work_dir=work_dir)
    return bench, w, cell


def run_cell(bench, workload, cell):
    """Drive the cell's entry; returns (result dict, outcome)."""
    from harness import spec

    entry = importlib.import_module(f"entries.{cell.traffic['entry']}")
    outcome = entry.run(cell)
    result = {"correct": outcome.correct, "attempted": outcome.attempted,
              "failed": outcome.failed}
    if cell.traced:
        metrics = {}
        for m in spec.per_layer(bench, cell.name):
            value = spec.reader(m["name"])(outcome)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        result["metrics"] = metrics
    else:
        result["metrics"] = {
            m["name"]: {"value": float(outcome.end_to_end[m["name"]]),
                        "unit": m["unit"]}
            for m in spec.end_to_end(bench, cell.name)}
    result["device"] = device_info(cell, workload, outcome)
    if cell.traced and outcome.tracer is not None:
        result["breakdown"] = outcome.tracer.breakdown()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in outcome.checks}
    return result, outcome


def device_info(cell, workload, outcome) -> dict:
    import torch

    info = {"platform": "gpu" if cell.device == "cuda" else cell.device,
            "kind": torch.cuda.get_device_name(0)
            if cell.device == "cuda" else "cpu",
            "count": workload["chips"],
            "memory_peak_bytes": outcome.memory_peak_bytes}
    if cell.traced and outcome.tracer is not None:
        info["busy_s"] = outcome.tracer.busy_s()
        info["window_s"] = outcome.tracer.window_s
    return info


def main(argv=None) -> int:
    args = parse(argv)
    prepare_environment()
    import torch

    from harness import spec

    workload = spec.workload(spec.benchmark(), args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < workload["chips"]:
        print(f"{args.workload} needs {workload['chips']} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory(prefix="bench_") as work_dir:
        bench, w, cell = make_cell(args, "cuda", work_dir)
        result, outcome = run_cell(bench, w, cell)
    bad = forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 4
    print("counters " + json.dumps(outcome.counters), file=sys.stderr)
    for c in outcome.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
