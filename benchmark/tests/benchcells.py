"""Cells of the benchmark cut to a size the CPU runs in a minute or two:
MD of 8 Si atoms with the committed potential (fresh weights on pure Si
give the same energy to every geometry, and no forces to check);
training on a dozen structures of 8 atoms (force field) or of the
prototypes (property model).  The property model has one ALIGNN and one
GCN layer at width 32; the force field keeps its configuration's widths
and depth, since at width 32 most of its gradients are the size of f32
rounding and the first-gradient gap reads 0.2-0.6, not the full model's
1e-3-1e-2.  The entries, taps, checks and limits are the benchmark's
own.

The MD cell is no cell of ``BENCHMARK.json`` while ``run_md_jit`` builds
canonised graphs whatever the potential's ``use_canonize`` says
(PERF.md, open questions): it is built here from its files, and by
default with the potential set to canonised graphs, the path on which
program and reference can agree."""

import os
import tempfile

import run as brun
from harness import spec
from harness.cell import Cell

SMALL_MODEL = {"hidden_features": 32, "embedding_features": 16,
               "alignn_layers": 1, "gcn_layers": 1}


def md_cell(seed: int, canonize: bool) -> Cell:
    config = spec.load_json(os.path.join(
        brun.BENCH_DIR, "configs", "alignnff_mlearn_si.json"))
    config["training"]["use_canonize"] = canonize
    return Cell(name="ff_md_si512", config=config,
                traffic=spec.traffic_of("md_nve_si512"),
                limits=spec.load_json(os.path.join(
                    brun.BENCH_DIR, "limits", "ff_md_si512.json")),
                seed=seed, seconds=1.0, traced=False, device="cpu",
                t_process=brun.T_PROCESS, work_dir=tempfile.mkdtemp())


def small_cell(name: str, seed: int = 2**33 + 3, traced: bool = False,
               device: str = "cpu", canonize: bool = True):
    bench = spec.benchmark()
    if name == "ff_md_si512":
        cell = md_cell(seed, canonize)
        cell.traced = traced
        w = {"name": name, "chips": 1}
    else:
        args = brun.parse(["--workload", name, "--seed", str(seed),
                           "--seconds", "1", "--trace", str(int(traced))])
        bench, w, cell = brun.make_cell(args, device, tempfile.mkdtemp())
    t = cell.traffic
    if cell.config["model"]["name"] == "alignn":
        cell.config["model"].update(SMALL_MODEL)
    if t["entry"] == "md":
        t["system"]["repeat"] = [1, 1, 1]
        t["md"]["chunk_steps"] = 3
        t.update(warm_chunks=2, min_chunks=3, profile_chunks=[1, 2])
    elif t["generator"] == "si_supercell":
        t["dataset"].update(repeat=[1, 1, 1], n_train=12, n_val=4,
                            vacancy_every=4)
        cell.config["training"]["batch_size"] = 4
        t["warm_epochs"] = 1
    else:
        t["dataset"].update(n_train=24, n_val=8)
        cell.config["training"]["batch_size"] = 8
        t["warm_epochs"] = 1
    if device == "cuda":
        # each bucket seen often enough in set-up to be captured, so that
        # the window's steps are replays
        t["warm_epochs"] = 4
    return bench, w, cell


def run_small(name: str, **kw):
    bench, w, cell = small_cell(name, **kw)
    return brun.run_cell(bench, w, cell)
