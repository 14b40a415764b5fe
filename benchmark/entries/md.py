"""Entry ``md``: NVE molecular dynamics through the program's
``ff.md_jit.run_md_jit``, each chunk replayed as a CUDA graph.

Set-up decodes the potential, builds the model and runs ``warm_chunks``
chunks of the same system through ``run_md_jit`` (kernels built and
loaded, allocator and libraries warm); their rate sets how many whole
chunks fill ``--seconds``.  The window is one ``run_md_jit`` call of that
many steps, as a user makes it: its graph builds between chunks and its
own CUDA-graph capture (a fixed ~0.1 s) included.

Check: the first chunk of the window against the reference.  The tap on
``md_jit.build_graph`` keeps the positions the program built each of the
first two graphs from and the first graph.  The reference builds its own
graph from the same input and must find the same directed edges; it then
runs the chunk (25 velocity-Verlet steps from the same positions and
Maxwell-Boltzmann velocities, edges frozen) and compares each step's
potential and kinetic energy with the program's log and its final
positions with those the program built the second graph from.
"""

from __future__ import annotations

import importlib
import os
import time
from contextlib import nullcontext

import numpy as np
import torch

from harness import taps as htaps
from harness.cell import Cell, Check, Outcome, memory_peak, tf32_products
from harness.trace import Tracer
from harness.weights import load_into, load_potential, to_device
from reference import graph as rgraph
from reference import md as rmd
from reference import model as rmodel

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def md_seed(seed: int) -> int:
    """The seed ``run_md_jit`` draws its velocities from."""
    return int(np.random.SeedSequence([seed, 2]).generate_state(1)[0])


def build_model(cell: Cell):
    from alignn_tpu_torch.nn.models import ALIGNNAtomWise, ALIGNNAtomWiseConfig

    w = cell.config["weights"]
    params = load_potential(os.path.join(ROOT, w["path"]), w["sha256"])
    model = ALIGNNAtomWise(ALIGNNAtomWiseConfig.from_dict(cell.model_cfg))
    load_into(model, to_device(params, "cpu"))
    return model.to(cell.device).eval(), params


def run(cell: Cell) -> Outcome:
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.ff import md_jit

    t = cell.traffic
    md = t["md"]
    tr = cell.config["training"]
    system = importlib.import_module(
        f"traffic.{t['generator']}").md_system(t["system"], cell.seed)
    atoms = Atoms(lattice_mat=system["lattice"], frac_coords=system["frac"],
                  elements=system["elements"])
    model, params = build_model(cell)
    kw = dict(timestep_fs=md["timestep_fs"], ensemble=md["ensemble"],
              temperature_K=md["temperature_K"], cutoff=tr["cutoff"],
              max_neighbors=tr["max_neighbors"],
              neighbor_strategy=tr["neighbor_strategy"],
              chunk_steps=md["chunk_steps"], seed=md_seed(cell.seed),
              device=cell.device, cuda_graph=True)
    chunk = md["chunk_steps"]
    out = Outcome()
    tracer = out.tracer = Tracer(cell.traced)
    taps = htaps.Taps()
    builds = []          # (atoms in, graph out) of the first two builds
    window = {"on": False, "chunk": 0, "profiled_steps": 0}
    profile_from, profile_to = t["profile_chunks"]

    def build_tap(original):
        def wrapped(atoms_in, **kwargs):
            if window["on"]:
                k = window["chunk"]
                if cell.traced and k == profile_from:
                    tracer.start()
                if cell.traced and k == profile_to:
                    tracer.stop()
                window["chunk"] += 1
            if tracer.profiling:
                window["profiled_steps"] += chunk
            with tracer.span("graph_rebuild") if window["on"] \
                    else nullcontext():
                g = original(atoms_in, **kwargs)
            if len(builds) < 2:
                builds.append((atoms_in, g))
            return g
        return wrapped

    taps.patch(md_jit, "build_graph", build_tap)
    if cell.traced:
        def batch_tap(original):
            def wrapped(*a, **kw2):
                with tracer.span("graph_rebuild") if window["on"] \
                        else nullcontext():
                    return original(*a, **kw2)
            return wrapped

        def run_tap(original):
            def wrapped(self, *a, **kw2):
                with tracer.span("chunk_run"):
                    return original(self, *a, **kw2)
            return wrapped

        taps.patch(md_jit, "batch_graphs", batch_tap)
        taps.patch(md_jit.MDChunk, "run", run_tap)
        htaps.record_kernel_launches(taps, tracer)
    try:
        # warm-up: the same system, whole chunks
        warm = t["warm_chunks"]
        stamps = []

        def stamp_tap(original):
            def wrapped(*a, **kw2):
                stamps.append(time.perf_counter())
                return original(*a, **kw2)
            return wrapped

        taps.patch(md_jit, "build_graph", stamp_tap)
        md_jit.run_md_jit(model, atoms, steps=warm * chunk, **kw)
        if cell.device == "cuda":
            torch.cuda.synchronize()
        t_end = time.perf_counter()
        # the rate of the chunks after the first (which captures)
        per_step = (t_end - stamps[1]) / ((warm - 1) * chunk)
        n_chunks = max(t["min_chunks"],
                       round(cell.seconds / (per_step * chunk)))
        steps = n_chunks * chunk
        builds.clear()
        tracer.warm_up()
        t0 = time.perf_counter()
        captures0 = md_jit.StepLoop.captures
        out.counters["setup_s"] = t0 - cell.t_process
        window["on"] = True
        final, log = md_jit.run_md_jit(model, atoms, steps=steps, **kw)
        if cell.device == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        window["on"] = False
    finally:
        taps.close()
        tracer.stop()
    out.memory_peak_bytes = memory_peak(cell)
    out.end_to_end["md_ms_per_step"] = (t1 - t0) * 1e3 / steps
    out.end_to_end["setup_s"] = out.counters["setup_s"]
    out.attempted = steps
    out.failed = steps - len(log.rows)
    out.counters.update(window_s=t1 - t0, steps=steps,
                        window_captures=md_jit.StepLoop.captures - captures0,
                        graph_rebuild_s=tracer.spans.get("graph_rebuild", 0.0))
    if cell.traced:
        _traced_counters(cell, out, builds, window["profiled_steps"])
    del model, final
    out.checks = check(cell, params, system, builds, log.rows[:chunk])
    return out


def _traced_counters(cell: Cell, out: Outcome, builds, steps: int):
    """Profiled steps and their model FLOPs (forward and force pass on
    the real graph)."""
    from harness.flops import StepFlops

    tracer = out.tracer
    g = builds[0][1]
    f = StepFlops(cell.model_cfg, "forces")(g.num_nodes, g.num_edges,
                                           g.num_lg_edges, 1)
    out.counters.update(profiled_steps=steps, profiled_flops=f * steps,
                        profiled_s=tracer.window_s)


def check(cell: Cell, params: dict, system: dict, builds,
          rows, tf32: bool = False) -> list:
    """The window's first chunk against the reference (see the module's
    docstring).  `tf32` computes the reference with TF32 products: the
    control."""
    t = cell.traffic
    tr = cell.config["training"]
    cfg = cell.model_cfg
    z = np.full(len(system["frac"]), _z_of(system["elements"][0]))
    g_ref = rgraph.build(z, system["frac"], system["lattice"],
                         tr["cutoff"], tr["max_neighbors"],
                         tr["use_canonize"])
    differ = rgraph.edges_differ(g_ref, builds[0][1])
    steps = len(rows)
    v0 = rmd.mb_velocities(rmodel.masses(z), t["md"]["temperature_K"],
                           md_seed(cell.seed))
    p = to_device(params, cell.device)
    with tf32_products(cell.device, tf32):
        epot, ekin, cart = rmd.verlet_chunk(p, cfg, g_ref, v0,
                                            t["md"]["timestep_fs"], steps,
                                            cell.device)
    n = len(z)
    prog_epot = np.array([r["epot"] for r in rows])
    prog_ekin = np.array([r["ekin"] for r in rows])
    atoms2 = builds[1][0]
    prog_cart = np.asarray(atoms2.frac_coords) @ np.asarray(
        atoms2.lattice_mat)
    lim = cell.limits
    return [Check("graph_edges_differ", float(differ),
                  lim["graph_edges_differ"]),
            Check("epot_gap_ev_per_atom",
                  float(np.abs(prog_epot - epot).max() / n),
                  lim["epot_gap_ev_per_atom"]),
            Check("ekin_gap_ev_per_atom",
                  float(np.abs(prog_ekin - ekin).max() / n),
                  lim["ekin_gap_ev_per_atom"]),
            Check("position_gap_A",
                  rmd.position_gap(prog_cart, cart, g_ref.lattice),
                  lim["position_gap_A"])]


def _z_of(symbol: str) -> int:
    return rmodel.elements()[symbol]["z"]

