#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``alignn_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases:
1. set-up: the card's name and power limit, TF32 off, the CUDA kernels
   built from ``alignn_tpu_torch/csrc`` (build seconds printed);
2. every kernel of the serving path (K1 gated aggregation, K2 sorted
   segment sum) against its plain PyTorch version on the card, at the
   L-stage shape of the 512-atom cell below, in f32 and bf16, with
   times (CUDA events, median of 20 after warm-up) and the bound;
3. the slice: ``Calculator(path="docs/mlearn_r4/Si")`` on the default
   device on 8-, 64- and 512-atom Si (diamond, rattled supercells); E,
   forces, stress, ms per call and kernel launches per call; the 8- and
   64-atom results against the port on the CPU.

Prints JSON lines; the last line is ``{"ok": true, "device": {...}}``.
Exits non-zero, without that line, on any failed check, and when no CUDA
device is present.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
MODEL_DIR = os.path.join(REPO, "docs", "mlearn_r4", "Si")
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12    # f32 outside the tensor cores
DIAMOND = np.array([[0, 0, 0], [0.25, 0.25, 0.25], [0, 0.5, 0.5],
                    [0.25, 0.75, 0.75], [0.5, 0, 0.5], [0.75, 0.25, 0.75],
                    [0.5, 0.5, 0], [0.75, 0.75, 0.25]])
TOL = {"float32": 1e-5, "bfloat16": 1e-2}   # x max|plain|
CPU_TOL = {"energy_per_atom": 1e-4, "forces": 5e-4, "stress": 1e-5}


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() over `reps` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of the bytes and operations times."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def diamond(a: float = 5.43):
    from alignn_tpu_torch.chem.atoms import Atoms

    return Atoms(lattice_mat=np.eye(3) * a, frac_coords=DIAMOND,
                 elements=["Si"] * 8)


def rattled_supercell(n: int):
    from alignn_tpu_torch.chem.atoms import Atoms

    sc = diamond().make_supercell([n, n, n])
    cart = sc.cart_coords + np.random.default_rng(0).normal(
        0.0, 0.03, sc.cart_coords.shape)
    return Atoms(lattice_mat=sc.lattice_mat,
                 frac_coords=cart @ np.linalg.inv(sc.lattice_mat),
                 elements=sc.elements)


def compare(out, ref, dtype_name: str, failures: list, what: str) -> dict:
    ref = ref.float()
    err = (out.float() - ref).abs().max().item()
    scale = ref.abs().max().item()
    ok = bool(np.isfinite(err)) and err <= TOL[dtype_name] * scale
    if not ok:
        failures.append(f"{what} [{dtype_name}]: max_abs_err {err} > "
                        f"{TOL[dtype_name]} x max|plain| {scale}")
    return {"max_abs_err": err, "rel_err": err / max(scale, 1e-30),
            "tol_rel": TOL[dtype_name]}


def kernel_phase(seg, failures: list):
    """K1/K2 against their plain versions on segments `seg` ([L] rows)."""
    import torch

    from alignn_tpu_torch.ops import eggc as ek

    dev = seg.ids.device
    rows, n, f = seg.ids.shape[0], seg.num, 256
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    index_bytes = 4 * (n + 1)      # the kernels read only the CSR pointer

    # K1 forward, f32 and bf16; backward (f32) through the K2 Function
    m32 = torch.randn(rows, f, device=dev, generator=gen)
    bh32 = torch.randn(rows, f, device=dev, generator=gen)
    k1 = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        m, bh = m32.to(dtype), bh32.to(dtype)
        h = ek.gated_aggregate_cuda(m, bh, seg)
        ref = ek.gated_aggregate_plain(m, bh, seg)
        torch.cuda.synchronize()
        es = m.element_size()
        # operations: sigmoid 4, gated sum 2, gate sum 1 per element;
        # add and divide per output
        b_ms, b_by = bound(2 * rows * f * es + index_bytes + n * f * es,
                           7.0 * rows * f + 2.0 * n * f)
        k1[name] = {
            **compare(h, ref, name, failures, "K1 eggc_gated_aggregate"),
            "ms": cuda_ms(lambda: ek.gated_aggregate_cuda(m, bh, seg)),
            "plain_ms": cuda_ms(lambda: ek.gated_aggregate_plain(m, bh,
                                                                 seg)),
            "bound_ms": b_ms, "bound_by": b_by}
    g = torch.randn(n, f, device=dev, generator=gen)
    grads, bwd_ms = [], []
    for fn in (ek.gated_aggregate, ek.gated_aggregate_plain):
        mt = m32.clone().requires_grad_(True)
        bt = bh32.clone().requires_grad_(True)
        h = fn(mt, bt, seg)
        grads.append(torch.autograd.grad(h, (mt, bt), g, retain_graph=True))
        bwd_ms.append(cuda_ms(lambda: torch.autograd.grad(
            h, (mt, bt), g, retain_graph=True)))
        del h
    k1["backward"] = {
        "dm": compare(grads[0][0], grads[1][0], "float32", failures,
                      "K1 backward dm"),
        "dbh": compare(grads[0][1], grads[1][1], "float32", failures,
                       "K1 backward dbh"),
        "ms": bwd_ms[0], "plain_ms": bwd_ms[1]}
    del grads, m32, bh32, g
    results["K1"] = k1

    # K2: dyadic inputs (multiples of 1/16 in [-4, 4]) make every f32
    # partial sum exact, so the check does not depend on the summation
    # order (index_add_ on the card adds with atomics, in any order)
    x32 = torch.randint(-64, 65, (rows, f), device=dev,
                        generator=gen).float() / 16
    lengths = (seg.row_ptr[1:] - seg.row_ptr[:-1]).long()
    k2 = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        x = x32.to(dtype)
        out = ek.sorted_segment_sum_cuda(x, seg)
        ref = ek.sorted_segment_sum_plain(x, seg)
        torch.cuda.synchronize()
        es = x.element_size()
        b_ms, b_by = bound(rows * f * es + index_bytes + n * f * es,
                           1.0 * rows * f)
        k2[name] = {
            **compare(out, ref, name, failures, "K2 sorted_segment_sum"),
            "ms": cuda_ms(lambda: ek.sorted_segment_sum_cuda(x, seg)),
            "plain_ms": cuda_ms(lambda: ek.sorted_segment_sum_plain(x, seg)),
            "bound_ms": b_ms, "bound_by": b_by}
    k2["float32"]["library_ms"] = cuda_ms(
        lambda: torch.segment_reduce(x32, "sum", lengths=lengths, axis=0))
    results["K2"] = k2
    return results


def breakdown(calc, atoms):
    """(graph, stage ms, top kernels' ms) of ``calc.calculate(atoms)``.

    Host wall times of the graph build, the batch build (numpy padding,
    the copy to the card and the segment pointers) and the model's E/F/S
    forward and backward up to the copy back; then the device time of one
    whole call under ``torch.profiler`` (the second of two, the first
    pays the profiler's start-up), in all and for the costliest kernels.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    from alignn_tpu_torch.graph.batch import batch_graphs
    from alignn_tpu_torch.nn.models import atomwise_forward

    clock = [time.perf_counter()]

    def lap():
        torch.cuda.synchronize()
        clock.append(time.perf_counter())
        return (clock[-1] - clock[-2]) * 1e3

    g = calc.graph_for(atoms)
    stages = {"graph": lap()}
    batch = batch_graphs([g], calc.bucket_for(g), calc.device,
                         atom_features=calc.atom_features)
    stages["batch"] = lap()
    res = atomwise_forward(calc.model, batch)
    res["grad"].cpu()
    stages["model"] = lap()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            calc.calculate(atoms)
            torch.cuda.synchronize()
    # device-side events only (kernels, copies): host ops also carry the
    # times of the kernels they launched, which would count them twice
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + \
                ev.device_time_total / 1e3
    stages["device_busy"] = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return g, stages, {name[:90]: ms for name, ms in top}


def slice_phase(new_calc, cpu_calc, failures: list):
    """The Calculator on 8/64/512 atoms, a fresh one (own bucket) per cell;
    returns (rows, total launches)."""
    import torch

    from alignn_tpu_torch.ops import eggc as ek

    cells = [("diamond8", diamond()), ("si64_rattled", rattled_supercell(2)),
             ("si512_rattled", rattled_supercell(4))]
    rows = []
    ek.gated_aggregate_cuda.launches = 0
    ek.sorted_segment_sum_cuda.launches = 0
    for name, atoms in cells:
        calc = new_calc()
        k0 = (ek.gated_aggregate_cuda.launches,
              ek.sorted_segment_sum_cuda.launches)
        for _ in range(2):
            res = calc.calculate(atoms)
        times = []
        for _ in range(5):
            t = time.perf_counter()
            res = calc.calculate(atoms)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        calls = 7
        k1_per = (ek.gated_aggregate_cuda.launches - k0[0]) / calls
        k2_per = (ek.sorted_segment_sum_cuda.launches - k0[1]) / calls
        g, stages, top_kernels = breakdown(calc, atoms)
        median_ms = float(np.median(times))
        n = atoms.num_atoms
        forces = res["forces"]
        row = {
            "cell": name, "atoms": n, "edges": g.num_edges,
            "lg_edges": g.num_lg_edges,
            "bucket": list(vars(calc.bucket_for(g)).values()),
            "energy": res["energy"], "energy_per_atom": res["energy"] / n,
            "max_abs_force": float(np.abs(forces).max()),
            "abs_sum_force": float(np.abs(forces.sum(axis=0)).max()),
            "stress_voigt": [float(v) for v in res["stress"]],
            "ms_per_calculate": median_ms,
            "stages_ms": stages,
            # the profiled call's device time over an unprofiled call's
            # wall time: the profiler slows the host, not the card
            "device_busy_share": stages["device_busy"] / median_ms,
            "top_kernels_ms": top_kernels,
            "k1_launches_per_call": k1_per,
            "k2_launches_per_call": k2_per,
        }
        finite = np.isfinite(forces).all() and np.isfinite(
            res["stress"]).all() and np.isfinite(res["energy"])
        if not finite or forces.shape != (n, 3):
            failures.append(f"{name}: non-finite or misshaped output")
        if row["abs_sum_force"] > 1e-3:
            failures.append(f"{name}: |sum F| = {row['abs_sum_force']}")
        if k1_per <= 0 or k2_per <= 0:
            failures.append(f"{name}: a kernel was not launched "
                            f"(K1 {k1_per}, K2 {k2_per} per call)")
        rows.append((row, atoms, res))
    launches = {"K1": ek.gated_aggregate_cuda.launches,
                "K2": ek.sorted_segment_sum_cuda.launches}

    for row, atoms, res in rows[:2]:
        ref = cpu_calc.calculate(atoms)
        n = atoms.num_atoms
        diff = {
            "energy_per_atom": abs(res["energy"] - ref["energy"]) / n,
            "forces": float(np.abs(res["forces"] - ref["forces"]).max()),
            "stress": float(np.abs(res["stress"] - ref["stress"]).max())}
        row["vs_cpu_port"] = diff
        for key, tol in CPU_TOL.items():
            if not diff[key] <= tol:
                failures.append(f"{row['cell']}: {key} differs from the "
                                f"CPU port by {diff[key]} > {tol}")
    return [r[0] for r in rows], launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 2
    from alignn_tpu_torch import _build
    from alignn_tpu_torch.ff.calculator import Calculator
    from alignn_tpu_torch.graph.batch import batch_graphs

    smi = smi_line()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "libraries": sorted(libs),
          "ptxas": [ln.strip() for log in _build.BUILD_LOG.values()
                    for ln in log.splitlines() if "Used" in ln]})
    failures: list = []

    base = Calculator(path=MODEL_DIR)            # default device: cuda

    def new_calc():
        return Calculator(model=base.model, config=base.config)

    calc = new_calc()
    g = calc.graph_for(rattled_supercell(4))
    batch = batch_graphs([g], calc.bucket_for(g), calc.device)
    seg = batch.lg_index.dst
    shape = {"rows": int(seg.ids.shape[0]), "segments": seg.num,
             "features": calc.model.cfg.hidden_features,
             "longest_segment": int((seg.row_ptr[1:] - seg.row_ptr[:-1])
                                    .max().item())}
    kernels = kernel_phase(seg, failures)
    del batch, seg
    torch.cuda.empty_cache()

    cpu_calc = Calculator(path=MODEL_DIR, device="cpu")
    cells, launches = slice_phase(new_calc, cpu_calc, failures)
    for row in cells:
        emit({"phase": "slice", **row})

    source = "alignn_tpu_torch/csrc/eggc.cu"
    line = []
    for key, name, replaces in (
            ("K1", "eggc_gated_aggregate", "alignn_tpu/ops/pallas_eggc.py:45"),
            ("K2", "sorted_segment_sum", "alignn_tpu/ops/pallas_eggc.py:178")):
        r = kernels[key]
        f32 = r["float32"]
        line.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": f32["max_abs_err"], "rel_err": f32["rel_err"],
            "tol_rel": f32["tol_rel"],
            "ms": f32["ms"], "kernel_ms": f32["ms"],
            "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"],
            "library_ms": f32.get("library_ms"),
            "shape": shape, "bfloat16": r["bfloat16"],
            **({"backward": r["backward"]} if "backward" in r else {})})
    emit({"kernels": line})
    if failures:
        for msg in failures:
            print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
        return 1
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
