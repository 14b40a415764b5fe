#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``alignn_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --segments [--root DIR]
    python3 chip_smoke.py --pairs [--steps] [--root DIR]
    python3 chip_smoke.py --dp | --gp | --scripts | --bf16-order

``--dp`` runs phase 13 alone, ``--gp`` phase 14, ``--scripts`` phase 12b
(building its own small trained model and labelled cells where
``train_cli`` has not run); ``--bf16-order`` runs bench.py's bf16
dense force step three times in one process and reports whether the
backward's operations keep their order (:func:`order_probe`).
``--segments`` runs K1 and K2 alone (phase 2's K1/K2 part at the 512-atom
L-stage and the sparse training batch's, with eggc.cu's ptxas lines);
``--pairs`` runs K4 alone at the same two dense shapes (warm and cold,
the profiler's split, ptxas, the SASS of its inner loop, the SM clock,
a sha256 of each output), with ``--steps`` also the device time of the
dense train step (f32, bf16) and of the dense MD chunk.  None of these
prints an ``{"ok": ...}`` line; ``--root DIR`` imports the port from the
checkout at DIR (another commit, for an A/B in one call).

Phases:
1. set-up: the card probed in a fresh process through
   ``alignn_tpu_torch.backend_retry`` (a transient failure retried
   there, each retry printed; none swallowed), the card's name and power
   limit, TF32 off, the CUDA kernels
   built from ``alignn_tpu_torch/csrc`` (build seconds printed; registers
   and spills of dense.cu's K5a/K5b and of eggc.cu's kernels);
2. every kernel of the serving and training paths against its plain
   PyTorch version on the card, in f32, bf16 and f16, with device times (CUDA
   events, median of 20 after warm-up, queued behind a spin kernel) and
   the bound: K1 gated aggregation and K2 sorted segment sum at the sparse
   L-stage shape of the 512-atom cell below, each launched twice
   (bit-identical), K2 on dyadic inputs equal to its plain version bit
   for bit, both timed also with L2 evicted before each launch (the
   share of the bound is the cold time's), with the profiler's device
   time by kernel, K2's ``torch.segment_reduce`` in each dtype and K2
   without the last (trash) segment; K3 dense gated aggregation,
   K4 local-pair aggregation, K5a its backward, K5b its second order, K6
   the fused L-stage and K7 its backward at the dense shapes of the same
   cell (edge rows [N*D, 256], pair rows [N*D*D, 256]), and again in
   phase 7 at the dense training batch's; K6 and K7 also with the time of
   ``torch.addmm`` alone at K6's product (``gemm_only_ms``, a yardstick
   the port never calls);
3. the sparse slice: ``Calculator(path="docs/mlearn_r4/Si")`` on the
   default device on 8-, 64- and 512-atom Si (diamond, rattled
   supercells); E, forces, stress, ms per call and kernel launches per
   call; the 8- and 64-atom results against the port on the CPU;
4. the dense slice: the same weights with ``use_canonize: true`` and
   ``dense=True`` on the same three cells, which must run the dense layout
   (K3, K4, K5a launched; K1, K6, K7 not); checked against a sparse
   Calculator of the same config on the card and, at 8 and 64 atoms, the
   port on the CPU;
5. the fused slice: the dense slice again with
   ``ALIGNN_TPU_FUSED_LSTAGE=1`` (K3, K6, K7 launched; K1, K4, K5a not),
   checked against the dense slice's results and, at 8 and 64 atoms, the
   port's fused path on the CPU;
6. ``dense_rocksalt_b64``: the 64 rocksalt cells of ``bench.py`` as one
   dense batch and one sparse batch through ``atomwise_forward``;
7. training on ``dense_rocksalt_b64``: K3-K7 against their plain
   versions at the dense batch's shapes (N 512, D 13), then ``bench.py``'s
   E/F/S train step (full width, f32, seeded weights) dense, sparse and
   fused dense, 2 warm-up and 10 timed steps each: ms per step, edges per
   second over the 10 steps, losses, launches per step (dense: K3, K4,
   K5a, K5b, no K1, K6, K7; fused: K3, K6, K7, no K1, K4, K5a, K5b), peak
   memory and one profiled step; the first step's losses and gradients
   dense against sparse and fused against dense, and on the first 8
   cells against the port on the CPU;
8. the windowed gather K8 (``ALIGNN_TPU_ENABLE_WGATHER=1``, restored
   after): K8 against its plain version, exactly (``torch.equal``), at
   every gather of the sparse training batch (node and L-stage, src, dst,
   the aggregation backward's and the second order's sorted indices) and
   on blocky indices (an all-trash tile, a sparse tile, a window under the
   span), f32 and bf16, with times at the two largest L-stage gathers
   beside ``index_select`` (``library_ms``) and the byte bound;
   ``wgather_batch``: ``atomwise_forward`` on the sparse
   ``dense_rocksalt_b64`` batch with the switch on against off, and on 8
   cells against the CPU port; ``wgather_train``: the sparse train step
   with the switch on (12 steps) against the unwindowed sparse step and,
   on 8 cells, the CPU port; ``loader``: one shuffled epoch of the port's
   ``BucketedLoader`` (``worst_case_spec``, batch 64) over 256 rocksalt
   cells through the windowed train step, with every batch's windows;
9. the envelope-weighted potentials: ``envelope_slice`` serves
   ``docs/mlearn_r5/Si_envelope`` (4+4/256, radius 4.5 A) on the three Si
   cells and ``Cu_envelope`` on a rattled 108-atom fcc cell, each against
   the port on the CPU, launching K2 (their soft sums and gather
   transposes) and no other kernel, then K2 against its plain version
   at the si512 call's own segments; ``envelope_train`` runs the E/F/S
   train step of an envelope model on the first 16 of ``bench.py``'s
   rocksalt cells built with the envelope potentials' graph, 2 warm-up
   and 10 timed steps, the first against the same step on the CPU port;
   ``precision``: ``bench.py``'s default step (bf16, dense, 64 cells),
   bf16 sparse, fused and windowed, f16 dense, ``remat_layers`` dense in
   f32 and bf16, the fp8 L-tables (``ALIGNN_TPU_FP8_LTABLES``) in bf16
   dense and sparse and the envelope step in bf16, between two more f32
   dense runs: each as phase 7's runs (kernel lists included), its first
   step against the f32 first step of its path at ``PREC_TOL``
   (``FP8_TOL``; the f32 runs at the f32 limits, remat's peak memory
   below the f32 step's) and its 12 losses beside the f32 run's.

10. the C++ neighbour list and the FF layer: ``native_graph`` builds the
   graphs of ``docs/mlearn_r4/Si`` (k-NN) on the three Si cells and of
   ``Si_envelope`` (radius 4.5 A) on those and ``cu108_rattled`` with the
   C++ list and with numpy (graph and pair-search ms, median of 3; the two
   byte-equal on the rattled cells, a radius graph's r within 1e-12 A;
   a fresh Calculator's first ``graph_for``), failing if the library did
   not build; ``ff_science`` runs the pins of
   ``tests/test_envelope_potential.py`` and
   ``tests/test_trained_potential.py`` through the Calculator on the card
   (FIRE with the cell, E-V curve, Gamma phonons, vacancy, energy), each
   task's seconds and Calculator calls; ``md_device`` runs ``run_md_jit``
   with ``Si_envelope`` on si512_rattled (NVE, 1 fs, 300 K, 2 chunks of
   25 steps) captured, eager and as the host loop ``run_md``: ms per
   step, captures, energy drift, captured against eager (1e-5 A),
   ``chunk_steps=1`` against the host loop, one chunk per layout
   (envelope at si512 and si64, sparse and dense k-NN: replayed ms per
   step, device busy share and operations under ``torch.profiler``,
   eager ms, launches and host syncs per step), a dense ``run_md_jit``
   chunk and an
   ``nvt_langevin`` run; ``relax_device`` runs ``batch_relax`` on 8
   rattled si64 cells, captured against eager.

11. folder training through the CLIs (``train_cli``): ``cli.train`` on
   a folder of 640 rattled rocksalt POSCARs (the draws of
   ``rocksalt_graphs``) with the ALIGNN property model at full width
   (4+4/256, BatchNorm), batch 64, 512/64/64 cells, 3 epochs, graph cache
   and 2 graph workers: the artifact set, finite losses, K1/K2 launched
   and no other kernel; ``cli.predict`` on the 64 test structures from
   the last weights against ``Test_results.json`` (1e-5); the run again
   from a copy of its graph cache (every split a cache hit; every graph
   then read back once, bytes fetched and unpacked, timed), dense for one
   epoch (K3/K4/K5a, no K1) and dense with ``ALIGNN_TPU_FUSED_LSTAGE=1``
   (still K4, no K6/K7); then ``docs/mlearn_r4/Si``'s config for one
   epoch on 40 si64 cells (rattled 0.05 A, seeds 0-39) labelled by that
   potential; then the property run again in bf16 and in f16, one epoch
   each.  In
   each run the trainer's own train step is tapped: its
   first step's launches (the per-step counts) and its loss and gradients,
   held against the same step on the port on the CPU (float32; float64
   for the FF run) from the same weights and batch (loss 1e-4 relative,
   gradients 1e-3 x max|grad| + 1e-7, a bias feeding a BatchNorm at the
   model's scale; a bf16 run against the CPU port in bf16 at
   ``PREC_TOL_BN``); after the run
   the trainer's step is replayed once timed and once profiled.  Each
   run: seconds per epoch, ms per step, the trainer's edges/s,
   graph-stage seconds, cache hits, peak memory.

12. the model families (``model_families``): (e) eALIGNN at its
   published defaults (2+2/64, inner cutoff 4 A, torque removed), seeded
   weights, served by the Calculator with docs/mlearn_r4/Si's graph on
   si64_rattled, si512_rattled and a 64-atom rattled rocksalt cell,
   sparse, dense and dense under ALIGNN_TPU_FUSED_LSTAGE=1 (K2 launched,
   no other kernel), against the port on the CPU and the fused switch
   against the dense results; (e-train) eALIGNN through ``cli.train`` for
   one epoch on 40 labelled 64-atom rocksalt cells with the Si config's
   trainer settings, its first step against the CPU port (float32, or
   float64 where float32 misses), and one bf16 step of it; (x) the
   property model at its defaults
   with 6 extra features a structure on 128 rocksalt cells, one epoch
   sparse and one dense from the cache (each first step against the CPU
   port), and the last weights' predictions with the features against
   Test_results.json; (x-ff) 6 train steps of docs/mlearn_r4/Si's model
   config with 6 extra features on 5 si64 cells, the first against the
   CPU port; (i) ``iCalculator`` with docs/mlearn_r4/Si and a seeded
   full-width property model (atomwise 2, additional 22) on si64 and
   si512: E/F/S bit for bit the plain Calculator's (under torch's
   deterministic algorithms), the charges, magmoms and properties
   against the CPU port, ms a call beside the plain Calculator's.  Each
   run prints ms a call or step, the device's busy share and launches
   per kernel, and holds its need/banned launch lists.

12b. the campaign scripts (``scripts``): ev_curve, cubic_mat_relax,
   defect and plot_phonons_ff with docs/mlearn_r4/Si on si8 and si64
   (si64's phonons: si8 on the 2x2x2 supercell), predict_db on 16 of
   train_cli's rocksalt POSCARs with its trained model, train_mlearn for
   one epoch on train_cli's 40 labelled si64 cells; each run's seconds
   and launches, and its result against the CPU port's run of the same
   script (si8, predict_db; si64 through cubic_mat_relax's relaxed cell;
   train_mlearn's first step in float64), run meanwhile by a process of
   this script (``--scripts-cpu``).  ``python3 chip_smoke.py --scripts``
   runs it alone.

13. data parallelism, the server and the legacy CLI (``dp_phases``):
   ``dp_train`` runs bench.py's default E/F/S step (bf16, 64 rocksalt
   cells, dense and sparse) through ``make_dp_train_step`` on an NCCL
   group of one rank (the card's host has one GPU), compiled, 12 steps,
   beside the single-rank compiled step, both under deterministic
   algorithms: losses and final parameters bit for bit, ms a step,
   device ms, the all-reduce's device ms, launches a replayed DP step;
   ``dp_property`` runs property run (a)'s config for one epoch through
   ``train_model_dp`` on that group against the single-rank trainer, bit
   for bit; ``gloo_two_ranks`` starts two processes of this script
   (``--gloo-rank``) that share cuda:0 under gloo: 4 eager sparse E/F/S
   steps of 8 cells a rank, the ranks' parameters bit for bit, each
   first step against the CPU port's two-rank step (or the gloo build's
   refusal of CUDA tensors, recorded); ``serve`` serves
   docs/mlearn_r4/Si with ``--ff`` on an ephemeral port (/health,
   /predict on si8, si64 and a batch with si512, /ff on si64, a malformed
   request): /ff bit for bit ``Calculator.calculate``, /predict within
   1e-5 of ``zoo.predict_structures``, warm ms a request, graphs
   captured, K1/K2 launches a request; ``legacy`` trains one epoch of the
   property model through ``cli.legacy`` from a dataset cache file.
   ``python3 chip_smoke.py --dp`` runs this phase alone (no ``{"ok"}``
   line).

14. graph parallelism, fjvp and gated_bwd (``gp_phases``):
   ``gp_transport`` sends a CUDA tensor over gloo's send/recv in two
   processes of this script (``--gp-p2p``; gloo reads it as host memory,
   so the ranks stage their shifts through the host); ``gp`` starts four
   processes (``--gp-rank``) that share cuda:0 under gloo as a ("data",
   "graph") mesh of shape (2, 2).  Data row 0 runs ``gp_ring`` (si512
   with docs/mlearn_r4/Si at full width, edge-partitioned over its two
   ranks, chain and gather mode) and ``gp_dense`` (the same cell dense,
   halo-exchanged; halo rows printed): E/F/S against the one-process
   Calculator (CPU_TOL), then 3 E/F/S train steps, each against the
   one-process step from the same parameters (TRAIN_TOL, timed), and a
   profiled step (kernel launches, device ms and the collectives' ms a
   rank; K2 needed on the ring, K3/K4/K5a/K5b on the halo); then all four
   run ``gp_2d``: bench.py's 64 rocksalt cells, 32 a data row, one data x
   dense-halo and one data x ring step each against the mean of the rows'
   one-process steps, the four ranks' parameters bit for bit; ``fjvp``:
   train_cli (c)'s FF config on 8 labelled si64 cells, the fjvp step
   against the standard step (losses, gradients, ms and device ms), each
   forward-mode rule against ``torch.func.jvp`` of its plain version;
   ``gated_bwd``: bench.py's dense step on 16 cells with
   ``ALIGNN_TPU_GATED_BWD_OP=1`` against without it.  Each si512 leg is
   also recorded once (``collective_audit.audit_gp_forward``): shift
   counts and bytes a phase, equal to the analytic model to the byte, the
   forward ring payloads' overlap verdict, the reverse's chain links and
   the profiler's overlap finding; rank 0's one-process step and forward
   device ms anchor ``parallel.link_projection``, whose rows (projections
   from published link bandwidths) are printed and whose anchor is
   written to ``build/gp/link_anchor.json``.  The ranks' logs
   (stages, memory, a stack dump of a rank that hangs) go to
   ``build/gp/logs/``.

K3 is also launched twice at both dense shapes (bit-identical), with its
fully masked (padded) nodes exactly 0 and one fill of its output timed
beside it; K3, K4, K5a and K5b are timed warm and cold (L2 evicted) at
both, and every dense kernel's entry carries its share of the bound (of
the cold time where there is one).

Prints JSON lines; the last line is ``{"ok": true, "device": {...}}``.
Exits non-zero, without that line, on any failed check, and when no CUDA
device is present.
"""

from __future__ import annotations

import contextlib
import io
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
H100_BF16_FLOP_PER_S = 989e12  # bf16 products on the tensor cores (dense)
H100_TF32_FLOP_PER_S = 495e12  # TF32 products on the tensor cores (dense)
SPIN_CYCLES_PER_S = 2e9        # a little above the H100's 1.98 GHz boost
FLUSH_BYTES = 128 << 20        # written before a cold timed run
DIAMOND = np.array([[0, 0, 0], [0.25, 0.25, 0.25], [0, 0.5, 0.5],
                    [0.25, 0.75, 0.75], [0.5, 0, 0.5], [0.75, 0.25, 0.75],
                    [0.5, 0.5, 0], [0.75, 0.75, 0.25]])
TOL = {"float32": 1e-5, "bfloat16": 1e-2, "float16": 1e-2}   # x max|plain|
CPU_TOL = {"energy_per_atom": 1e-4, "forces": 5e-4, "stress": 1e-5}


def kernel_dtypes():
    """The dtypes every kernel is held in against its plain version."""
    import torch

    return (torch.float32, torch.bfloat16, torch.float16)


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def l2_evictor():
    """A function that writes FLUSH_BYTES (2.7x the H100's 50 MB L2) on
    the current stream, so that the next kernel finds none of its inputs
    in L2."""
    import torch

    buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    return lambda: buf.fill_(1.0)


def cuda_ms(fn, reps: int = 20, warmup: int = 3, cold: bool = False
            ) -> float:
    """Median device time of fn() over `reps` runs (CUDA events).

    The timed runs queue up behind a spin kernel that outlasts the host's
    time to enqueue them, so each event pair brackets device work only,
    not the Python wrapper's launch overhead (which exceeds the run time
    of the smaller kernels).  `cold` evicts L2 (:func:`l2_evictor`) before
    each run, outside its event pair: the inputs then come from device
    memory, as the byte bound counts them.
    """
    import torch

    evict = l2_evictor() if cold else (lambda: None)

    def run():
        evict()
        fn()

    for _ in range(warmup):
        run()
    torch.cuda.synchronize()
    t = time.perf_counter()
    run()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int((2 * reps * host_s + 1e-3) * SPIN_CYCLES_PER_S))
    for start, end in events:
        evict()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call of `fn`, launch only (the card runs
    behind): the Python cost of a wrapper."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def bound(nbytes: float, flops: float, products: float = 0.0,
          dtype: str = "float32"):
    """(bound_ms, bound_by): the larger of the bytes and operations times.

    `flops` are elementwise operations, at the f32 rate outside the tensor
    cores.  `products` are the operations of matrix products, whose least
    time depends on the operands: bf16 x bf16 (or f16 x f16) accumulated
    in f32 is exact and runs on the tensor cores at the bf16 rate (the
    f16 rate is the same); an f32-grade product runs on the tensor cores
    as the 3xTF32 split (hi.hi + hi.lo + lo.hi, f32 sums), three TF32
    products at the TF32 rate.
    """
    if dtype in ("bfloat16", "float16"):
        t_products = products / H100_BF16_FLOP_PER_S
    else:
        t_products = 3.0 * products / H100_TF32_FLOP_PER_S
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = (flops / H100_F32_FLOP_PER_S + t_products) * 1e3
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


def segment_shape(seg) -> dict:
    """What the segment kernels' work depends on: rows, segments, work
    items, the longest segment, the empty ones, those cut into several
    items, and the last (a padded batch's trash) segment's rows and
    items."""
    lengths = (seg.row_ptr[1:] - seg.row_ptr[:-1]).long()
    items = (seg.item_ptr[1:] - seg.item_ptr[:-1]).long()
    nonempty = int((lengths > 0).sum().item())
    return {"rows": int(seg.ids.shape[0]), "segments": seg.num,
            "items": seg.num_items,
            "longest_segment": int(lengths.max().item()),
            "rows_per_nonempty_segment": int(seg.ids.shape[0])
            / max(nonempty, 1),
            "empty_segments": seg.num - nonempty,
            "multi_item_segments": int((items > 1).sum().item()),
            "last_segment_rows": int(lengths[-1].item()),
            "last_segment_items": int(items[-1].item())}


def kernel_split(fns, calls: int = 5) -> dict:
    """Device ms per call of each kernel that the functions `fns` launch
    (each function once a round, `calls` rounds), with L2 evicted before
    each call (the evicting fill left out), from one ``torch.profiler``
    session."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    evict = l2_evictor()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            for fn in fns:
                evict()
                fn()
        torch.cuda.synchronize()
    by_name, _ = device_ms_by_name(prof)
    return {name[:120]: ms / calls for name, ms in by_name.items()
            if "FillFunctor" not in name}


def timed(fn, plain, b_ms: float, b_by: str) -> dict:
    """A kernel's times warm (inputs left in L2 by the previous run) and
    cold (L2 evicted), its plain version's, its bound and the cold time's
    share of the bound."""
    cold = cuda_ms(fn, cold=True)
    return {"ms": cuda_ms(fn), "cold_ms": cold,
            "plain_ms": cuda_ms(plain), "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / cold}


def library_call(fn) -> dict:
    """`fn`'s time, or why the library refused it."""
    try:
        fn()
    except (RuntimeError, NotImplementedError) as err:
        return {"library_ms": None, "library_refused": str(err)[:200]}
    return {"library_ms": cuda_ms(fn)}


def kernel_phase(seg, failures: list):
    """K1/K2 against their plain versions on segments `seg` ([L] rows),
    each launched twice (bit-identical), timed warm and cold, with the
    profiler's device time by kernel (``split_ms``: eggc.cu's kernels
    are named by dtype, K1's with GATED true); K2 also timed without the
    last segment (a padded batch's trash slot)."""
    import torch

    from alignn_tpu_torch.ops import eggc as ek

    dev = seg.ids.device
    rows, n, f = seg.ids.shape[0], seg.num, 256
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {"shape": {**segment_shape(seg), "features": f}}
    index_bytes = 4 * (n + 1)      # the kernels read only the CSR pointer

    def twice(fn, what, name):
        out = fn()
        if not torch.equal(out, fn()):
            failures.append(f"{what} [{name}]: two launches differ")
        return out

    # K1 forward, f32, bf16 and f16; backward (f32) through the K2 Function
    m32 = torch.randn(rows, f, device=dev, generator=gen)
    bh32 = torch.randn(rows, f, device=dev, generator=gen)
    k1, calls = {}, []
    for dtype in kernel_dtypes():
        name = str(dtype).split(".")[1]
        m, bh = m32.to(dtype), bh32.to(dtype)
        h = twice(lambda: ek.gated_aggregate_cuda(m, bh, seg),
                  "K1 eggc_gated_aggregate", name)
        ref = ek.gated_aggregate_plain(m, bh, seg)
        torch.cuda.synchronize()
        es = m.element_size()
        # operations: sigmoid 4, gated sum 2, gate sum 1 per element;
        # add and divide per output
        b_ms, b_by = bound(2 * rows * f * es + index_bytes + n * f * es,
                           7.0 * rows * f + 2.0 * n * f)
        calls.append(lambda m=m, bh=bh: ek.gated_aggregate_cuda(m, bh, seg))
        k1[name] = {
            **compare(h, ref, name, failures, "K1 eggc_gated_aggregate"),
            **timed(calls[-1],
                    lambda: ek.gated_aggregate_plain(m, bh, seg),
                    b_ms, b_by)}
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
    # partial sum exact, so the kernel must equal the plain version bit
    # for bit whatever the summation order (index_add_ on the card adds
    # with atomics, in any order)
    x32 = torch.randint(-64, 65, (rows, f), device=dev,
                        generator=gen).float() / 16
    lengths = (seg.row_ptr[1:] - seg.row_ptr[:-1]).long()
    trash = int(seg.row_ptr[-2].item())     # rows before the last segment
    seg_nt = ek.Segments.from_sorted(seg.ids[:trash], n)
    k2 = {}
    for dtype in kernel_dtypes():
        name = str(dtype).split(".")[1]
        x = x32.to(dtype)
        out = twice(lambda: ek.sorted_segment_sum_cuda(x, seg),
                    "K2 sorted_segment_sum", name)
        ref = ek.sorted_segment_sum_plain(x, seg)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            failures.append(f"K2 sorted_segment_sum [{name}]: not equal to "
                            f"the plain version on dyadic inputs")
        es = x.element_size()
        b_ms, b_by = bound(rows * f * es + index_bytes + n * f * es,
                           1.0 * rows * f)
        xt = x[:trash]
        nt_ms, nt_by = bound(trash * f * es + index_bytes + n * f * es,
                             1.0 * trash * f)
        calls.append(lambda x=x: ek.sorted_segment_sum_cuda(x, seg))
        k2[name] = {
            **compare(out, ref, name, failures, "K2 sorted_segment_sum"),
            "exact": bool(torch.equal(out, ref)),
            **timed(calls[-1],
                    lambda: ek.sorted_segment_sum_plain(x, seg),
                    b_ms, b_by),
            **library_call(lambda: torch.segment_reduce(
                x, "sum", lengths=lengths, axis=0)),
            "without_last_segment": {
                "rows": trash,
                "cold_ms": cuda_ms(lambda: ek.sorted_segment_sum_cuda(
                    xt, seg_nt), cold=True),
                "bound_ms": nt_ms, "bound_by": nt_by}}
    split = kernel_split(calls)
    k1["split_ms"] = {k: v for k, v in split.items() if ", true>" in k}
    k2["split_ms"] = {k: v for k, v in split.items() if ", false>" in k}
    results["K2"] = k2
    return results


def dense_kernel_phase(batch, failures: list):
    """K3/K4/K5a/K5b against their plain versions at the dense shapes of
    `batch`, with its real slot masks folded into random logits, timed
    warm and cold (:func:`timed`: the share of the bound is the cold
    time's); K3 and K5a/K5b also launched twice
    (bit-identical), K3 with its fully masked (padded) nodes exactly 0 and
    the time of one fill of its output beside it, K5a/K5b with their
    launch plan read on the card (``blocks_per_sm``, ``smem_bytes``,
    ``width``, ``path``)."""
    import torch

    from alignn_tpu_torch.ops import dense as dk

    dev, D = batch.r.device, batch.dense_D
    n, f = batch.z.shape[0], 256
    rows, pairs = n * D, n * D * D
    gen = torch.Generator(device=dev).manual_seed(1)
    results = {}

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    # the masks fold into the logits in each dtype, as the model folds them
    m_raw, bh32, m2_raw = randn(rows, f), randn(rows, f), randn(pairs, f)
    g32 = randn(rows, f)
    u32, v32 = randn(pairs, f), randn(rows, f)
    masked_pairs = batch.lg_mask == 0
    for key, fn in (("K3", "dense_gated_aggregate"),
                    ("K4", "dense_pair_aggregate"),
                    ("K5a", "pair_aggregate_bwd"),
                    ("K5b", "pair_aggregate_bwd2")):
        kern, plain = getattr(dk, fn + "_cuda"), getattr(dk, fn + "_plain")
        out = {}
        for dtype in kernel_dtypes():
            name = str(dtype).split(".")[1]
            es = torch.tensor([], dtype=dtype).element_size()
            bh, g = bh32.to(dtype), g32.to(dtype)
            m = dk.fold_mask(m_raw.to(dtype), batch.edge_mask)
            m2 = dk.fold_mask(m2_raw.to(dtype), batch.lg_mask)
            if key == "K3":
                args = (m, bh, D)
                # read m, bh; write h.  sigmoid 4, gated sum 2, gate sum 1
                # per element; add and divide per output
                nbytes, ops = (2 * rows + n) * f * es, 7.0 * rows * f + \
                    2.0 * n * f
            elif key == "K4":
                args = (m2, bh, D)
                nbytes, ops = (pairs + 2 * rows) * f * es, 7.0 * pairs * f + \
                    2.0 * rows * f
            elif key == "K5a":
                args = (m2, bh, g, D)
                # read m2, bh, g; write dm2, dbh.  per pair element:
                # sigmoid 4, sums 3, dm2 6, dbh 2; per row: ginv, gh 5
                nbytes = (2 * pairs + 3 * rows) * f * es
                ops = 15.0 * pairs * f + 5.0 * rows * f
            else:
                args = (m2, bh, g, u32.to(dtype), v32.to(dtype), D)
                # read m2, u, bh, g, v; write c_m2, c_bh, c_g.  per pair
                # element: sigmoid 4, sig' sig'' 4, sums 9, c_m2 10, c_bh 4;
                # per row: h, ginv, gh, k, c_g and the k terms 15
                nbytes = (3 * pairs + 5 * rows) * f * es
                ops = 31.0 * pairs * f + 15.0 * rows * f
            got, ref = kern(*args), plain(*args)
            torch.cuda.synchronize()
            occupancy = {}
            if key == "K3":
                # padded nodes have every slot masked: exactly 0; a second
                # launch gives the same bits (fixed-order partial sums)
                empty = batch.edge_mask.reshape(n, D).sum(dim=1) == 0
                if not bool((got[empty] == 0).all()) or \
                        not bool(torch.isfinite(got.float()).all()):
                    failures.append(f"K3 [{name}]: a fully masked node is "
                                    f"not exactly 0, or h is not finite")
                if not torch.equal(got, kern(*args)):
                    failures.append(f"K3 [{name}]: two launches differ")
                # a yardstick of the timer's floor: one fill of K3's output
                occupancy = {"masked_nodes": int(empty.sum().item()),
                             "fill_output_ms": cuda_ms(
                                 lambda: torch.empty_like(got).fill_(1.0))}
            if key in ("K5a", "K5b"):
                parts = ("dm2", "dbh") if key == "K5a" else \
                    ("c_m2", "c_bh", "c_g")
                errs = [compare(got[i], ref[i], name, failures,
                                f"{key} {fn} {part}")
                        for i, part in enumerate(parts)]
                err = max(errs, key=lambda e: e["rel_err"])
                err = {**err, **dict(zip(parts, errs))}
                # masked pairs: exact zeros; no NaN or inf anywhere
                if not bool((got[0][masked_pairs] == 0).all()) or not all(
                        bool(torch.isfinite(x.float()).all()) for x in got):
                    failures.append(f"{key} [{name}]: a masked pair row is "
                                    f"not exactly 0, or an output is not "
                                    f"finite")
                # sums in a fixed order: a second launch gives the same bits
                if not all(torch.equal(a, b)
                           for a, b in zip(got, kern(*args))):
                    failures.append(f"{key} [{name}]: two launches differ")
                # the launch plan and its residency, read on the card
                occupancy = dk.pair_bwd_occupancy(key, D, f, dtype)
            else:
                err = compare(got, ref, name, failures, f"{key} {fn}")
            del got, ref
            b_ms, b_by = bound(nbytes, ops)
            del m, m2
            out[name] = {**err, **timed(lambda: kern(*args),
                                        lambda: plain(*args), b_ms, b_by),
                         "library_ms": None, **occupancy}
            del args
        results[key] = out
    return results


def fused_kernel_phase(batch, failures: list):
    """K6/K7 against their plain versions at the dense shapes of `batch`:
    its real edge mask folded into random sg and dg, de zero on its masked
    pair rows (as in the model, which reads no masked row of e_new; there
    the LayerNorm backward of a row near -1e9 depends on the summation
    order).  e_new is compared on real pair rows."""
    import torch

    from alignn_tpu_torch.ops import dense as dk
    from alignn_tpu_torch.ops import fused_lstage as fk

    dev, D = batch.r.device, batch.dense_D
    n, f = batch.z.shape[0], 256
    rows, pairs = n * D, n * D * D
    gen = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    real = batch.lg_mask > 0
    z32, w = randn(pairs, f), randn(f, f, scale=0.0625)
    b, sc, bi = randn(f, scale=0.1), 1.0 + randn(f, scale=0.1), \
        randn(f, scale=0.1)
    # the edge mask folds into sg and dg in each dtype, as the model folds it
    sg32, dg32 = randn(rows, f), randn(rows, f)
    bh32, dh32 = randn(rows, f), randn(rows, f)
    de32 = randn(pairs, f) * batch.lg_mask[:, None]
    results = {"K6": {}, "K7": {}}
    for dtype in kernel_dtypes():
        name = str(dtype).split(".")[1]
        es = torch.tensor([], dtype=dtype).element_size()
        z = z32.to(dtype)
        args = (z, w, b, dk.fold_mask(sg32.to(dtype), batch.edge_mask),
                dk.fold_mask(dg32.to(dtype), batch.edge_mask),
                bh32.to(dtype), sc, bi, D)
        bargs = (*args[:-1], de32.to(dtype), dh32.to(dtype), D)
        e_new, h = fk.fused_pair_lstage_cuda(*args)
        ref_e, ref_h = fk.fused_pair_lstage_plain(*args)
        torch.cuda.synchronize()
        errs = {"e_new": compare(e_new[real], ref_e[real], name, failures,
                                 "K6 fused_pair_lstage e_new"),
                "h": compare(h, ref_h, name, failures,
                             "K6 fused_pair_lstage h")}
        if not bool(torch.isfinite(e_new.float()).all()):
            failures.append(f"K6 [{name}]: e_new not finite")
        del e_new, h, ref_e, ref_h
        # K6 reads z, sg, dg, bh and W, writes e_new and h; operations: the
        # product 2 L F^2, and per pair element b and the gates 3, sigmoid
        # 4, the two sums 3, LayerNorm 7, SiLU 5, residual 1; per output
        # row of h, add and divide
        b_ms, b_by = bound((2 * pairs + 4 * rows + f) * f * es,
                           23.0 * pairs * f + 2.0 * rows * f,
                           2.0 * pairs * f * f, name)
        results["K6"][name] = {
            **max(errs.values(), key=lambda e: e["rel_err"]), **errs,
            "ms": cuda_ms(lambda: fk.fused_pair_lstage_cuda(*args)),
            "plain_ms": cuda_ms(lambda: fk.fused_pair_lstage_plain(*args)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "gemm_only_ms": cuda_ms(lambda: torch.addmm(
                b.to(dtype), z, w.to(dtype)))}
        got = fk.fused_lstage_bwd_cuda(*bargs)
        ref = fk.fused_lstage_bwd_plain(*bargs)
        torch.cuda.synchronize()
        parts = ("dz", "dw", "db", "dsg", "ddg", "dbh", "dscale", "dbias")
        errs = {part: compare(x, r, name, failures, f"K7 fused_lstage_bwd "
                              f"{part}")
                for part, x, r in zip(parts, got, ref)}
        if not all(bool(torch.isfinite(x.float()).all()) for x in got):
            failures.append(f"K7 [{name}]: an output is not finite")
        del got, ref
        # K7 reads z, de, sg, dg, bh, dh and W, writes dz, dsg, ddg, dbh
        # and dW (f32); operations: three products 6 L F^2, and about 55
        # per pair element (the recomputed forward, the aggregation and
        # LayerNorm backward, the sums of dm2), 5 per edge row
        b_ms, b_by = bound((3 * pairs + 7 * rows + f) * f * es + 4 * f * f,
                           55.0 * pairs * f + 5.0 * rows * f,
                           6.0 * pairs * f * f, name)
        results["K7"][name] = {
            **max(errs.values(), key=lambda e: e["rel_err"]), **errs,
            "ms": cuda_ms(lambda: fk.fused_lstage_bwd_cuda(*bargs)),
            "plain_ms": cuda_ms(lambda: fk.fused_lstage_bwd_plain(*bargs)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "gemm_only_ms": results["K6"][name]["gemm_only_ms"]}
        del args, bargs, z
        torch.cuda.empty_cache()
    return results


def ptxas_kernels(log: str) -> list:
    """Registers, stack and spills of every kernel of a library, from its
    ``nvcc -Xptxas -v`` build log, one entry per compiled instance (the
    mangled name carries the template arguments)."""
    out, entry, props = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = {"kernel": line.split("'")[1]}
            out.append(entry)
        elif "Function properties for" in line:
            props = line.split("Function properties for")[1].strip()
        elif entry is not None and "spill stores" in line and \
                props == entry["kernel"]:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            entry.update(stack_bytes=nums[0], spill_store_bytes=nums[1],
                         spill_load_bytes=nums[2])
        elif entry is not None and "Used" in line:
            entry["registers"] = int(line.split("Used")[1].split()[0])
    return out


def k5_ptxas(log: str) -> list:
    """:func:`ptxas_kernels` of dense.cu's K5a/K5b kernels, named by kind,
    vector width and dtype."""
    out = []
    for entry in ptxas_kernels(log):
        name = entry.pop("kernel")
        for kind in ("pair_bwd2_slab", "pair_bwd_slab", "pair_bwd2_2pass",
                     "pair_bwd_2pass"):
            if kind in name:
                vec = name.split(kind)[1].split("Li")[1].split("E")[0]
                out.append({"kernel": kind, "vec": int(vec),
                            "dtype": "bfloat16" if "bfloat16" in name
                            else "float32", **entry})
                break
    return out


def dense_shape(batch) -> dict:
    """The dense kernels' operand shapes for `batch`."""
    D, n = batch.dense_D, batch.z.shape[0]
    return {"nodes": n, "D": D, "edge_rows": n * D, "pair_rows": n * D * D,
            "features": 256, "real_pairs": int(batch.lg_mask.sum().item())}


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

    clock = [time.perf_counter()]

    def lap():
        torch.cuda.synchronize()
        clock.append(time.perf_counter())
        return (clock[-1] - clock[-2]) * 1e3

    g = calc.graph_for(atoms)
    stages = {"graph": lap()}
    batch = calc.batch_for(g)
    stages["batch"] = lap()
    res = calc.forward(batch)
    res["grad"].cpu()
    stages["model"] = lap()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            calc.calculate(atoms)
            torch.cuda.synchronize()
    by_name, n_ops = device_ms_by_name(prof)
    stages["device_busy"] = sum(by_name.values())
    stages["device_ops"] = n_ops
    return g, stages, top_kernels(by_name)


def device_ms_by_name(prof):
    """({name: device ms}, count) of the kernels and copies of a profiled
    run.

    Device-side events only: host ops also carry the times of the kernels
    they launched, which would count them twice.  A ``record_function``
    range (the optimizer's ``Optimizer.step#...``) also appears on the
    device as one span over its kernels and the gaps between them; it is
    left out for the same reason.
    """
    import torch

    by_name: dict = {}
    count = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and \
                not getattr(ev, "is_user_annotation", False):
            by_name[ev.name] = by_name.get(ev.name, 0.0) + \
                ev.device_time_total / 1e3
            count += 1
    return by_name, count


# each wrapper's kernel, as the profiler names it: the symbols of the
# port's .cu files, which live in anonymous namespaces ("void (anonymous
# namespace)::segment_kernel<float, 8, true>(...)"); K1/K2 are
# segment_kernel's GATED true / false instances, K7's call is its tile
# kernel and four more
KERNEL_SYMBOLS = (("K1", r"segment_kernel<[^>]*, true>"),
                  ("K2", r"segment_kernel<[^>]*, false>"),
                  ("K3", r"gated_kernel\b"), ("K4", r"pair_kernel\b"),
                  ("K5a", r"pair_bwd_\w*kernel\b"),
                  ("K5b", r"pair_bwd2_\w*kernel\b"),
                  ("K6", r"fused_fwd_kernel\b"),
                  ("K7", r"fused_bwd_tile_kernel\b"),
                  ("K8", r"gather_kernel\b"))


def kernel_id(name: str):
    """The K id of a profiled kernel's name, or None (a library's)."""
    import re

    for key, pattern in KERNEL_SYMBOLS:
        if re.search(r"\(anonymous namespace\)::" + pattern, name):
            return key
    return None


def kernel_launches_in(prof) -> dict:
    """Launches of each kernel in a profiled run, counted from the
    profiler's kernel names: a replayed CUDA graph launches its kernels
    without their Python wrappers, whose counters do not move."""
    import torch

    counts = {key: 0 for key, _p in KERNEL_SYMBOLS}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA or \
                getattr(ev, "is_user_annotation", False):
            continue
        key = kernel_id(ev.name)
        if key is not None:
            counts[key] += 1
    return counts


def kernel_ms_by_id(by_name: dict) -> dict:
    """Device ms of each kernel's symbol (K7: its tile kernel) in a
    profiled run's {name: ms}."""
    out = {key: 0.0 for key, _p in KERNEL_SYMBOLS}
    for name, ms in by_name.items():
        key = kernel_id(name)
        if key is not None:
            out[key] += ms
    return out


def host_ops_in(prof) -> int:
    """Host-side operator events of a profiled run (nested ones too)."""
    import torch

    return sum(1 for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CPU
               and not getattr(ev, "is_user_annotation", False))


def top_kernels(by_name: dict, n: int = 8) -> dict:
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return {name[:90]: ms for name, ms in top}


def launch_counters() -> dict:
    """{kernel id: its wrapper}; each wrapper counts its own launches."""
    from alignn_tpu_torch.ops import dense as dk
    from alignn_tpu_torch.ops import eggc as ek
    from alignn_tpu_torch.ops import fused_lstage as fk
    from alignn_tpu_torch.ops import gather as gk

    return {"K1": ek.gated_aggregate_cuda, "K2": ek.sorted_segment_sum_cuda,
            "K3": dk.dense_gated_aggregate_cuda,
            "K4": dk.dense_pair_aggregate_cuda,
            "K5a": dk.pair_aggregate_bwd_cuda,
            "K5b": dk.pair_aggregate_bwd2_cuda,
            "K6": fk.fused_pair_lstage_cuda,
            "K7": fk.fused_lstage_bwd_cuda,
            "K8": gk.windowed_gather_cuda}


def reset_launches():
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {k: fn.launches for k, fn in launch_counters().items()}


def si_cells():
    return [("diamond8", diamond()), ("si64_rattled", rattled_supercell(2)),
            ("si512_rattled", rattled_supercell(4))]


# kernels each layout must launch, and must not, in a serving call and in
# a train step (which adds K5b, the second order of K4).  Serving builds no
# gather windows, so no serving layout launches K8; "wsparse" is the sparse
# layout with ALIGNN_TPU_ENABLE_WGATHER set.
# "envelope" is the sparse layout of an envelope-weighted model: its soft
# sums and gather transposes run K2, and nothing else.
NOT_K2 = ("K1", "K3", "K4", "K5a", "K5b", "K6", "K7", "K8")
# eALIGNN's inner-cutoff weights take the soft-weight branches on every
# layout: K2 (its sums and gather transposes), plain sums in place of K3
# and K4, and no fused L-stage under ALIGNN_TPU_FUSED_LSTAGE.
LAYOUT_KERNELS = {"sparse": (("K1", "K2"), ("K6", "K7", "K8")),
                  "dense": (("K3", "K4", "K5a"), ("K1", "K6", "K7", "K8")),
                  "fused": (("K3", "K6", "K7"), ("K1", "K4", "K5a", "K8")),
                  "envelope": (("K2",), NOT_K2),
                  "ealignn_sparse": (("K2",), NOT_K2),
                  "ealignn_dense": (("K2",), NOT_K2),
                  "ealignn_fused": (("K2",), NOT_K2)}
DENSE_LAYOUTS = ("dense", "fused", "ealignn_dense", "ealignn_fused")
TRAIN_KERNELS = {"xff": (("K1", "K2"), ("K3", "K4", "K5a", "K5b", "K6",
                                         "K7", "K8")),
                 "sparse": LAYOUT_KERNELS["sparse"],
                 "envelope": LAYOUT_KERNELS["envelope"],
                 "dense": (("K3", "K4", "K5a", "K5b"),
                           ("K1", "K6", "K7", "K8")),
                 "fused": (("K3", "K6", "K7"), ("K1", "K4", "K5a", "K5b",
                                                "K8")),
                 "wsparse": (("K1", "K2", "K8"), ("K3", "K4", "K5a", "K5b",
                                                  "K6", "K7"))}


def run_cells(new_calc, cells, layout: str, failures: list):
    """Drive a fresh Calculator per cell: 2 warm-up and 5 timed calls,
    then the stage breakdown.  `layout` is sparse, envelope (sparse, an
    envelope-weighted model), dense or fused (dense with
    ALIGNN_TPU_FUSED_LSTAGE set).  Returns [(row, atoms, result)]."""
    import torch

    rows = []
    for name, atoms in cells:
        calc = new_calc()
        k0 = read_launches()
        for _ in range(2):
            res = calc.calculate(atoms)
        times = []
        for _ in range(5):
            t = time.perf_counter()
            res = calc.calculate(atoms)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        calls = 7
        k1 = read_launches()
        per_call = {k: (k1[k] - k0[k]) / calls for k in k1}
        g, stages, top_kernels = breakdown(calc, atoms)
        median_ms = float(np.median(times))
        n = atoms.num_atoms
        forces = res["forces"]
        row = {
            "cell": name, "layout": layout,
            "atoms": n, "edges": g.num_edges,
            "lg_edges": g.num_lg_edges,
            "bucket": list(vars(calc._spec).values()),
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
            "launches_per_call": per_call,
        }
        finite = np.isfinite(forces).all() and np.isfinite(
            res["stress"]).all() and np.isfinite(res["energy"])
        if not finite or forces.shape != (n, 3):
            failures.append(f"{name}: non-finite or misshaped output")
        # eALIGNN's forces carry the cell's atom count as a factor (a
        # quirk of the reference), and so does their sum's rounding
        sum_tol = 1e-3 * (n if layout.startswith("ealignn") else 1)
        if row["abs_sum_force"] > sum_tol:
            failures.append(f"{name}: |sum F| = {row['abs_sum_force']}")
        if layout in DENSE_LAYOUTS and (calc._spec is None
                                        or calc._spec.dense_D == 0):
            failures.append(f"{name}: the dense Calculator ran sparse")
        need, banned = LAYOUT_KERNELS[layout]
        if any(per_call[k] <= 0 for k in need) or \
                any(per_call[k] != 0 for k in banned):
            failures.append(f"{name}: launches per call {per_call} (need "
                            f"{need}, none of {banned})")
        rows.append((row, atoms, res))
    return rows


def check_against(rows, ref_calc, label: str, failures: list):
    """E/F/S of each row's result against ``ref_calc`` within CPU_TOL."""
    check_results(rows, [ref_calc().calculate(atoms) for _r, atoms, _x in
                         rows], label, failures)


def check_results(rows, refs, label: str, failures: list):
    """E/F/S of each row's result against the result `refs` holds for it,
    within CPU_TOL."""
    for (row, atoms, res), ref in zip(rows, refs):
        n = atoms.num_atoms
        diff = {
            "energy_per_atom": abs(res["energy"] - ref["energy"]) / n,
            "forces": float(np.abs(res["forces"] - ref["forces"]).max()),
            "stress": float(np.abs(res["stress"] - ref["stress"]).max())}
        row[f"vs_{label}"] = diff
        for key, tol in CPU_TOL.items():
            if not diff[key] <= tol:
                failures.append(f"{row['cell']}: {key} differs from the "
                                f"{label} by {diff[key]} > {tol}")


def rocksalt_b64():
    """The 64 labelled rocksalt cells of ``bench.py`` (seed 0)."""
    from alignn_tpu_torch.graph.build import rocksalt_graphs

    return rocksalt_graphs(64, seed=0)


def batch_phase(model, failures: list):
    """dense_rocksalt_b64: one dense and one sparse batch of the same 64
    graphs through ``atomwise_forward``; per-graph E and S, per-atom F."""
    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.graph.dense import (dense_batch_graphs,
                                              dense_spec_for_batch)
    from alignn_tpu_torch.nn.models import atomwise_forward

    dev = next(model.parameters()).device
    graphs = rocksalt_b64()
    spec = dense_spec_for_batch(graphs)
    dense = dense_batch_graphs(graphs, spec, dev)
    sparse = batch_graphs(graphs, BucketSpec.tight_for_batch(graphs), dev)
    ng, n = len(graphs), sum(g.num_nodes for g in graphs)
    out = {}
    for name, batch in (("dense", dense), ("sparse", sparse)):
        if name == "dense":
            reset_launches()
        res = forward_numpy(model, batch)
        if name == "dense":
            launches = read_launches()
        t = []
        for _ in range(3):
            t0 = time.perf_counter()
            atomwise_forward(model, batch)["grad"].cpu()
            t.append((time.perf_counter() - t0) * 1e3)
        out[name] = (res, float(np.median(t)))
    (rd, dense_ms), (rs, sparse_ms) = out["dense"], out["sparse"]
    diff = efs_diff(rd, rs, ng, n)
    row = {"cell": "dense_rocksalt_b64", "graphs": ng, "atoms": n,
           "edges": sum(g.num_edges for g in graphs),
           "lg_edges": sum(g.num_lg_edges for g in graphs),
           "dense_bucket": list(vars(spec).values()),
           "launches": launches, "dense_ms": dense_ms,
           "sparse_ms": sparse_ms, "dense_vs_sparse": diff,
           "max_abs_force": float(np.abs(rd["grad"][:n]).max())}
    for key, tol in CPU_TOL.items():
        if not diff[key] <= tol:
            failures.append(f"dense_rocksalt_b64: {key} dense vs sparse "
                            f"{diff[key]} > {tol}")
    finite = all(np.isfinite(v).all() for v in rd.values())
    if not finite or spec.dense_D == 0 or launches["K1"] != 0 or \
            min(launches[k] for k in ("K3", "K4", "K5a")) <= 0:
        failures.append(f"dense_rocksalt_b64: finite {finite}, D "
                        f"{spec.dense_D}, launches {launches}")
    return row


def forward_numpy(model, batch) -> dict:
    """out, grad (forces) and stresses of ``atomwise_forward`` as numpy
    (the copy synchronises)."""
    from alignn_tpu_torch.nn.models import atomwise_forward

    res = atomwise_forward(model, batch)
    return {k: res[k].detach().cpu().numpy()
            for k in ("out", "grad", "stresses")}


def efs_diff(a: dict, b: dict, ng: int, n: int) -> dict:
    """Largest E (per graph row of `out`), F and S (eV/A^3) differences of
    two atomwise_forward results over `ng` graphs and `n` atoms."""
    from alignn_tpu_torch.nn.models import EV_A3_TO_GPA

    return {"energy_per_atom": float(np.abs(a["out"][:ng, 0]
                                            - b["out"][:ng, 0]).max()),
            "forces": float(np.abs(a["grad"][:n] - b["grad"][:n]).max()),
            "stress": float(np.abs(a["stresses"][:ng] - b["stresses"][:ng])
                            .max() / EV_A3_TO_GPA),
            "bitwise_equal": bool(all(np.array_equal(a[k][:m], b[k][:m])
                                      for k, m in (("out", ng), ("grad", n),
                                                   ("stresses", ng))))}


TRAIN_CFG = dict(  # bench.py's model and loss weights, full f32
    name="alignn_atomwise", alignn_layers=4, gcn_layers=4,
    hidden_features=256, embedding_features=64, gradwise_weight=10.0,
    stresswise_weight=0.1, graphwise_weight=1.0)
TRAIN_TOL = {"loss_rel": 1e-4, "grad_rel": 1e-3, "grad_abs": 1e-7}


def first_step(weights, batch, cfg=TRAIN_CFG, dtype=None):
    """(loss components, gradient of every parameter) of one train step
    of a fresh model of config `cfg` and compute dtype `dtype` from
    `weights` on `batch`'s device."""
    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig)
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    model = ALIGNNAtomWise(ALIGNNAtomWiseConfig(**cfg), dtype=dtype)
    model.load_state_dict(weights)
    state = create_train_state(model, batch,
                               build_optimizer("adamw", 1e-3, 1e-5))
    _state, losses = make_train_step(model, cuda_graph=False)(state, batch)
    return ({k: float(v) for k, v in losses.items()},
            {k: p.grad.detach().cpu() for k, p in model.named_parameters()})


def step_diff(a, b, what: str, failures: list) -> dict:
    """Loss components and gradients of two first steps, within
    TRAIN_TOL (gradients per tensor: max abs diff <= grad_rel x that
    tensor's max|grad| + grad_abs)."""
    (la, ga), (lb, gb) = a, b
    loss_rel = max(abs(la[k] - lb[k]) / max(abs(lb[k]), 1e-30) for k in lb)
    worst, worst_name = 0.0, ""
    for k, ref in gb.items():
        diff = float((ga[k] - ref).abs().max())
        ratio = diff / (TRAIN_TOL["grad_rel"] * float(ref.abs().max())
                        + TRAIN_TOL["grad_abs"])
        if ratio > worst:
            worst, worst_name = ratio, k
    if not loss_rel <= TRAIN_TOL["loss_rel"]:
        failures.append(f"train {what}: loss components differ by "
                        f"{loss_rel} (relative) > {TRAIN_TOL['loss_rel']}")
    if not worst <= 1.0:
        failures.append(f"train {what}: gradient of {worst_name} at "
                        f"{worst} x its limit")
    return {"loss_max_rel_diff": loss_rel,
            "grad_worst_share_of_limit": worst, "grad_worst": worst_name}


def train_batches(gs, device):
    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.graph.dense import (dense_batch_graphs,
                                              dense_spec_for_batch)

    return {"dense": dense_batch_graphs(gs, dense_spec_for_batch(gs), device),
            "sparse": batch_graphs(gs, BucketSpec.tight_for_batch(gs),
                                   device)}


def train_run(weights, batch, layout: str, failures: list, steps: int = 12,
              warmup: int = 2, cfg=TRAIN_CFG, dtype=None,
              cuda_graph: bool = False):
    """`steps` E/F/S train steps of a fresh model of config `cfg` and
    compute dtype `dtype` from `weights` on `batch`, the first `warmup`
    untimed: ms per step, edges per second over the timed window, launches
    per step, peak memory, one profiled step.  The eager step, unless
    `cuda_graph`: then the compiled step (its third step captures, the
    rest replay), with the capture's ms and the profiled replay's launches
    counted from the profiler.  Returns (row, first step's losses and
    gradients, launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig)
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    model = ALIGNNAtomWise(ALIGNNAtomWiseConfig(**cfg), dtype=dtype)
    model.load_state_dict(weights)
    state = create_train_state(model, batch,
                               build_optimizer("adamw", 1e-3, 1e-5))
    step = make_train_step(model, cuda_graph=cuda_graph)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    trajectory, times, first = [], [], None
    for i in range(steps):
        t = time.perf_counter()
        state, losses = step(state, batch)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t) * 1e3)
        if i == 0:   # the step leaves its gradients in place
            first = ({k: float(v) for k, v in losses.items()},
                     {k: p.grad.detach().cpu()
                      for k, p in model.named_parameters()})
        trajectory.append(losses)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    trajectory = [{k: float(v) for k, v in ls.items()} for ls in trajectory]
    for _ in range(2):   # the first pays the profiler's start-up
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(state, batch)
            torch.cuda.synchronize()
    by_name, n_device_ops = device_ms_by_name(prof)
    busy = sum(by_name.values())
    median_ms = float(np.median(times))
    n_edges = int(batch.edge_mask.sum().item() + batch.lg_mask.sum().item())
    row = {
        "layout": layout, "bucket": [batch.z.shape[0], batch.r.shape[0],
                                     batch.lg_mask.shape[0], batch.dense_D],
        "ms_per_step": median_ms, "ms_steps": times,
        "steps": f"{warmup} warm-up + {steps - warmup} timed",
        "edges_per_step": n_edges,
        # over the whole timed window, so a stall counts
        "train_step_edges_per_s": len(times) * n_edges / (sum(times) / 1e3),
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "peak_memory_bytes": peak,
        "device_busy_ms": busy, "device_busy_share": busy / median_ms,
        "device_ops_per_step": n_device_ops,
        "top_kernels_ms": top_kernels(by_name),
        "losses": trajectory}
    if cuda_graph:
        loops = list(step.compiled.loops.values())
        row.update(captures=step.compiled.captures,
                   capture_ms=[lp.capture_ms for lp in loops if lp.graph],
                   launches_per_step_from_profile=kernel_launches_in(prof),
                   host_ops_per_step=host_ops_in(prof))
        if step.compiled.captures != 1:
            failures.append(f"train {layout}: {step.compiled.captures} "
                            f"captures over {steps} steps of one batch")
    if not all(np.isfinite(v) for ls in trajectory for v in ls.values()):
        failures.append(f"train {layout}: non-finite losses")
    need, banned = TRAIN_KERNELS[layout]
    if any(launches[k] <= 0 for k in need) or \
            any(launches[k] != 0 for k in banned):
        failures.append(f"train {layout}: launches {launches} (need {need}, "
                        f"none of {banned})")
    del state, model, prof, step
    torch.cuda.empty_cache()
    return row, first, {k: v / steps for k, v in launches.items()}


NOT_BIT_IDENTICAL = (
    "index_add (ops/segment.py's segment sums and the transpose of "
    "x[idx]) adds with CUDA atomics in an order that varies from run to "
    "run, captured or eager; under torch.use_deterministic_algorithms it "
    "sums in a fixed order and the runs agree bit for bit")


def deterministic_pair(weights, batch, cfg, dtype, steps: int = 12) -> dict:
    """`steps` train steps of one batch from `weights`, compiled (two eager
    sightings, a capture, replays) and eager, both under torch's
    deterministic algorithms: every loss component of every step and
    every final parameter and buffer bit for bit."""
    import torch

    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig)
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    runs = []
    with deterministic():
        for graph in (True, False):
            model = ALIGNNAtomWise(ALIGNNAtomWiseConfig(**cfg), dtype=dtype)
            model.load_state_dict(weights)
            state = create_train_state(model, batch, build_optimizer(
                "adamw", 1e-3, 1e-5))
            step = make_train_step(model, cuda_graph=graph)
            losses = []
            for _ in range(steps):
                state, out = step(state, batch)
                losses.append(torch.stack(list(out.values())))
            captures = step.compiled.captures if graph else 0
            runs.append((torch.stack(losses), {
                k: v.detach().clone() for k, v in model.state_dict().items()},
                captures))
            del state, model, step
    (la, pa, captures), (lb, pb, _c) = runs
    differ = [k for k in pa if not torch.equal(pa[k], pb[k])]
    return {"steps": steps, "captures": captures,
            "losses_bitwise": bool(torch.equal(la, lb)),
            "params_bitwise": not differ, "params_differing": differ[:5],
            "bitwise": bool(torch.equal(la, lb)) and not differ}


def captured_bench_step(weights, batch, cfg, dtype, eager_row: dict,
                        failures: list) -> dict:
    """bench.py's default step (bf16, dense, b64) compiled: 12 steps (2
    eager sightings, the capture, 9 replays) against `eager_row`, the
    same 12 steps eager: ms a step, the profiled replay's device ms and
    launches, the capture's ms and the steps it takes to pay back, peak
    memory; the default mode's losses held to the 16-bit first-step
    limit at every step, the replays' too; then the deterministic pair,
    bit for bit."""
    row, _first, _l = train_run(weights, batch, "dense", failures, cfg=cfg,
                                dtype=dtype, cuda_graph=True)
    replay_ms = float(np.median(row["ms_steps"][1:]))
    saving = eager_row["ms_per_step"] - replay_ms
    gaps = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
            for a, b in zip(row["losses"], eager_row["losses"])]
    bitwise = all(a == b for a, b in zip(row["losses"],
                                         eager_row["losses"]))
    if not max(gaps) <= PREC_TOL["loss_rel"]:
        failures.append(f"precision bf16_dense captured vs eager: step "
                        f"losses {gaps} apart (relative)")
    pair = deterministic_pair(weights, batch, cfg, dtype)
    if not pair["bitwise"] or pair["captures"] != 1:
        failures.append(f"precision bf16_dense: captured vs eager under "
                        f"deterministic algorithms {pair}")
    return {"ms_per_step_eager": eager_row["ms_per_step"],
            "ms_steps_captured": row["ms_steps"],
            "replayed_ms": replay_ms,
            "device_ms": row["device_busy_ms"],
            "device_busy_share": row["device_busy_ms"] / replay_ms,
            "device_ms_eager": eager_row["device_busy_ms"],
            "capture_ms": row["capture_ms"],
            "break_even_steps": row["capture_ms"][0] / saving
            if saving > 0 else None,
            "peak_memory_bytes": row["peak_memory_bytes"],
            "peak_memory_bytes_eager": eager_row["peak_memory_bytes"],
            "launches_per_replayed_step":
                row["launches_per_step_from_profile"],
            "host_ops_per_replayed_step": row["host_ops_per_step"],
            "default_mode": {"bitwise": bitwise, "first_loss_rel": gaps[0],
                             "max_step_loss_rel": max(gaps),
                             "not_bit_identical": None if bitwise
                             else NOT_BIT_IDENTICAL},
            "deterministic": pair}


def train_phase(weights, graphs, failures: list):
    """dense_rocksalt_b64 training: bench.py's E/F/S train step (4+4/256,
    L1 loss, AdamW lr 1e-3 wd 1e-5, f32) on the 64 labelled rocksalt
    cells, dense then sparse, from one seeded set of weights.  First
    K3/K4/K5a/K5b and K6/K7 against their plain versions at the dense
    batch's own shapes; then per layout 2 warm-up and 10 timed steps,
    launches per step, peak memory, one profiled step; the first step's
    losses and gradients dense against sparse, and on the first 8 cells
    the card against the port on the CPU.

    Returns (row, launches per step per layout, kernel results at the
    training shapes, those shapes, the first step of each layout)."""
    import torch

    dev = torch.device("cuda")
    rows, first, launch_runs = {}, {}, {}
    for layout, batch in train_batches(graphs, dev).items():
        if layout == "dense":
            dshape = dense_shape(batch)
            kernels = dense_kernel_phase(batch, failures)
            kernels.update(fused_kernel_phase(batch, failures))
            torch.cuda.empty_cache()
        else:
            # K1/K2 at the sparse batch's L-stage (rows = its L-edges)
            seg = batch.lg_index.dst
            sparse_lstage = kernel_phase(seg, failures)
            del seg
            torch.cuda.empty_cache()
        rows[layout], first[layout], launch_runs[layout] = train_run(
            weights, batch, layout, failures)
        del batch
    checks = {"dense_vs_sparse": step_diff(first["dense"], first["sparse"],
                                           "dense vs sparse", failures)}
    cpu_batches = train_batches(graphs[:8], torch.device("cpu"))
    for layout, batch in train_batches(graphs[:8], dev).items():
        checks[f"{layout}_8_vs_cpu_port"] = step_diff(
            first_step(weights, batch),
            first_step(weights, cpu_batches[layout]),
            f"{layout} 8 cells card vs CPU", failures)
    kernels["sparse_lstage"] = sparse_lstage
    return {"cell": "dense_rocksalt_b64", "config": TRAIN_CFG,
            "optimizer": "adamw lr 1e-3 wd 1e-5, no decay mask",
            "precision": "f32 (TF32 off)", "tolerances": TRAIN_TOL,
            **checks, "dense": rows["dense"], "sparse": rows["sparse"]}, \
        launch_runs, kernels, dshape, first


def fused_train_phase(weights, graphs, dense_first, failures: list):
    """The dense train step with ALIGNN_TPU_FUSED_LSTAGE set (by the
    caller) on dense_rocksalt_b64: 2 warm-up and 10 timed steps, the
    first step's losses and gradients against the unfused dense step's,
    and on the first 8 cells against the port's fused step on the CPU."""
    import torch

    dev = torch.device("cuda")
    batch = train_batches(graphs, dev)["dense"]
    row, first, launches = train_run(weights, batch, "fused", failures)
    del batch
    checks = {"fused_vs_dense": step_diff(first, dense_first,
                                          "fused vs dense", failures),
              "fused_8_vs_cpu_port": step_diff(
                  first_step(weights, train_batches(graphs[:8],
                                                    dev)["dense"]),
                  first_step(weights, train_batches(
                      graphs[:8], torch.device("cpu"))["dense"]),
                  "fused 8 cells card vs CPU", failures)}
    return {"cell": "dense_rocksalt_b64", "layout": "fused",
            "precision": "f32 (TF32 off)", "tolerances": TRAIN_TOL, **checks,
            "fused": row}, launches


def blocky_indices(rng, blocks, refs_per_block, trash, quantum=512):
    """Batched-graph-style indices (tests/test_pallas_gather.py): random
    refs into each block, then trash up to a multiple of `quantum`."""
    idx, off = [], 0
    for b in blocks:
        idx.extend(off + rng.integers(0, b, size=refs_per_block * b))
        off += b
    m = -(-len(idx) // quantum) * quantum
    return np.array(list(idx) + [trash] * (m - len(idx)), dtype=np.int64)


def gather_sites(batch) -> list:
    """(site, table rows, F, index tensor, window) of every gather of a
    sparse training step on `batch` (hidden 256): the node stage's src
    gather of [src_gate | bh], its dst gather, the aggregation backward's
    [ginv | gh] gather, the same three in the L-stage, and the gathers of
    the second order by the sorted src and lg_src."""
    n, e = batch.z.shape[0], batch.r.shape[0]
    g, lg = batch.g_index, batch.lg_index
    return [("node_src", n, 512, g.src, batch.win_src),
            ("node_dst", n, 256, g.dst.ids, batch.win_dst),
            ("node_agg_bwd", n, 512, g.dst.ids, batch.win_dst),
            ("node_src_sorted", n, 512, g.src_sorted.ids,
             batch.win_src_sorted),
            ("lstage_src", e, 512, lg.src, batch.win_lg_src),
            ("lstage_dst", e, 256, lg.dst.ids, batch.win_lg_dst),
            ("lstage_agg_bwd", e, 512, lg.dst.ids, batch.win_lg_dst),
            ("lstage_src_sorted", e, 512, lg.src_sorted.ids,
             batch.win_lg_src_sorted)]


def gather_kernel_phase(batch, failures: list):
    """K8 against windowed_gather_plain on the card, exactly (torch.equal),
    f32 and bf16: at every gather of the sparse training batch `batch`
    (its own windows) and on blocky indices (an all-trash tile, a sparse
    tile, a window under the span).  Times (f32 and bf16) at the L-stage
    src gather [L, 512] and (f32) at the dst gather [L, 256], beside one
    ``index_select`` (which differs only on trash rows) and the byte
    bound: the table read once (the window stays in L2), the indices
    read, the output written."""
    import torch

    from alignn_tpu_torch.ops import gather as gk

    dev = batch.r.device
    gen = torch.Generator(device=dev).manual_seed(3)
    rng = np.random.default_rng(0)
    trash = 1279
    blocky = blocky_indices(rng, [180, 200, 150, 190, 170, 160], 4, trash)
    sparse = np.full(1024, trash, np.int64)
    sparse[812:852] = 7
    sites = gather_sites(batch) + [
        ("blocky", 1280, 256, blocky, gk.window_for(blocky, trash)),
        ("below_span", 1280, 256, blocky, 256),
        ("sparse_tile", 1280, 256, sparse, gk.window_for(sparse, trash))]
    checks = {}
    for site, rows, f, idx, w in sites:
        idx = torch.as_tensor(idx, device=dev)
        x32 = torch.randn(rows, f, device=dev, generator=gen)
        checks[site] = {"rows": rows, "features": f, "indices": idx.shape[0],
                        "window": w}
        if not gk.eligible(x32, idx, w):
            failures.append(f"K8 {site}: window {w} does not take the "
                            f"window path")
            continue
        for dtype in kernel_dtypes():
            x = x32.to(dtype)
            got = gk.windowed_gather_cuda(x, idx, w)
            ref = gk.windowed_gather_plain(x, idx, w)
            torch.cuda.synchronize()
            name = str(dtype).split(".")[1]
            equal = torch.equal(got, ref)
            err = (got.float() - ref.float()).abs().max().item()
            checks[site][name] = {
                "equal": equal, "max_abs_err": err,
                "rel_err": err / max(ref.float().abs().max().item(), 1e-30),
                "zero_rows": int((got == 0).all(dim=1).sum().item())}
            if not equal:
                failures.append(f"K8 {site} [{name}]: differs from its "
                                f"plain version")
    results = {"checks": checks}
    sites = {s[0]: s for s in gather_sites(batch)}
    for key, site, dtypes in (
            ("float32", "lstage_src", kernel_dtypes()),
            ("dst_float32", "lstage_dst", (torch.float32,))):
        _s, rows, f, idx, w = sites[site]
        x32 = torch.randn(rows, f, device=dev, generator=gen)
        for dtype in dtypes:
            x = x32.to(dtype)
            m = idx.shape[0]
            b_ms, b_by = bound((m + rows) * f * x.element_size()
                               + m * idx.element_size(), 0.0)
            # the largest error over every checked site, in this dtype
            errs = [c[str(dtype).split(".")[1]] for c in checks.values()
                    if str(dtype).split(".")[1] in c]
            entry = {
                "site": site, "shape": [rows, f, m], "window": w,
                "max_abs_err": max(e["max_abs_err"] for e in errs),
                "rel_err": max(e["rel_err"] for e in errs), "tol_rel": 0.0,
                "ms": cuda_ms(lambda: gk.windowed_gather_cuda(x, idx, w)),
                "plain_ms": cuda_ms(
                    lambda: gk.windowed_gather_plain(x, idx, w)),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": cuda_ms(lambda: x.index_select(0, idx)),
                "host_us": host_us(lambda: gk.windowed_gather(x, idx, w)),
                "library_host_us": host_us(lambda: x.index_select(0, idx))}
            results[key if dtype == torch.float32
                    else str(dtype).split(".")[1]] = entry
        del x32, x
    torch.cuda.empty_cache()
    return results


def wgather_batch_phase(model, cpu_model, failures: list):
    """dense_rocksalt_b64 as one sparse windowed batch through
    ``atomwise_forward`` with ALIGNN_TPU_ENABLE_WGATHER on (it must launch
    K8 and no dense kernel) against the same call with it off, and the
    first 8 cells on the card against the CPU port, both windowed; E, F
    and S within CPU_TOL."""
    import torch

    from alignn_tpu_torch.graph.batch import (WIN_FIELDS, BucketSpec,
                                              batch_graphs)
    from alignn_tpu_torch.nn.models import atomwise_forward

    dev = next(model.parameters()).device
    graphs = rocksalt_b64()
    batch = batch_graphs(graphs, BucketSpec.tight_for_batch(graphs), dev)
    ng, n = len(graphs), sum(g.num_nodes for g in graphs)
    row = {"cell": "dense_rocksalt_b64", "layout": "sparse, windowed",
           "bucket": list(vars(BucketSpec.tight_for_batch(graphs)).values()),
           "windows": {k: getattr(batch, k) for k in WIN_FIELDS}}

    def median_ms() -> float:   # as batch_phase times it: grad copied
        t = []
        for _ in range(3):
            t0 = time.perf_counter()
            atomwise_forward(model, batch)["grad"].cpu()
            t.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(t))

    off = forward_numpy(model, batch)
    row["ms_unwindowed"] = median_ms()
    with switch_env(WGATHER_ENV):
        reset_launches()
        on = forward_numpy(model, batch)
        torch.cuda.synchronize()
        row["launches"] = read_launches()
        row["ms_windowed"] = median_ms()
        g8 = graphs[:8]
        spec8 = BucketSpec.tight_for_batch(g8)
        card8 = forward_numpy(model, batch_graphs(g8, spec8, dev))
        cpu8 = forward_numpy(cpu_model, batch_graphs(
            g8, spec8, torch.device("cpu")))
    n8 = sum(g.num_nodes for g in g8)
    row.update({"windowed_vs_unwindowed": efs_diff(on, off, ng, n),
                "windowed_8_vs_cpu_port": efs_diff(card8, cpu8, 8, n8)})
    for label in ("windowed_vs_unwindowed", "windowed_8_vs_cpu_port"):
        for key, tol in CPU_TOL.items():
            if not row[label][key] <= tol:
                failures.append(f"wgather_batch: {key} {label} "
                                f"{row[label][key]} > {tol}")
    finite = all(np.isfinite(v).all() for v in on.values())
    need, banned = TRAIN_KERNELS["wsparse"]
    if not finite or any(row["launches"][k] <= 0 for k in need) or \
            any(row["launches"][k] != 0 for k in banned):
        failures.append(f"wgather_batch: finite {finite}, launches "
                        f"{row['launches']} (need {need}, none of {banned})")
    return row


def wgather_train_phase(weights, graphs, sparse_first, failures: list):
    """The sparse train step with ALIGNN_TPU_ENABLE_WGATHER set (by the
    caller) on dense_rocksalt_b64: 2 warm-up and 10 timed steps, the first
    step's losses and gradients against the unwindowed sparse step's, and
    on the first 8 cells against the port's windowed step on the CPU."""
    import torch

    from alignn_tpu_torch.graph.batch import WIN_FIELDS

    dev = torch.device("cuda")
    batch = train_batches(graphs, dev)["sparse"]
    windows = {k: getattr(batch, k) for k in WIN_FIELDS}
    row, first, launches = train_run(weights, batch, "wsparse", failures)
    del batch
    checks = {"windowed_vs_sparse": step_diff(first, sparse_first,
                                              "windowed vs sparse", failures),
              "windowed_8_vs_cpu_port": step_diff(
                  first_step(weights, train_batches(graphs[:8],
                                                    dev)["sparse"]),
                  first_step(weights, train_batches(
                      graphs[:8], torch.device("cpu"))["sparse"]),
                  "windowed 8 cells card vs CPU", failures)}
    return {"cell": "dense_rocksalt_b64", "layout": "sparse, windowed",
            "windows": windows, "precision": "f32 (TF32 off)",
            "tolerances": TRAIN_TOL, **checks, "wsparse": row}, launches


def loader_phase(weights, failures: list):
    """One shuffled epoch (seed 0) of the port's BucketedLoader
    (worst_case_spec, batch 64, prefetch thread) over 256 rocksalt cells
    made as bench.py makes them (seed 0), through the windowed sparse train
    step (ALIGNN_TPU_ENABLE_WGATHER set by the caller): every batch's
    floored windows, the loader's floors, the loss per step, the host time
    to build a batch against the step's (and a data-parallel rank's, shard
    0 of 2, with the time the other shard's windows take), and the
    launches of the epoch."""
    import torch

    from alignn_tpu_torch.data.dataset import GraphDataset
    from alignn_tpu_torch.data.loader import BucketedLoader, worst_case_spec
    from alignn_tpu_torch.graph.batch import WIN_FIELDS, batch_windows
    from alignn_tpu_torch.graph.build import rocksalt_graphs
    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig)
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    t0 = time.perf_counter()
    graphs = rocksalt_graphs(256, seed=0)
    graph_s = time.perf_counter() - t0
    spec = worst_case_spec(graphs, 64)
    loader = BucketedLoader(
        GraphDataset(graphs, [f"rocksalt-{i}" for i in range(256)]), 64,
        shuffle=True, spec=spec, seed=0)
    order = loader._order()
    build_ms = []
    for s in range(2):   # outside the epoch: no floor is touched
        t0 = time.perf_counter()
        loader._make_batch(order[s * 64:(s + 1) * 64])
        torch.cuda.synchronize()
        build_ms.append((time.perf_counter() - t0) * 1e3)
    # a data-parallel rank's batch (shard 0 of 2): its own batch, and the
    # other shard's windows from that shard's index arrays alone
    dp_loader = BucketedLoader(
        GraphDataset(graphs, [f"rocksalt-{i}" for i in range(256)]), 64,
        shuffle=True, spec=spec, seed=0, num_shards=2)
    dp_order = dp_loader._order()
    dp_build_ms, windows_ms = [], []
    for s in range(2):
        t0 = time.perf_counter()
        dp_loader._batch_for_step(dp_order, s)
        torch.cuda.synchronize()
        dp_build_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        batch_windows([graphs[i] for i in dp_loader._shard(dp_order, s, 1)],
                      spec)
        windows_ms.append((time.perf_counter() - t0) * 1e3)
    model = ALIGNNAtomWise(ALIGNNAtomWiseConfig(**TRAIN_CFG)).cuda()
    model.load_state_dict(weights)
    it = iter(loader)
    first = next(it)   # state and step from the first batch
    state = create_train_state(model, first,
                               build_optimizer("adamw", 1e-3, 1e-5))
    step = make_train_step(model)
    torch.cuda.synchronize()
    steps, batch = [], first
    reset_launches()
    while batch is not None:
        t0 = time.perf_counter()
        state, losses = step(state, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        steps.append({"windows": {k: getattr(batch, k) for k in WIN_FIELDS},
                      "real_edges": int(batch.edge_mask.sum().item()
                                        + batch.lg_mask.sum().item()),
                      "loss": float(losses["loss"]), "step_ms": step_ms})
        t0 = time.perf_counter()
        batch = next(it, None)
        steps[-1]["wait_next_batch_ms"] = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    row = {"cell": "rocksalt_256_loader", "graphs": 256, "batch_size": 64,
           "bucket": list(vars(spec).values()), "graph_build_s": graph_s,
           "host_batch_build_ms": build_ms,
           "host_batch_build_ms_dp_shard_0_of_2": dp_build_ms,
           "other_shard_windows_ms": windows_ms, "steps": steps,
           "floors": dict(loader._win_floor),
           # the compiled step: windows at their floor, one signature
           "signatures": len(step.compiled.loops),
           "captures": step.compiled.captures,
           "launches": launches,
           "launches_per_step": {k: v / len(steps)
                                 for k, v in launches.items()}}
    if len(steps) != 4 or not all(np.isfinite(s_["loss"]) for s_ in steps):
        failures.append(f"loader: {len(steps)} steps, losses "
                        f"{[s_['loss'] for s_ in steps]}")
    need, banned = TRAIN_KERNELS["wsparse"]
    if any(launches[k] <= 0 for k in need) or \
            any(launches[k] != 0 for k in banned):
        failures.append(f"loader: launches {launches} (need {need}, none of "
                        f"{banned})")
    if step.compiled.captures != 1:
        failures.append(f"loader: {step.compiled.captures} captures over "
                        f"{len(steps)} windowed steps of one bucket")
    del state, model, first, step
    torch.cuda.empty_cache()
    return row


ENVELOPE_DIRS = {el: os.path.join(REPO, "docs", "mlearn_r5",
                                  f"{el}_envelope") for el in ("Si", "Cu")}
ENVELOPE_TRAIN_CFG = {**TRAIN_CFG, "envelope_edge_weights": True,
                      "envelope_cutoff": 4.5}
# bench.py's 64 cells with the envelope potentials' radius graph hold
# 825,754 L-edges, which at the sparse step's ~130 KB a row would take
# about 107 GB: the first 16 are trained
ENVELOPE_TRAIN_CELLS = 16


def rattled_fcc(n: int, a: float = 3.61):
    """n x n x n conventional fcc Cu cells, rattled as the Si cells."""
    from alignn_tpu_torch.chem.atoms import Atoms

    fcc = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    cells = np.array([[i, j, k] for i in range(n) for j in range(n)
                      for k in range(n)])
    frac = ((fcc[None] + cells[:, None]) / n).reshape(-1, 3)
    lat = np.eye(3) * a * n
    cart = frac @ lat + np.random.default_rng(0).normal(0.0, 0.03,
                                                        frac.shape)
    return Atoms(lattice_mat=lat, frac_coords=cart @ np.linalg.inv(lat),
                 elements=["Cu"] * len(frac))


def envelope_slice(failures: list):
    """The envelope-weighted potentials of round 5 at full width on the
    card: ``Si_envelope`` (4+4/256, radius 4.5 A) on the three Si cells,
    ``Cu_envelope`` (2+4/256) on a rattled 108-atom fcc cell; each cell's
    E/F/S against the port on the CPU at the serving limits.  Counts from
    0 over the four cells; they must launch K2 and no other kernel.  The
    graph stage of these radius potentials reuses the skin candidate set;
    ``graph_first_call_ms`` is a fresh Calculator's first build.  Then K2
    against its plain version at the si512 call's own segments
    (:func:`envelope_k2_phase`).  Returns (rows, launches, K2 checks)."""
    from alignn_tpu_torch.ff.calculator import Calculator

    cells = {"Si": si_cells(), "Cu": [("cu108_rattled", rattled_fcc(3))]}
    bases = {el: Calculator(path=d) for el, d in ENVELOPE_DIRS.items()}
    rows = {}
    reset_launches()
    for el, base in bases.items():
        rows[el] = run_cells(
            lambda b=base: Calculator(model=b.model, config=b.config),
            cells[el], "envelope", failures)
    launches = read_launches()
    for el, d in ENVELOPE_DIRS.items():
        cpu = Calculator(path=d, device="cpu")
        check_against(rows[el], lambda c=cpu: c, "cpu_port", failures)
        for row, atoms, _res in rows[el]:
            # the radius graph's stage above reuses the skin candidate set;
            # a fresh Calculator's first call builds it (cutoff + skin)
            t = time.perf_counter()
            Calculator(model=bases[el].model,
                       config=bases[el].config).graph_for(atoms)
            row["graph_first_call_ms"] = (time.perf_counter() - t) * 1e3
    si512 = dict(cells["Si"])["si512_rattled"]
    calc = Calculator(model=bases["Si"].model, config=bases["Si"].config)
    k2 = envelope_k2_phase(calc.batch_for(calc.graph_for(si512)), failures)
    return rows["Si"] + rows["Cu"], launches, k2


def envelope_k2_phase(batch, failures: list) -> dict:
    """K2 against its plain version on the segments an envelope model's
    batch (`batch`, one Si_envelope si512 call) gives it: the dst
    segments of the node stage and of the line-graph stage, where the soft
    sums run K2 at F 512 (the packed [sigma w bh | sigma w] of the 256
    hidden features), and their src_sorted segments, where the gather
    transposes run K2 at F 256 and, for the pair weights, F 1.  Dyadic
    inputs as in `kernel_phase`, so every sum is exact; f32 and bf16, each
    with its time and bound."""
    import torch

    from alignn_tpu_torch.ops import eggc as ek

    gen = torch.Generator(device=batch.r.device).manual_seed(2)
    sites = {"g_dst": batch.g_index.dst,
             "g_src_sorted": batch.g_index.src_sorted,
             "lg_dst": batch.lg_index.dst,
             "lg_src_sorted": batch.lg_index.src_sorted}
    results = {}
    for site, seg in sites.items():
        rows, n = seg.ids.shape[0], seg.num
        for f in (512, 256, 1):
            x32 = torch.randint(-64, 65, (rows, f), device=seg.ids.device,
                                generator=gen).float() / 16
            out = {"rows": rows, "segments": n, "features": f}
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype).split(".")[1]
                x = x32.to(dtype)
                got = ek.sorted_segment_sum_cuda(x, seg)
                ref = ek.sorted_segment_sum_plain(x, seg)
                torch.cuda.synchronize()
                es = x.element_size()
                b_ms, b_by = bound(rows * f * es + 4 * (n + 1) + n * f * es,
                                   1.0 * rows * f)
                ms = cuda_ms(lambda: ek.sorted_segment_sum_cuda(x, seg))
                out[name] = {
                    **compare(got, ref, name, failures,
                              f"K2 sorted_segment_sum envelope {site} F {f}"),
                    "ms": ms,
                    "plain_ms": cuda_ms(
                        lambda: ek.sorted_segment_sum_plain(x, seg)),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "bound_share": b_ms / ms}
            results[f"{site}_F{f}"] = out
    return results


def envelope_train_phase(failures: list):
    """The E/F/S train step of an envelope-weighted model (bench.py's
    4+4/256 and loss weights, envelope at 4.5 A, random weights from seed
    0, f32) on bench.py's rocksalt cells built with the envelope
    potentials' graph (radius 4.5 A, no canonisation), the first
    ENVELOPE_TRAIN_CELLS of the 64: 2 warm-up and 10 timed steps, and the
    first of them against the same step of the port on the CPU at the
    training limits.  Returns (row, launches per step)."""
    import torch

    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.graph.build import rocksalt_graphs
    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig,
                                            init_parameters)

    cfg = ENVELOPE_TRAIN_CFG
    graphs = rocksalt_graphs(64, seed=0, neighbor_strategy="radius_graph",
                             cutoff=4.5, use_canonize=False)
    all_l = sum(g.num_lg_edges for g in graphs)
    graphs = graphs[:ENVELOPE_TRAIN_CELLS]
    weights = init_parameters(ALIGNNAtomWise(ALIGNNAtomWiseConfig(**cfg)),
                              torch.Generator().manual_seed(0)).state_dict()

    def batch_on(gs, device):
        return batch_graphs(gs, BucketSpec.tight_for_batch(gs), device)

    batch = batch_on(graphs, torch.device("cuda"))
    row, first, launches = train_run(weights, batch, "envelope", failures,
                                     cfg=cfg)
    del batch
    torch.cuda.empty_cache()
    # the timed batch's first step against the same step on the CPU
    t = time.perf_counter()
    cpu_first = first_step(weights, batch_on(graphs, torch.device("cpu")),
                           cfg)
    cpu_s = time.perf_counter() - t
    check = step_diff(first, cpu_first,
                      f"envelope {len(graphs)} cells card vs CPU", failures)
    return {"cell": "envelope_rocksalt_b16", "config": cfg,
            "graph": "radius_graph 4.5 A, use_canonize false",
            "cells": len(graphs), "lg_edges_of_64_cells": all_l,
            "optimizer": "adamw lr 1e-3 wd 1e-5, no decay mask",
            "precision": "f32 (TF32 off)", "tolerances": TRAIN_TOL,
            "first_step_vs_cpu_port": {**check, "cpu_step_s": cpu_s},
            "envelope": row}, launches


# ---------------------------------------------------------------------------
# the neighbour list, the FF tasks and the on-device loops
# ---------------------------------------------------------------------------

GRAPH_FIELDS = ("z", "frac_coords", "lattice", "src", "dst", "r", "images",
                "lg_src", "lg_dst")


@contextlib.contextmanager
def numpy_search():
    """``build_graph``'s numpy neighbour search inside (the C++ list
    switched off), restored after whatever happens."""
    from alignn_tpu_torch import native

    real = native.periodic_pairs_native
    native.periodic_pairs_native = lambda *a, **k: None
    try:
        yield
    finally:
        native.periodic_pairs_native = real


def median_ms(fn, reps: int = 3):
    """(median host ms of `reps` calls of fn, fn's last result)."""
    times, out = [], None
    for _ in range(reps):
        t = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times)), out


def graphs_agree(a, b, exact_r: bool) -> dict:
    """Byte equality of two GraphData, field by field; a radius graph's
    bond vectors are its search's own displacements, compared to 1e-12."""
    same = {f: np.asarray(getattr(a, f)).tobytes()
            == np.asarray(getattr(b, f)).tobytes() for f in GRAPH_FIELDS}
    if not exact_r:
        same["r"] = a.r.shape == b.r.shape and bool(
            np.abs(a.r - b.r).max() <= 1e-12)
    return same


def native_graph_phase(models: dict, failures: list) -> list:
    """The host graph build with the C++ neighbour list against numpy:
    k-NN (``docs/mlearn_r4/Si``'s settings with the Calculator's tie_tol)
    on the three Si cells and radius 4.5 A (``Si_envelope``'s) on those and
    ``cu108_rattled``.  Per cell: the graph's and the pair search's host
    ms, native and numpy (median of 3); on the rattled cells every array
    byte-equal between the two (the radius graph's r within 1e-12 A); and
    a fresh Calculator's first ``graph_for`` (``graph_first_call_ms``).
    `models` maps "knn", "radius" (Si) and "cu" to (model, config)."""
    from alignn_tpu_torch import native
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.ff.calculator import Calculator
    from alignn_tpu_torch.graph import build as gb

    if native.neighbors_lib() is None:
        failures.append("native_graph: the C++ neighbour list did not "
                        "build or load (g++ missing?)")
        return []
    cells = {"knn": si_cells(),
             "radius": si_cells() + [("cu108_rattled", rattled_fcc(3))]}
    rows = []
    for strategy in ("knn", "radius"):
        for name, atoms in cells[strategy]:
            model_c, config_c = models["cu" if name.startswith("cu")
                                       else strategy]
            calc = Calculator(model=model_c, config=config_c)

            def build():
                return calc._build(atoms, calc.cutoff)

            # the pair search on the wrapped cell, as build_graph runs it
            wrapped = Atoms(lattice_mat=atoms.lattice_mat,
                            frac_coords=gb.wrap_frac(atoms.frac_coords),
                            elements=atoms.elements)

            def pairs():
                return gb._tiled_pairs(wrapped, calc.cutoff)

            graph_ms, g_native = median_ms(build)
            pairs_ms, _ = median_ms(pairs)
            with numpy_search():
                numpy_graph_ms, g_numpy = median_ms(build)
                numpy_pairs_ms, _ = median_ms(pairs)
            t = time.perf_counter()
            Calculator(model=model_c, config=config_c).graph_for(atoms)
            first_ms = (time.perf_counter() - t) * 1e3
            row = {"cell": name, "strategy": strategy,
                   "cutoff": calc.cutoff, "edges": g_native.num_edges,
                   "lg_edges": g_native.num_lg_edges,
                   "graph_ms": {"native": graph_ms, "numpy": numpy_graph_ms},
                   "pairs_ms": {"native": pairs_ms, "numpy": numpy_pairs_ms},
                   "graph_first_call_ms": first_ms}
            if name != "diamond8":
                same = graphs_agree(g_native, g_numpy,
                                    exact_r=strategy == "knn")
                row["native_equals_numpy"] = all(same.values())
                if not row["native_equals_numpy"]:
                    bad = [f for f, ok in same.items() if not ok]
                    failures.append(f"native_graph {name} {strategy}: the "
                                    f"C++ and numpy graphs differ in {bad}")
            rows.append(row)
    return rows


class CountingCalculator:
    """A Calculator's E/F/S with its calls counted, for the FF tasks."""

    def __init__(self, calc):
        self.calc, self.calls = calc, 0

    def calculate(self, atoms):
        self.calls += 1
        return self.calc.calculate(atoms)

    def get_potential_energy(self, atoms):
        return self.calculate(atoms)["energy"]

    def get_forces(self, atoms):
        return self.calculate(atoms)["forces"]


def primitive_si(a0: float):
    from alignn_tpu_torch.chem.atoms import Atoms

    lat = np.array([[0, a0 / 2, a0 / 2], [a0 / 2, 0, a0 / 2],
                    [a0 / 2, a0 / 2, 0]])
    return Atoms(lattice_mat=lat,
                 frac_coords=np.array([[0.0, 0, 0], [0.25, 0.25, 0.25]]),
                 elements=["Si", "Si"])


def ff_science_phase(env_calc, knn_calc, failures: list) -> dict:
    """The science pins of ``tests/test_envelope_potential.py`` (a0, B,
    Gamma phonons, vacancy) through ``Si_envelope`` and of
    ``tests/test_trained_potential.py`` through ``docs/mlearn_r4/Si``, at
    full width on the card, with their bounds; each task's wall seconds
    and Calculator calls.  A missed pin is a failure."""
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.ff.phonons import (force_constants,
                                             phonon_frequencies)
    from alignn_tpu_torch.ff.relax import fire_relax
    from alignn_tpu_torch.ff.tasks import ev_curve

    out = {}

    def task(label, counter, fn, pins):
        t = time.perf_counter()
        c0 = counter.calls
        values = fn()
        row = {"seconds": time.perf_counter() - t,
               "calculator_calls": counter.calls - c0, **values}
        missed = [p for p, ok in pins(values).items() if not ok]
        row["pins_missed"] = missed
        if missed:
            failures.append(f"ff_science {label}: missed {missed} ({values})")
        out[label] = row

    def a0_of(atoms):
        return float(np.cbrt(abs(np.linalg.det(atoms.lattice_mat))))

    for key, base in (("Si_envelope", env_calc), ("mlearn_r4_Si", knn_calc)):
        counter = CountingCalculator(base)
        state = {}

        def relax_task():
            rel, e, steps = fire_relax(counter, diamond(), fmax=0.01,
                                       steps=200, optimize_lattice=True)
            state["rel"] = rel
            return {"a0": a0_of(rel), "energy_per_atom": e / 8,
                    "steps": steps}

        def ev_task():
            dx = np.arange(-0.02, 0.0201, 0.005) if key == "Si_envelope" \
                else np.arange(-0.015, 0.0151, 0.005)
            ev = ev_curve(counter, state["rel"], relax_first=False, dx=dx)
            return {"B_GPa": ev["eos"]["B_GPa"], "Bp": ev["eos"]["Bp"],
                    "residual": ev["eos"]["residual"],
                    "B_GPa_birch_murnaghan":
                        ev["eos_birch_murnaghan"]["B_GPa"]}

        def phonon_task():
            fc = force_constants(counter, primitive_si(a0_of(state["rel"])),
                                 supercell=(2, 2, 2), delta=0.02)
            f = phonon_frequencies(fc, np.zeros(3))
            return {"acoustic_max_THz": float(np.abs(f[:3]).max()),
                    "optical_THz": [float(x) for x in f[3:]]}

        if key == "Si_envelope":
            task(f"{key}/relax", counter, relax_task, lambda v: {
                "a0 5.480+-0.01": abs(v["a0"] - 5.480) <= 0.01,
                "a0 within 1% of 5.469": abs(v["a0"] - 5.469) / 5.469 < 0.01,
                "converged": v["steps"] < 200})
            task(f"{key}/ev_curve", counter, ev_task, lambda v: {
                "residual<5e-3": v["residual"] < 5e-3,
                "B 88.6+-8": abs(v["B_GPa"] - 88.6) <= 8.0,
                "2<Bp<6": 2.0 < v["Bp"] < 6.0,
                "BM B within 5": abs(v["B_GPa_birch_murnaghan"]
                                     - v["B_GPa"]) <= 5.0})
            task(f"{key}/gamma_phonons", counter, phonon_task, lambda v: {
                "acoustic<0.2": v["acoustic_max_THz"] < 0.2,
                "optical ptp<0.3": np.ptp(v["optical_THz"]) < 0.3,
                "optical 14.9+-1.5":
                    abs(np.mean(v["optical_THz"]) - 14.9) <= 1.5})

            def vacancy_task():
                sc = state["rel"].make_supercell((2, 2, 2))
                e_bulk = counter.get_potential_energy(sc)
                vac = Atoms(lattice_mat=sc.lattice_mat,
                            frac_coords=np.delete(sc.frac_coords, 0, axis=0),
                            elements=["Si"] * (sc.num_atoms - 1))
                ef = counter.get_potential_energy(vac) - e_bulk \
                    + e_bulk / sc.num_atoms
                return {"E_formation_eV": ef}

            task(f"{key}/vacancy", counter, vacancy_task, lambda v: {
                "1.5<Ef<4.5": 1.5 < v["E_formation_eV"] < 4.5})
        else:
            task(f"{key}/relax", counter, relax_task, lambda v: {
                "a0 5.510+-0.01": abs(v["a0"] - 5.510) <= 0.01,
                "a0 within 2% of 5.469": abs(v["a0"] - 5.469) / 5.469 < 0.02,
                "E/atom -5.414+-0.02":
                    abs(v["energy_per_atom"] + 5.414) <= 0.02,
                "converged": v["steps"] < 200})
            task(f"{key}/ev_curve", counter, ev_task, lambda v: {
                "residual<2e-3": v["residual"] < 2e-3,
                "45<B<110": 45 < v["B_GPa"] < 110})
            task(f"{key}/gamma_phonons", counter, phonon_task, lambda v: {
                "acoustic<0.5": v["acoustic_max_THz"] < 0.5,
                "12<optical<17": 12.0 < min(v["optical_THz"])
                and max(v["optical_THz"]) < 17.0,
                "optical ptp<0.5": np.ptp(v["optical_THz"]) < 0.5})

            def energy_task():
                return {"energy_per_atom":
                        counter.get_potential_energy(diamond()) / 8}

            task(f"{key}/diamond_energy", counter, energy_task, lambda v: {
                "-5.3774+-2e-3": abs(v["energy_per_atom"] + 5.3774) <= 2e-3})
    return out


MD_STEPS, MD_CHUNK, PROFILED_STEPS = 50, 25, 5
MD_TOL = {"captured_vs_eager_A": 1e-5, "captured_vs_eager_eV_per_atom": 1e-5,
          "host_rtol": 1e-4, "host_atol_A": 1e-5, "host_etot_rel": 1e-3}


def wrapped_cart(atoms):
    return (np.asarray(atoms.frac_coords) % 1.0) @ atoms.lattice_mat


def frac_gap_A(fa, fb, lattice) -> float:
    """Largest distance in A between two sets of fractional positions,
    each pair taken through the nearest periodic image."""
    d = np.asarray(fa, dtype=np.float64) - np.asarray(fb, dtype=np.float64)
    return float(np.abs((d - np.round(d)) @ lattice).max())


def md_batch(atoms, layout: str, graph_kw: dict, device):
    """(graph, one chunk's batch as ``run_md_jit`` builds it: its bucket
    rule, the padded segments)."""
    from alignn_tpu_torch.ff.md_jit import BUCKET_SLACK, sparse_spec
    from alignn_tpu_torch.ff.step_loop import with_item_capacity
    from alignn_tpu_torch.graph import dense as gdense
    from alignn_tpu_torch.graph.batch import batch_graphs
    from alignn_tpu_torch.graph.build import build_graph

    g = build_graph(atoms, **graph_kw)
    if layout == "dense":
        batch = gdense.dense_batch_graphs(
            [g], gdense.dense_spec_with_slack(g, bucket_slack=BUCKET_SLACK),
            device)
    else:
        batch = batch_graphs([g], sparse_spec(g), device,
                             gather_windows=False)
    return g, with_item_capacity(batch)


def md_kernel_holds(batch, layout: str, hidden: int, failures: list) -> dict:
    """Each kernel of `layout`'s MD step against its plain version on the
    chunk's own batch (its segments padded to the bucket's item capacity,
    its dense bucket), f32, 1e-5 x max|plain|: sparse K1 forward and
    backward (through K2) on the node and line-graph ``dst`` segments and
    K2 on those and the ``src_sorted`` ones at the hidden width; envelope
    K2 on the same four at F 512, hidden and 1; dense K3, K4 and K5a at
    the bucket's D with its slot masks.  K2's inputs are dyadic, so its
    sums are exact."""
    import torch

    from alignn_tpu_torch.ops import dense as dk
    from alignn_tpu_torch.ops import eggc as ek

    dev = batch.r.device
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def check(got, ref, what):
        return compare(got, ref, "float32", failures, f"md {layout} {what}")

    if layout == "dense":
        D, n = batch.dense_D, batch.z.shape[0]
        m = dk.fold_mask(randn(n * D, hidden), batch.edge_mask)
        m2 = dk.fold_mask(randn(n * D * D, hidden), batch.lg_mask)
        bh, g = randn(n * D, hidden), randn(n * D, hidden)
        out["K3"] = check(dk.dense_gated_aggregate_cuda(m, bh, D),
                          dk.dense_gated_aggregate_plain(m, bh, D), "K3")
        out["K4"] = check(dk.dense_pair_aggregate_cuda(m2, bh, D),
                          dk.dense_pair_aggregate_plain(m2, bh, D), "K4")
        got = dk.pair_aggregate_bwd_cuda(m2, bh, g, D)
        ref = dk.pair_aggregate_bwd_plain(m2, bh, g, D)
        out["K5a"] = {part: check(got[i], ref[i], f"K5a {part}")
                      for i, part in enumerate(("dm2", "dbh"))}
        return {"D": D, "nodes": n, **out}
    sites = {"g_dst": batch.g_index.dst,
             "g_src_sorted": batch.g_index.src_sorted,
             "lg_dst": batch.lg_index.dst,
             "lg_src_sorted": batch.lg_index.src_sorted}
    widths = (512, hidden, 1) if layout == "envelope" else (hidden,)
    for site, seg in sites.items():
        rows = seg.ids.shape[0]
        for f in widths:
            x = torch.randint(-64, 65, (rows, f), device=dev,
                              generator=gen).float() / 16
            out[f"K2_{site}_F{f}"] = check(
                ek.sorted_segment_sum_cuda(x, seg),
                ek.sorted_segment_sum_plain(x, seg), f"K2 {site} F {f}")
        if layout == "sparse" and site.endswith("dst"):
            m, bh = randn(rows, hidden), randn(rows, hidden)
            out[f"K1_{site}"] = check(ek.gated_aggregate_cuda(m, bh, seg),
                                      ek.gated_aggregate_plain(m, bh, seg),
                                      f"K1 {site}")
            gout = randn(seg.num, hidden)
            grads = []
            for fn in (ek.gated_aggregate, ek.gated_aggregate_plain):
                mt, bt = m.clone().requires_grad_(True), \
                    bh.clone().requires_grad_(True)
                grads.append(torch.autograd.grad(fn(mt, bt, seg), (mt, bt),
                                                 gout))
            out[f"K1_{site}_backward"] = {
                part: check(grads[0][i], grads[1][i],
                            f"K1 {site} backward {part}")
                for i, part in enumerate(("dm", "dbh"))}
    return {"items": {k: seg.num_items for k, seg in sites.items()}, **out}


def count_capture(loop) -> dict:
    """Instruments `loop` (a ``StepLoop``): the returned dict receives the
    kernel wrappers' launch counts over its captured step, which is what
    every replay launches, and the capture's wall time in ms."""
    import torch

    seen = {}
    step, capture = loop.step, loop._capture

    def counted_step():
        if not torch.cuda.is_current_stream_capturing():
            return step()
        k0 = read_launches()
        step()
        k1 = read_launches()
        seen["launches"] = {k: k1[k] - k0[k] for k in k1}

    def timed_capture():
        torch.cuda.synchronize()
        t = time.perf_counter()
        capture()
        torch.cuda.synchronize()
        seen["capture_ms"] = (time.perf_counter() - t) * 1e3

    loop.step, loop._capture = counted_step, timed_capture
    return seen


def md_chunk_phase(model, atoms, layout: str, graph_kw: dict,
                   failures: list) -> dict:
    """One MD chunk of `layout` (sparse k-NN, dense k-NN or envelope) on
    the card, built as ``run_md_jit`` builds it.  Its kernels against
    their plain versions on its own batch (:func:`md_kernel_holds`); the
    dense layout's energy and forces against the sparse layout of the same
    graph.  Then 25 NVE steps from one start, eager and captured (twice:
    the capture's chunk, then one of replays alone), the captured
    positions within 1e-5 A and energies within 1e-5 eV/atom of the
    eager ones.  Measured: the chunks' wall times; the replayed step (ms,
    device busy share and device operations of replays under
    ``torch.profiler``); the eager step (ms, host syncs under
    ``torch.cuda.set_sync_debug_mode("warn")``); kernel launches a step,
    counted over the captured step (what a replay launches) and over
    eager steps; the capture's time, and the run length from which
    capturing pays back (the warm-up steps plus the capture's time over
    what a replay saves on an eager step)."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    from alignn_tpu_torch.chem.atoms import atomic_masses
    from alignn_tpu_torch.ff.md import FS, maxwell_boltzmann_velocities
    from alignn_tpu_torch.ff.md_jit import MDChunk, energy_and_forces, \
        sparse_spec
    from alignn_tpu_torch.ff.step_loop import WARMUP_STEPS, StepLoop
    from alignn_tpu_torch.graph.batch import batch_graphs

    dev = torch.device("cuda")
    g, batch = md_batch(atoms, layout, graph_kw, dev)
    n_at, n_pad = atoms.num_atoms, batch.z.shape[0]
    masses = np.zeros(n_pad)
    masses[:n_at] = atomic_masses()[atoms.atomic_numbers]
    vel = np.zeros((n_pad, 3))
    vel[:n_at] = maxwell_boltzmann_velocities(atoms, 300.0, 0)
    row = {"layout": layout, "atoms": n_at,
           "bucket": [n_pad, batch.src.shape[0], batch.lg_src.shape[0]],
           "dense_D": batch.dense_D,
           "kernels_vs_plain": md_kernel_holds(
               batch, layout, model.cfg.hidden_features, failures)}
    if layout == "dense":
        sp = batch_graphs([g], sparse_spec(g), dev, gather_windows=False)
        e_d, f_d, _ = energy_and_forces(model, batch, batch.frac_coords)
        e_s, f_s, _ = energy_and_forces(model, sp, sp.frac_coords)
        de = abs(float(e_d) - float(e_s)) / n_at
        df = float((f_d[:n_at] - f_s[:n_at]).abs().max())
        row["dense_vs_sparse"] = {"energy_eV_per_atom": de,
                                  "forces_eV_per_A": df}
        if not (de <= CPU_TOL["energy_per_atom"] and df <= CPU_TOL["forces"]):
            failures.append(f"md chunk dense: against the sparse layout "
                            f"{de} eV/atom, {df} eV/A")
        del sp

    def chunk(cuda_graph):
        return MDChunk(model, batch, FS, "nve", 300.0, 0.02, MD_CHUNK,
                       torch.Generator(device=dev).manual_seed(0),
                       cuda_graph=cuda_graph)

    def timed_chunk(c):     # the chunk's one fetch synchronises
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = c.run(batch, masses, vel, MD_CHUNK)
        return (time.perf_counter() - t) * 1e3, res

    lat = batch.lattice[0].cpu().numpy().astype(np.float64)
    eager = chunk(False)
    row["eager_chunk_ms"], ref = timed_chunk(eager)
    k0 = read_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    eager.loop.run(5)
    torch.cuda.synchronize()
    row["eager_ms_per_step"] = (time.perf_counter() - t) * 1e3 / 5
    k1 = read_launches()
    row["launches_per_eager_step"] = {k: (k1[k] - k0[k]) / 5 for k in k1}
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            eager.loop.run(3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    row["host_syncs_per_eager_step"] = sum(
        "synchroniz" in str(w.message) for w in caught) / 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eager.loop.run(2)
        torch.cuda.synchronize()
    row["device_ops_per_eager_step"] = device_ms_by_name(prof)[1] / 2
    del eager

    c0 = StepLoop.captures
    captured = chunk(True)
    seen = count_capture(captured.loop)
    row["captured_first_chunk_ms"], first = timed_chunk(captured)
    row["captured_chunk_ms"], again = timed_chunk(captured)   # replays
    row["captures"] = StepLoop.captures - c0
    gaps = {}
    for name, res in (("first", first), ("replays", again)):
        dx = frac_gap_A(res[0][:n_at], ref[0][:n_at], lat)
        de = max(float(np.abs(res[i] - ref[i]).max()) for i in (2, 3)) / n_at
        gaps[name] = {"max_A": dx, "energy_eV_per_atom": de}
        if not (dx <= MD_TOL["captured_vs_eager_A"]
                and de <= MD_TOL["captured_vs_eager_eV_per_atom"]):
            failures.append(f"md chunk {layout}: captured ({name}) vs "
                            f"eager {dx} A, {de} eV/atom")
    row["captured_vs_eager"] = gaps
    torch.cuda.synchronize()
    t = time.perf_counter()
    captured.loop.run(MD_CHUNK)
    torch.cuda.synchronize()
    row["captured_ms_per_step"] = (time.perf_counter() - t) * 1e3 / MD_CHUNK
    for _ in range(2):   # the second profiled run, as `breakdown` does
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            captured.loop.run(PROFILED_STEPS)
            torch.cuda.synchronize()
    by_name, n_ops = device_ms_by_name(prof)
    busy = sum(by_name.values()) / PROFILED_STEPS
    row["device_busy_ms_per_step"] = busy
    # the profiled replays' device time over the unprofiled replays' wall
    row["device_busy_share"] = busy / row["captured_ms_per_step"]
    row["device_ops_per_step"] = n_ops / PROFILED_STEPS
    row["top_kernels_ms"] = top_kernels(by_name)
    row["capture_ms"] = seen.get("capture_ms")
    saving = row["eager_ms_per_step"] - row["captured_ms_per_step"]
    row["break_even_steps"] = (WARMUP_STEPS + seen["capture_ms"] / saving
                               if saving > 0 and "capture_ms" in seen
                               else None)
    need = {"sparse": ("K1", "K2"), "dense": ("K3", "K4", "K5a"),
            "envelope": ("K2",)}[layout]
    banned = {"sparse": ("K3", "K4", "K5a", "K6", "K7", "K8"),
              "dense": ("K1", "K6", "K7", "K8"),
              "envelope": NOT_K2}[layout]
    per = row["launches_per_step"] = seen.get("launches")
    if per is None or any(per[k] <= 0 for k in need) or \
            any(per[k] for k in banned):
        failures.append(f"md chunk {layout}: launches per captured step "
                        f"{per} (need {need}, none of {banned})")
    if row["captures"] != 1:
        failures.append(f"md chunk {layout}: {row['captures']} captures")
    return row


def md_device_phase(env_calc, knn_calc, failures: list) -> dict:
    """``run_md_jit`` with ``Si_envelope`` on si512_rattled and on
    si64_rattled, NVE, 1 fs, 300 K, 2 chunks of 25 steps, captured and
    eager (each twice, in the order captured, eager, eager, captured), and
    at si512 as the host loop ``run_md`` through the Calculator: ms per
    step of each, captures, total-energy drift; captured against eager
    within 1e-5 A and 1e-5 eV/atom; with
    ``chunk_steps=1`` (captured) against the host loop after 10 steps with
    the tolerances of ``tests/test_md_jit.py``.  Then one chunk per
    layout (:func:`md_chunk_phase`: envelope at si512 and si64, sparse
    and dense k-NN), a
    dense ``run_md_jit`` chunk of ``docs/mlearn_r4/Si`` (``dense=True``)
    and an ``nvt_langevin`` run, whose mean temperature over its last
    half is reported."""
    import torch

    from alignn_tpu_torch.ff.calculator import Calculator
    from alignn_tpu_torch.ff.md import run_md
    from alignn_tpu_torch.ff.md_jit import run_md_jit
    from alignn_tpu_torch.ff.step_loop import StepLoop

    env_model, knn_model = env_calc.model, knn_calc.model
    si512 = rattled_supercell(4)
    env_kw = dict(cutoff=4.5, neighbor_strategy="radius_graph")
    kw = dict(steps=MD_STEPS, chunk_steps=MD_CHUNK, timestep_fs=1.0,
              initial_temperature_K=300.0, seed=0, **env_kw)
    out = {"atoms": si512.num_atoms, "steps": MD_STEPS, "chunk": MD_CHUNK}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / MD_STEPS, res

    # whole runs, in the order captured, eager, eager, captured, at si512
    # (device-bound) and si64 (host-bound); each captured run against the
    # eager one, positions 1e-5 A, energies 1e-5 eV/atom
    whole = {}
    for size, atoms in (("si512", si512), ("si64", rattled_supercell(2))):
        times = {"captured": [], "eager": []}
        runs = {}
        for mode in ("captured", "eager", "eager", "captured"):
            c0 = StepLoop.captures
            ms, runs[mode] = timed(lambda: run_md_jit(
                env_model, atoms, cuda_graph=mode == "captured", **kw))
            times[mode].append(ms)
            if mode == "captured" and StepLoop.captures - c0 != 1:
                failures.append(f"md_device {size}: "
                                f"{StepLoop.captures - c0} captures a run")
        (a_c, log_c), (a_e, log_e) = runs["captured"], runs["eager"]
        if size == "si512":
            log_graph = log_c
        dx = frac_gap_A(a_c.frac_coords, a_e.frac_coords, a_e.lattice_mat)
        de = max(abs(x[k] - y[k]) for x, y in zip(log_c.rows, log_e.rows)
                 for k in ("epot", "ekin")) / atoms.num_atoms
        whole[size] = {"atoms": atoms.num_atoms, "ms_per_step": times,
                       "captured_vs_eager": {"max_A": dx,
                                             "energy_eV_per_atom": de}}
        if not (dx <= MD_TOL["captured_vs_eager_A"]
                and de <= MD_TOL["captured_vs_eager_eV_per_atom"]):
            failures.append(f"md_device {size}: captured vs eager {dx} A, "
                            f"{de} eV/atom")
    out["whole_runs"] = whole
    out["captured_ms_per_step"] = float(np.mean(
        whole["si512"]["ms_per_step"]["captured"]))
    out["eager_ms_per_step"] = float(np.mean(
        whole["si512"]["ms_per_step"]["eager"]))
    calc = Calculator(model=env_model, config=env_calc.config)
    host = {}

    def keep(step, state, _epot, _forces):
        if step == 9:
            host["atoms10"] = state.atoms

    out["host_loop_ms_per_step"], (h_state, h_log) = timed(
        lambda: run_md(calc, si512, ensemble="nve", steps=MD_STEPS,
                       timestep_fs=1.0, initial_temperature_K=300.0, seed=0,
                       log_interval=1, callback=keep))
    etot = np.array([r["etot"] for r in log_graph.rows])
    out["etot_drift_eV_per_atom"] = float((etot[-1] - etot[0]) / 512)
    out["etot_max_dev_eV_per_atom"] = float(np.abs(etot - etot[0]).max()
                                            / 512)
    out["host_etot_drift_eV_per_atom"] = float(
        (h_log.rows[-1]["etot"] - h_log.rows[0]["etot"]) / 512)
    c0 = StepLoop.captures
    a1, log1 = run_md_jit(env_model, si512, **{**kw, "steps": 10,
                                               "chunk_steps": 1})
    out["chunk1_captures"] = StepLoop.captures - c0
    ref = wrapped_cart(host["atoms10"])
    diff = np.abs(wrapped_cart(a1) - ref)
    out["chunk1_vs_host_max_A"] = float(diff.max())
    etot_rel = abs(log1.rows[-1]["etot"] - h_log.rows[9]["etot"]) / abs(
        h_log.rows[9]["etot"])
    out["chunk1_vs_host_etot_rel"] = etot_rel
    if not (np.all(diff <= MD_TOL["host_atol_A"]
                   + MD_TOL["host_rtol"] * np.abs(ref))
            and etot_rel <= MD_TOL["host_etot_rel"]):
        failures.append(f"md_device: chunk_steps=1 vs host loop "
                        f"{diff.max()} A, etot rel {etot_rel}")
    out["tolerances"] = MD_TOL
    for name, r in (("captured", log_graph), ("host", h_log)):
        if not all(np.isfinite(x["etot"]) for x in r.rows):
            failures.append(f"md_device {name}: non-finite energies")

    knn_kw = dict(cutoff=8.0, neighbor_strategy="k-nearest")
    out["chunks"] = {
        "envelope": md_chunk_phase(env_model, si512, "envelope", env_kw,
                                   failures),
        # a host-bound size: a serving call of si64 keeps the card busy
        # for 42 % of it
        "envelope_si64": md_chunk_phase(env_model, rattled_supercell(2),
                                        "envelope", env_kw, failures),
        "sparse": md_chunk_phase(knn_model, si512, "sparse", knn_kw,
                                 failures),
        "dense": md_chunk_phase(knn_model, si512, "dense", knn_kw,
                                failures)}
    k0 = read_launches()
    ms, (a_dense, log_dense) = timed(lambda: run_md_jit(
        knn_model, si512, dense=True, **{**kw, **knn_kw,
                                         "steps": MD_CHUNK}))
    k1 = read_launches()
    dense_ok = k1["K4"] > k0["K4"] and k1["K1"] == k0["K1"]
    out["dense_run"] = {"ms_per_step": ms * MD_STEPS / MD_CHUNK,
                        "ran_dense": dense_ok,
                        "etot_drift_eV_per_atom": (
                            log_dense.rows[-1]["etot"]
                            - log_dense.rows[0]["etot"]) / 512}
    if not dense_ok or not np.isfinite(a_dense.cart_coords).all():
        failures.append("md_device: the dense run_md_jit chunk did not run "
                        "the dense layout, or went non-finite")
    ms, (a_lv, log_lv) = timed(lambda: run_md_jit(
        env_model, si512, ensemble="nvt_langevin", temperature_K=300.0,
        **{k: v for k, v in kw.items() if k != "initial_temperature_K"}))
    temps = [r["T"] for r in log_lv.rows]
    out["langevin"] = {"ms_per_step": ms,
                       "mean_T_last_half": float(np.mean(
                           temps[len(temps) // 2:])),
                       "T_first": temps[0], "T_last": temps[-1]}
    if not np.isfinite(temps).all() or \
            not np.isfinite(a_lv.cart_coords).all():
        failures.append("md_device: the Langevin run went non-finite")
    return out


def relax_device_phase(env_calc, failures: list) -> dict:
    """``batch_relax`` of 8 rattled si64 cells (rattle 0.05 A, seeds 0-7)
    with ``Si_envelope``'s graph (radius 4.5 A), 2 chunks of 25 FIRE
    steps, captured and eager: ms per step, final fmax per cell, and the
    captured result against the eager one (positions 1e-4 A, energies
    1e-4 eV)."""
    import torch

    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.ff.relax_jit import batch_relax
    from alignn_tpu_torch.ff.step_loop import StepLoop

    cells = []
    for seed in range(8):
        sc = diamond().make_supercell([2, 2, 2])
        cart = sc.cart_coords + np.random.default_rng(seed).normal(
            0.0, 0.05, sc.cart_coords.shape)
        cells.append(Atoms(lattice_mat=sc.lattice_mat,
                           frac_coords=cart @ np.linalg.inv(sc.lattice_mat),
                           elements=sc.elements))
    kw = dict(fmax=1e-4, max_steps=50, chunk_steps=25, cutoff=4.5)
    out = {"cells": len(cells), "atoms": 64 * len(cells),
           "steps": kw["max_steps"]}
    results = {}
    for mode, cg in (("captured", True), ("eager", False)):
        c0 = StepLoop.captures
        torch.cuda.synchronize()
        t = time.perf_counter()
        results[mode] = batch_relax(env_calc.model, cells, cuda_graph=cg,
                                    **kw)
        torch.cuda.synchronize()
        out[f"{mode}_ms_per_step"] = (time.perf_counter() - t) * 1e3 \
            / kw["max_steps"]
        out[f"{mode}_captures"] = StepLoop.captures - c0
        out[f"{mode}_fmax"] = [float(x) for x in results[mode][2]]
    (ag, eg, fg), (ae, ee, _fe) = results["captured"], results["eager"]
    dpos = max(frac_gap_A(x.frac_coords, y.frac_coords, y.lattice_mat)
               for x, y in zip(ag, ae))
    de = float(np.abs(eg - ee).max())
    out["captured_vs_eager"] = {"max_A": dpos, "energy_eV": de}
    out["fmax_start"] = [float(np.linalg.norm(
        env_calc.calculate(c)["forces"], axis=1).max()) for c in cells]
    if not (dpos <= 1e-4 and de <= 1e-4) or not np.isfinite(fg).all():
        failures.append(f"relax_device: captured vs eager {dpos} A, "
                        f"{de} eV")
    return out


TRAIN_CLI_DIR = os.path.join(REPO, "build", "train_cli")
TRAIN_CLI_CELLS = 640
PROPERTY_RUN = {  # TrainingConfig of train_cli (a): ALIGNNConfig defaults
    "batch_size": 64, "n_train": 512, "n_val": 64, "n_test": 64,
    "epochs": 3, "learning_rate": 1e-3, "use_cache": True,
    "num_workers": 2, "model": {"name": "alignn"}}
ARTIFACTS = ("config.json", "history_train.json", "history_val.json",
             "ids_train_val_test.json", "Test_results.json",
             "best_model.mpk", "current_model.mpk", "last_model.mpk",
             "restart.mpk", "prediction_results_test_set.csv")
# kernels each training run must launch, and must not (over the whole run)
CLI_KERNELS = {"sparse": (("K1", "K2"), ("K3", "K4", "K5a", "K5b", "K6",
                                         "K7", "K8")),
               "dense": (("K3", "K4", "K5a"), ("K1", "K6", "K7", "K8")),
               "dense_fused_switch": (("K3", "K4", "K5a"),
                                      ("K1", "K6", "K7", "K8")),
               "ff_si": (("K1", "K2"), ("K3", "K4", "K5a", "K5b", "K6",
                                        "K7", "K8")),
               "ealignn": (("K2",), NOT_K2)}
CLI_KERNELS["x_sparse"] = CLI_KERNELS["sparse"]
CLI_KERNELS["x_dense"] = CLI_KERNELS["dense"]
# dst_update's bias reaches the node BatchNorm as a constant shift too:
# the aggregation is a gate-weighted mean (but for its 1e-6 eps)
BN_FED_BIASES = ("linear.bias", "src_update.bias", "dst_update.bias")


def write_rocksalt_folder(root: str, n: int) -> None:
    """n POSCARs and id_prop.csv: the cells and targets of
    ``graph.build.rocksalt_cells(n)`` (seed 0, rattle 0.02), the draws of
    ``rocksalt_graphs``."""
    from alignn_tpu_torch.graph.build import rocksalt_cells

    os.makedirs(root, exist_ok=True)
    rows = []
    for i, (atoms, target, _forces) in enumerate(rocksalt_cells(n)):
        name = f"POSCAR-{i:04d}.vasp"
        with open(os.path.join(root, name), "w") as f:
            f.write(atoms.to_poscar())
        rows.append(f"{name},{target!r}")
    with open(os.path.join(root, "id_prop.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")


def write_ff_folder(root: str, calc) -> None:
    """40 si64 cells (diamond 2x2x2, rattled 0.05 A, seeds 0-39) in
    id_prop.json, labelled by `calc` (docs/mlearn_r4/Si): energy per atom
    as total_energy, forces, Voigt stresses."""
    from alignn_tpu_torch.chem.atoms import Atoms

    os.makedirs(root, exist_ok=True)
    sc = diamond().make_supercell([2, 2, 2])
    entries = []
    for seed in range(40):
        cart = sc.cart_coords + np.random.default_rng(seed).normal(
            0.0, 0.05, sc.cart_coords.shape)
        atoms = Atoms(lattice_mat=sc.lattice_mat,
                      frac_coords=cart @ np.linalg.inv(sc.lattice_mat),
                      elements=sc.elements)
        res = calc.calculate(atoms)
        entries.append({"jid": f"si64_{seed}", "atoms": atoms.to_dict(),
                        "total_energy": res["energy"] / atoms.num_atoms,
                        "forces": np.asarray(res["forces"]).tolist(),
                        "stresses": np.asarray(res["stress"]).tolist()})
    with open(os.path.join(root, "id_prop.json"), "w") as f:
        json.dump(entries, f)


def write_json(path: str, obj) -> str:
    with open(path, "w") as f:
        json.dump(obj, f)
    return path


def moved(obj, device, dtype=None):
    """A GraphBatch (or any tree of dataclasses) with its tensors on
    `device`, its floating tensors in `dtype` if one is given."""
    import dataclasses

    import torch

    if isinstance(obj, torch.Tensor):
        if dtype is not None and obj.is_floating_point():
            return obj.to(device, dtype)
        return obj.to(device)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: moved(getattr(obj, f.name), device, dtype)
            for f in dataclasses.fields(obj) if f.init})
    return obj


class StepTap:
    """Taps the train and eval steps that ``train.trainer`` makes, for one
    run of ``cli.train`` inside the ``with``, and makes them compiled
    (`cuda_graph`, the trainer's default) or eager: at the trainer's
    first step the weights and the batch (copied to the host) and the
    launches of that step (an eager sighting either way); after it its
    loss and gradients; at every step the batch, so that :meth:`replay`
    can run the trainer's own step again after the run.  The copies add
    to the first epoch's seconds."""

    def __init__(self, cuda_graph: bool = True):
        self.cuda_graph = cuda_graph
        self.eval_step = None

    def __enter__(self):
        from alignn_tpu_torch.train import trainer

        self._trainer, self._make = trainer, trainer.make_train_step
        self._make_eval = trainer.make_eval_step
        self.first = None
        trainer.make_train_step = self._wrap
        trainer.make_eval_step = self._wrap_eval
        return self

    def __exit__(self, *exc):
        self._trainer.make_train_step = self._make
        self._trainer.make_eval_step = self._make_eval

    def _wrap_eval(self, model, **kw):
        self.eval_step = self._make_eval(model, cuda_graph=self.cuda_graph,
                                         **kw)
        return self.eval_step

    def compiled(self) -> dict:
        """Per step kind: signatures seen, graphs captured, each capture's
        host ms."""
        out = {}
        for what, step in (("train", self.step), ("eval", self.eval_step)):
            c = getattr(step, "compiled", None)
            if c is not None:
                out[what] = {"signatures": len(c.loops),
                             "captures": c.captures,
                             "capture_ms": [lp.capture_ms for lp in
                                            c.loops.values() if lp.graph]}
        return out

    def _wrap(self, model, **kw):
        import torch

        step = self._make(model, cuda_graph=self.cuda_graph, **kw)
        self.model, self.kw, self.step = model, kw, step

        def tapped(state, batch):
            self.batch = batch
            if self.first is not None:
                return step(state, batch)
            weights = {k: v.detach().cpu().clone()
                       for k, v in model.state_dict().items()}
            host_batch = moved(batch, torch.device("cpu"))
            before = read_launches()
            state, losses = step(state, batch)
            after = read_launches()
            self.first = {
                "launches": {k: after[k] - before[k] for k in after},
                "weights": weights, "batch": host_batch,
                "loss": float(losses["loss"]),
                "grads": {k: p.grad.detach().cpu().clone()
                          for k, p in model.named_parameters()}}
            return state, losses

        return tapped

    def replay(self, state) -> dict:
        """The trainer's step on its final state and last batch: one step
        timed on the host's clock, one more profiled."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        t = time.perf_counter()
        self.step(state, self.batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            self.step(state, self.batch)
            torch.cuda.synchronize()
        by_name, n_ops = device_ms_by_name(prof)
        busy = sum(by_name.values())
        b = self.batch
        host_ops = host_ops_in(prof)
        return {"bucket": [b.z.shape[0], b.r.shape[0], b.lg_mask.shape[0],
                           b.dense_D],
                "compiled": self.cuda_graph,
                "step_ms": wall_ms, "device_busy_ms": busy,
                "device_busy_share": busy / wall_ms,
                "device_ops_per_step": n_ops,
                "host_ops_per_step": host_ops,
                "host_us_per_op": wall_ms * 1e3 / max(host_ops, 1),
                "launches_from_profile": kernel_launches_in(prof),
                "kernel_ms": kernel_ms_by_id(by_name),
                "top_kernels_ms": top_kernels(by_name)}

    def hold_against_cpu(self, out: str, label: str, failures: list,
                         dtype: str = "float32") -> dict:
        """The trainer's first step again on the port on the CPU in
        `dtype`, from the same weights and batch: loss within 1e-4
        relative, each gradient within 1e-3 x its max|grad| + 1e-7 (a bias
        feeding a BatchNorm, whose exact gradient is 0, at the model's
        largest gradient).

        The FF run is held against float64: two float32 steps differ by
        the sum of their roundings, and there the first layers' gradients
        (max|grad| under 1e-6) are what is left after cancellations, so
        that a float32 step on the CPU alone lands most of the limit away
        from the exact value.
        """
        import torch

        from alignn_tpu_torch.config import TrainingConfig
        from alignn_tpu_torch.nn.layers import MaskedBatchNorm
        from alignn_tpu_torch.train.optim import build_optimizer
        from alignn_tpu_torch.train.state import (create_train_state,
                                                  make_train_step)
        from alignn_tpu_torch.train.trainer import COMPUTE_DTYPES, build_model

        cfg = TrainingConfig.from_json(os.path.join(out, "config.json"))
        # a 16-bit run: the CPU port in the same compute dtype, at the
        # 16-bit limits (prec_diff, PREC_TOL)
        compute = COMPUTE_DTYPES[cfg.dtype]
        model = build_model(cfg.model, dtype=compute)
        model.load_state_dict(self.first["weights"])
        batch = self.first["batch"]
        if dtype != "float32":    # as the card ran it, else all in dtype
            model.to(getattr(torch, dtype))
            batch = moved(batch, torch.device("cpu"), getattr(torch, dtype))
        state = create_train_state(model, batch, build_optimizer(
            cfg.optimizer, cfg.learning_rate, cfg.weight_decay, model=model))
        t = time.perf_counter()
        _s, losses = make_train_step(model, **self.kw)(state, batch)
        cpu_s = time.perf_counter() - t
        ref_loss, card = float(losses["loss"]), self.first
        ref = {k: p.grad.detach() for k, p in model.named_parameters()}
        batchnorm = any(isinstance(m, MaskedBatchNorm)
                        for m in model.modules())
        if compute is not None:
            return {"cpu_dtype": dtype, "compute_dtype": cfg.dtype,
                    "cpu_step_s": cpu_s, "first_loss": card["loss"],
                    **prec_diff(({"loss": card["loss"]}, card["grads"]),
                                ({"loss": ref_loss}, ref),
                                f"train_cli {label} card vs CPU", failures,
                                PREC_TOL_BN if batchnorm else PREC_TOL)}
        top = max(float(g.abs().max()) for g in ref.values())
        worst, worst_name = 0.0, ""
        for name, g in ref.items():
            diff = float((card["grads"][name].double() - g).abs().max())
            # rounding noise on an exact 0, held to the model's scale
            scale = top if batchnorm and name.endswith(BN_FED_BIASES) else \
                float(g.abs().max())
            ratio = diff / (TRAIN_TOL["grad_rel"] * scale
                            + TRAIN_TOL["grad_abs"])
            if ratio > worst:
                worst, worst_name = ratio, name
        row = {"cpu_dtype": dtype, "cpu_step_s": cpu_s,
               "first_loss": card["loss"],
               "card_vs_cpu_loss_rel": abs(card["loss"] - ref_loss)
               / abs(ref_loss),
               "grad_worst_share_of_limit": worst, "grad_worst": worst_name}
        if not row["card_vs_cpu_loss_rel"] <= TRAIN_TOL["loss_rel"]:
            failures.append(f"train_cli {label} first step: loss "
                            f"{card['loss']} on the card vs {ref_loss} on "
                            f"the CPU ({dtype})")
        if not worst <= 1.0:
            failures.append(f"train_cli {label} first step: gradient of "
                            f"{worst_name} at {worst} x its limit (card vs "
                            f"CPU {dtype})")
        return row


def cli_run(root: str, config: str, out: str, cache_from: str = None,
            extra=(), cuda_graph: bool = True) -> tuple:
    """``cli.train.main`` on the card into `out` (a copy of `cache_from`'s
    graph cache seeded there first, if given) with the trainer's steps
    compiled or eager, launches counted from 0 over the run; returns
    (summary, tap, seconds, launches, peak bytes)."""
    import shutil

    import torch

    from alignn_tpu_torch.cli import train as cli_train_mod

    shutil.rmtree(out, ignore_errors=True)
    if cache_from is not None:
        shutil.copytree(os.path.join(cache_from, "graph_cache"),
                        os.path.join(out, "graph_cache"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t = time.perf_counter()
    with StepTap(cuda_graph) as tap:
        summary = cli_train_mod.main(["--root_dir", root, "--config_name",
                                      config, "--output_dir", out, *extra])
    torch.cuda.synchronize()
    return (summary, tap, time.perf_counter() - t, read_launches(),
            torch.cuda.max_memory_allocated())


def final_weights(summary) -> dict:
    return {k: v.detach().clone()
            for k, v in summary["state"].model.state_dict().items()}


def cli_train(label: str, root: str, config: str, out: str, failures: list,
              cache_from: str = None, extra=(), cpu_dtype="float32",
              float64_if_missed: bool = False, keep: dict = None,
              holds: list = None) -> dict:
    """``cli.train.main`` on the card into `out` (:func:`cli_run`, the
    trainer's steps compiled), launches counted from 0 over the run and
    over its first train step; then the trainer's step replayed (timed,
    profiled, its launches counted from the profile) and its first step
    held against the CPU port in `cpu_dtype`, or with `float64_if_missed`
    in float32 and, where that misses, in float64, which then decides
    (both recorded).  `keep`, if given, receives the run's step losses
    and final weights.  With `holds`, the CPU check is appended there as
    a function, to be run later (:func:`run_holds`), not here."""
    import torch

    summary, tap, seconds, launches, peak = cli_run(root, config, out,
                                                    cache_from, extra)
    steps = summary["steps_per_epoch"]
    losses = [v for name in ("history_train.json", "history_val.json")
              for row in json.load(open(os.path.join(out, name)))
              for v in row]
    missing = [a for a in ARTIFACTS if not os.path.exists(
        os.path.join(out, a))]
    if missing:
        failures.append(f"train_cli {label}: artifacts missing: {missing}")
    if not (np.isfinite(losses).all() and all(
            np.isfinite(x).all() for x in summary["step_losses"])):
        failures.append(f"train_cli {label}: a loss is not finite")
    need, banned = CLI_KERNELS[label]
    per_step = tap.first["launches"]
    for counts, what in ((launches, "the run"), (per_step, "its first step")):
        if any(counts[k] <= 0 for k in need) or \
                any(counts[k] != 0 for k in banned):
            failures.append(f"train_cli {label}: launches over {what} "
                            f"{counts} (need {need}, none of {banned})")
    row = {"run": label, "seconds": seconds,
           "epochs": summary["epochs_run"], "steps_per_epoch": steps,
           "seconds_per_epoch": summary["epoch_s"],
           "ms_per_train_step": [1e3 * e / steps
                                 for e in summary["epoch_s"]],
           "trainer_edges_per_s": [summary["edges_per_batch"] * steps / e
                                   for e in summary["epoch_s"]],
           "graph_stage_s": summary["graph_stats"]["graph_s"],
           "graph_cache_hits": summary["graph_stats"]["cached"],
           "peak_memory_bytes": peak,
           "launches_over_run": launches,
           "launches_per_train_step": per_step,
           "compiled": tap.compiled(),
           "test_mae": summary.get("test_mae"),
           "learning_curve_png": os.path.exists(
               os.path.join(out, "learning_curve.png")),
           "history_train": json.load(open(os.path.join(
               out, "history_train.json")))}
    if not abs(tap.first["loss"] - summary["step_losses"][0][0]) <= 0.0:
        failures.append(f"train_cli {label}: the tapped first loss "
                        f"{tap.first['loss']} is not the trainer's")
    from alignn_tpu_torch.ff.step_loop import WARMUP_STEPS

    if steps * summary["epochs_run"] > WARMUP_STEPS and \
            row["compiled"]["train"]["captures"] < 1:
        failures.append(f"train_cli {label}: the train step was never "
                        f"captured ({row['compiled']})")
    row["replayed_step"] = tap.replay(summary["state"])
    got = row["replayed_step"]["launches_from_profile"]
    if any(got[k] <= 0 for k in need) or any(got[k] != 0 for k in banned):
        failures.append(f"train_cli {label}: the replayed step's launches "
                        f"{got} (need {need}, none of {banned})")
    if keep is not None:
        keep.update(losses=summary["step_losses"],
                    weights=final_weights(summary))
    del summary, tap.batch, tap.model, tap.step, tap.eval_step
    torch.cuda.empty_cache()

    def hold():
        missed: list = []
        row["first_step_vs_cpu"] = tap.hold_against_cpu(
            out, label, missed if float64_if_missed else failures, cpu_dtype)
        if missed:
            row["float32_missed"] = missed
            row["first_step_vs_cpu_float64"] = tap.hold_against_cpu(
                out, label, failures, "float64")

    if holds is None:
        hold()
    else:
        holds.append(hold)
    return row


def run_holds(holds: list, workers: int = 2) -> dict:
    """The deferred CPU checks of :func:`cli_train`, `workers` at a time
    in threads, the last deferred first (the f16 and f64 steps, which
    take a minute or more each on the CPU, start together); after every
    card run of the phase, so that no card timing shares the host with
    them."""
    from concurrent.futures import ThreadPoolExecutor

    t = time.perf_counter()
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for job in [pool.submit(h) for h in reversed(holds)]:
            job.result()
    return {"checks": len(holds), "workers": workers,
            "seconds": time.perf_counter() - t}


def runs_apart(a_losses, a_weights, b_losses, b_weights) -> dict:
    """Two trainer runs' step losses (per epoch) and final weights: bit
    for bit, and how far apart."""
    import torch

    la = np.asarray([v for ep in a_losses for v in ep])
    lb = np.asarray([v for ep in b_losses for v in ep])
    differ = [k for k in a_weights
              if not torch.equal(a_weights[k], b_weights[k])]
    rel = np.abs(la - lb) / np.maximum(np.abs(lb), 1e-30)
    return {"steps": int(la.size),
            "bitwise": la.tobytes() == lb.tobytes() and not differ,
            "weights_differing": len(differ),
            "first_loss_rel": float(rel[0]),
            "max_step_loss_rel": float(rel.max()),
            "final_weight_max_abs_diff": max(
                float((a_weights[k].double() - b_weights[k].double()).abs()
                      .max()) for k in a_weights)}


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def captured_vs_eager(label: str, root: str, config: str, out: str,
                      failures: list, captured: dict, kept: dict,
                      det_config: str, cache_from: str = None, extra=(),
                      loss_tol: float = TRAIN_TOL["loss_rel"]) -> dict:
    """The captured run `captured` (cli_train's row; `kept` its step
    losses and final weights) against the same run with the trainer's
    steps eager: trainer ms a step and s an epoch, the replayed step
    (wall and device ms) against the eager step replayed, the capture's
    ms and the steps it takes to pay back, peak memory; the default mode
    (index_add by atomics) held to the first-step loss limit `loss_tol` at
    every step, the replays' too;
    then the run of `det_config` (one epoch, no result files) captured
    and eager under torch's deterministic algorithms, whose step losses,
    validation history and final weights must agree bit for bit."""
    import torch

    summary, tap, seconds, _launches, peak = cli_run(
        root, config, out + "_eager", cache_from, extra, cuda_graph=False)
    steps = summary["steps_per_epoch"]
    eager = {"seconds": seconds, "seconds_per_epoch": summary["epoch_s"],
             "ms_per_train_step": [1e3 * e / steps
                                   for e in summary["epoch_s"]],
             "peak_memory_bytes": peak,
             "replayed_step": tap.replay(summary["state"])}
    default = runs_apart(kept["losses"], kept["weights"],
                         summary["step_losses"], final_weights(summary))
    del summary, tap
    torch.cuda.empty_cache()
    if not default["bitwise"]:
        default["not_bit_identical"] = NOT_BIT_IDENTICAL
    if not default["max_step_loss_rel"] <= loss_tol:
        failures.append(f"train_cli {label} captured vs eager: step losses "
                        f"up to {default['max_step_loss_rel']} apart "
                        f"(relative)")
    det = {}
    with deterministic():
        for mode in (True, False):
            d_out = out + ("_det_captured" if mode else "_det_eager")
            summary, tap, d_s, _l, _p = cli_run(
                root, det_config, d_out, cache_from, extra,
                cuda_graph=mode)
            det[mode] = (summary["step_losses"], final_weights(summary),
                         read_json(os.path.join(d_out, "history_val.json")),
                         tap.compiled(), d_s)
            del summary, tap
            torch.cuda.empty_cache()
    pair = runs_apart(det[True][0], det[True][1], det[False][0],
                      det[False][1])
    pair["history_val_bitwise"] = det[True][2] == det[False][2]
    pair["compiled"] = det[True][3]
    pair["seconds"] = {"captured": det[True][4], "eager": det[False][4]}
    if not (pair["bitwise"] and pair["history_val_bitwise"]):
        failures.append(f"train_cli {label}: captured vs eager under "
                        f"deterministic algorithms {pair}")
    rep, rep_eager = captured["replayed_step"], eager["replayed_step"]
    capture_ms = captured["compiled"]["train"]["capture_ms"]
    saving = rep_eager["step_ms"] - rep["step_ms"]
    return {"eager": eager,
            "ms_per_train_step": {"captured": captured["ms_per_train_step"],
                                  "eager": eager["ms_per_train_step"]},
            "replayed_ms": {"captured": rep["step_ms"],
                            "eager": rep_eager["step_ms"]},
            "device_ms": {"captured": rep["device_busy_ms"],
                          "eager": rep_eager["device_busy_ms"]},
            "capture_ms": capture_ms,
            "break_even_steps": capture_ms[0] / saving
            if capture_ms and saving > 0 else None,
            "peak_memory_bytes": {"captured": captured["peak_memory_bytes"],
                                  "eager": peak},
            "default_mode": default, "deterministic": pair}


def cli_profile(root: str, config: str, out: str, cache_from: str,
                failures: list) -> dict:
    """``cli.train --profile`` on (a)'s folder and config (its graph
    cache copied in): profile_step's result, and from its Chrome trace
    (6 replayed steps) the host operator events, device operations,
    kernel launches and device busy share a step."""
    import shutil

    from alignn_tpu_torch.cli import train as cli_train_mod

    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(cache_from, "graph_cache"),
                    os.path.join(out, "graph_cache"))
    trace_dir = os.path.join(out, "trace")
    with contextlib.redirect_stdout(io.StringIO()):
        result = cli_train_mod.main(["--root_dir", root, "--config_name",
                                     config, "--output_dir", out,
                                     "--profile", trace_dir])
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    active = 6
    device = [e for e in events if e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]
    ids = [kernel_id(e.get("name", "")) for e in device
           if e.get("cat") == "kernel"]
    launches = {key: ids.count(key) / active for key, _p in KERNEL_SYMBOLS}
    row = {**result,
           "host_ops_per_step": sum(1 for e in events
                                    if e.get("cat") == "cpu_op") / active,
           "device_ops_per_step": len(device) / active,
           "device_busy_share": sum(e.get("dur", 0) for e in device) / 1e6
           / (result["step_time_s"] * active),
           "launches_per_step": launches}
    if set(result) != {"step_time_s", "trace_dir", "edges_per_s"} or \
            not launches["K1"] > 0 or os.path.exists(
                os.path.join(out, "history_train.json")):
        failures.append(f"train_cli --profile: {row}")
    return row


def cache_readback(cache_dir: str) -> dict:
    """Every graph of every split read back once from the graph cache in
    `cache_dir` (files just written and read, so in the page cache):
    seconds to fetch the records' bytes, and to fetch and unpack them
    (``GraphCache[i]``, what a cached loader does for each graph of each
    batch, every epoch)."""
    import glob

    from alignn_tpu_torch.data.cache import GraphCache

    caches = [GraphCache(p[:-len(".idx")])
              for p in sorted(glob.glob(os.path.join(cache_dir, "*.idx")))]
    t = time.perf_counter()
    for c in caches:
        for i in range(len(c)):
            c.record(i)
    fetch_s = time.perf_counter() - t
    t = time.perf_counter()
    for c in caches:
        for i in range(len(c)):
            c[i]
    read_s = time.perf_counter() - t
    return {"graphs": sum(len(c) for c in caches), "fetch_bytes_s": fetch_s,
            "fetch_and_unpack_s": read_s, "fetch_share": fetch_s / read_s}


def predict_check(out: str, root: str, failures: list) -> dict:
    """``cli.predict`` on the test set's structures: from the run's last
    weights (config.json and last_model.mpk copied aside) against
    Test_results.json within 1e-5, and from the run's directory (its best
    model) finite."""
    import shutil

    from alignn_tpu_torch.cli import predict as cli_predict

    ids = json.load(open(os.path.join(out, "ids_train_val_test.json")))
    test_dir, last_dir = out + "_test_set", out + "_last"
    for d in (test_dir, last_dir):
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
    for sid in ids["id_test"]:
        shutil.copy(os.path.join(root, sid), test_dir)
    for name in ("config.json", "last_model.mpk"):
        shutil.copy(os.path.join(out, name), last_dir)
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):   # a line a structure
        rows = cli_predict.main(["--model_path", last_dir, "--file_path",
                                 test_dir])
        seconds = time.perf_counter() - t
        best = cli_predict.main(["--model_path", out, "--file_path",
                                 test_dir])
    tests = {r["id"]: r["predictions"] for r in json.load(open(
        os.path.join(out, "Test_results.json")))}
    diff = max(float(np.abs(np.asarray(r["prediction"])
                            - np.asarray(tests[os.path.basename(r["file"])]))
                     .max()) for r in rows)
    if not (len(rows) == len(tests) and diff <= 1e-5):
        failures.append(f"train_cli predict: {len(rows)} predictions, "
                        f"{diff} from Test_results.json")
    if not np.isfinite([r["prediction"] for r in best]).all():
        failures.append("train_cli predict: non-finite best-model output")
    return {"structures": len(rows), "seconds": seconds,
            "max_abs_diff_vs_test_results": diff}


def train_cli_phase(failures: list) -> tuple:
    """Folder training through ``cli.train`` on the card, then
    ``cli.predict``: (a) the ALIGNN property model at full width (4+4/256,
    BatchNorm), sparse, 3 epochs of 512 of 640 rocksalt cells; (d) the
    same run again from a new output directory seeded with (a)'s graph
    cache, one epoch, reading the cache; (b) dense, one epoch, then one
    epoch with ALIGNN_TPU_FUSED_LSTAGE=1 (K4, never K6/K7); (c) the FF
    config of docs/mlearn_r4/Si for one epoch on 40 si64 cells labelled by
    that potential.  Every run's first train step is the one held against
    the CPU port and counted per step, and every run trains through the
    compiled steps; (a), (b) and (c) run again with the steps eager, and
    captured and eager under deterministic algorithms (one epoch), and
    ``cli.train --profile`` profiles (a)'s step.  The first steps' CPU
    checks run last, two at a time.  Returns (rows, launches per property
    train step by layout)."""
    import shutil

    import torch

    from alignn_tpu_torch.ff.calculator import Calculator

    shutil.rmtree(TRAIN_CLI_DIR, ignore_errors=True)
    root = os.path.join(TRAIN_CLI_DIR, "rocksalt640")
    write_rocksalt_folder(root, TRAIN_CLI_CELLS)
    d = TRAIN_CLI_DIR
    cfg_a = write_json(os.path.join(d, "property.json"), PROPERTY_RUN)
    cfg_b = write_json(os.path.join(d, "property_dense.json"),
                       {**PROPERTY_RUN, "epochs": 1,
                        "dense_neighborhoods": True})
    out_a = os.path.join(d, "out_sparse")
    kept: dict = {"a": {}, "b": {}, "c": {}}
    holds: list = []    # the first steps' CPU checks, run at the end
    rows = {"a_sparse": cli_train("sparse", root, cfg_a, out_a, failures,
                                  keep=kept["a"], holds=holds)}
    rows["a_predict"] = predict_check(out_a, root, failures)
    # the deterministic pairs: one epoch, no result passes or files
    quiet = {"epochs": 1, "n_test": 4, "store_outputs": False,
             "write_predictions": False, "write_checkpoint": False}
    det_a = write_json(os.path.join(d, "property_det.json"),
                       {**PROPERTY_RUN, **quiet})
    rows["a_sparse"]["vs_eager"] = captured_vs_eager(
        "sparse", root, cfg_a, out_a, failures, rows["a_sparse"], kept["a"],
        det_a, cache_from=out_a)
    rows["a_profile"] = cli_profile(root, cfg_a, os.path.join(d, "out_prof"),
                                    out_a, failures)
    torch.cuda.empty_cache()
    rows["d_cached"] = cli_train("sparse", root, cfg_a,
                                 os.path.join(d, "out_cached"), failures,
                                 cache_from=out_a, extra=("--epochs", "1"),
                                 holds=holds)
    rows["d_cached"]["uncached_first_epoch_s"] = \
        rows["a_sparse"]["seconds_per_epoch"][0]
    rows["d_cached"]["cache_readback"] = cache_readback(
        os.path.join(d, "out_cached", "graph_cache"))
    if not all(rows["d_cached"]["graph_cache_hits"].values()) or \
            any(rows["a_sparse"]["graph_cache_hits"].values()):
        failures.append(f"train_cli: cache hits "
                        f"{rows['a_sparse']['graph_cache_hits']} then "
                        f"{rows['d_cached']['graph_cache_hits']}")
    out_b = os.path.join(d, "out_dense")
    rows["b_dense"] = cli_train("dense", root, cfg_b, out_b, failures,
                                cache_from=out_a, keep=kept["b"],
                                holds=holds)
    rows["b_dense"]["vs_eager"] = captured_vs_eager(
        "dense", root, cfg_b, out_b, failures, rows["b_dense"], kept["b"],
        write_json(os.path.join(d, "property_dense_det.json"),
                   {**PROPERTY_RUN, **quiet, "dense_neighborhoods": True}),
        cache_from=out_a)
    torch.cuda.empty_cache()
    with switch_env(FUSED_ENV):
        rows["b_dense_fused_switch"] = cli_train(
            "dense_fused_switch", root, cfg_b,
            os.path.join(d, "out_dense_fused"), failures, cache_from=out_a,
            holds=holds)
    # (a) again in bf16 and in f16 for one epoch each, from (a)'s cache
    for run, dt in (("a_bf16", "bfloat16"), ("a_f16", "float16")):
        rows[run] = cli_train(
            "sparse", root, write_json(os.path.join(d, f"property_{dt}.json"),
                                       {**PROPERTY_RUN, "epochs": 1,
                                        "dtype": dt}),
            os.path.join(d, f"out_{dt}"), failures, cache_from=out_a,
            holds=holds)
        rows[run]["f32_first_epoch"] = {
            k: rows["a_sparse"][k][0] for k in ("seconds_per_epoch",
                                                "ms_per_train_step",
                                                "trainer_edges_per_s")}
        torch.cuda.empty_cache()
    ff_root = os.path.join(d, "si64_40")
    write_ff_folder(ff_root, Calculator(path=MODEL_DIR))
    with open(os.path.join(MODEL_DIR, "config.json")) as f:
        ff_cfg = {**json.load(f), "epochs": 1, "n_train": 32, "n_val": 4,
                  "n_test": 4}
    cfg_c, out_c = write_json(os.path.join(d, "ff_si.json"), ff_cfg), \
        os.path.join(d, "out_ff")
    rows["c_ff_si"] = cli_train("ff_si", ff_root, cfg_c, out_c, failures,
                                cpu_dtype="float64", keep=kept["c"],
                                holds=holds)
    rows["c_ff_si"]["vs_eager"] = captured_vs_eager(
        "ff_si", ff_root, cfg_c, out_c, failures, rows["c_ff_si"],
        kept["c"], write_json(os.path.join(d, "ff_si_det.json"),
                              {**ff_cfg, **quiet}))
    del kept
    torch.cuda.empty_cache()
    rows["cpu_holds"] = run_holds(holds)
    per_step = {"sparse": rows["a_sparse"]["launches_per_train_step"],
                "dense": rows["b_dense"]["launches_per_train_step"]}
    return rows, per_step


FAMILIES_DIR = os.path.join(REPO, "build", "model_families")
EALIGNN_MODEL = {"name": "ealignn_atomwise"}   # eALIGNNAtomWiseConfig()
X_FEATURES = 6
X_CELLS = 128       # cut from train_cli's 640 to keep the phase short
X_RUN = {  # TrainingConfig of (x): ALIGNNConfig defaults + 6 extras
    "batch_size": 32, "n_train": 96, "n_val": 16, "n_test": 16,
    "epochs": 1, "learning_rate": 1e-3, "use_cache": True,
    "num_workers": 2, "model": {"name": "alignn",
                                "extra_features": X_FEATURES}}
PROP_MODEL = {"name": "alignn_atomwise", "atomwise_output_features": 2,
              "additional_output_features": 22}   # 4+4/256 by default


def seeded(cfg: dict, seed: int = 0):
    """A model of config dict `cfg` with weights drawn by
    ``init_parameters`` from a CPU generator seeded `seed`."""
    import torch

    from alignn_tpu_torch.config import model_config_from_dict
    from alignn_tpu_torch.nn.models import init_parameters
    from alignn_tpu_torch.train.trainer import build_model

    return init_parameters(build_model(model_config_from_dict(cfg)),
                           torch.Generator().manual_seed(seed))


def si_config() -> dict:
    with open(os.path.join(MODEL_DIR, "config.json")) as f:
        return json.load(f)


def rattled_rocksalt64():
    """The first cell of ``rocksalt_cells`` (seed 0) as a 2x2x2 supercell,
    each atom rattled 0.03 A (numpy seed 0): 64 atoms of two elements."""
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.graph.build import rocksalt_cells

    sc = next(iter(rocksalt_cells(1)))[0].make_supercell([2, 2, 2])
    cart = sc.cart_coords + np.random.default_rng(0).normal(
        0.0, 0.03, sc.cart_coords.shape)
    return Atoms(lattice_mat=sc.lattice_mat,
                 frac_coords=cart @ np.linalg.inv(sc.lattice_mat),
                 elements=sc.elements)


def ealignn_serving(failures: list) -> tuple:
    """(e) eALIGNN at its published defaults (2+2/64, inner cutoff 4 A,
    torque removed), seeded weights, through the Calculator with
    docs/mlearn_r4/Si's graph on si64_rattled and si512_rattled, and on
    a 64-atom rattled rocksalt cell: on one element every node starts
    alike and the normalised aggregations keep them alike but for their
    1e-6 eps, so an untrained model's Si forces are rounding noise
    (PERF.md §6), and the two-element cell gives the checks forces to hold.
    Sparse, dense (use_canonize: true) and dense under
    ALIGNN_TPU_FUSED_LSTAGE=1 (the weighted model stays unfused, so its
    results must equal the dense ones).  Sparse and dense against the port
    on the CPU.  Counts from 0 over each layout's cells.  Returns (rows,
    launches)."""
    from alignn_tpu_torch.ff.calculator import Calculator

    config = {**si_config(), "model": EALIGNN_MODEL}
    canon = {**config, "use_canonize": True}
    model, cpu_model = seeded(EALIGNN_MODEL), seeded(EALIGNN_MODEL)
    cells = si_cells()[1:] + [("nacl64_rattled", rattled_rocksalt64())]
    rows, launches = {}, {}
    for layout, cfg, dense in (("ealignn_sparse", config, False),
                               ("ealignn_dense", canon, True)):
        reset_launches()
        rows[layout] = run_cells(lambda: Calculator(
            model=model, config=cfg, dense=dense), cells, layout, failures)
        launches[layout] = read_launches()
        check_against(rows[layout], lambda: Calculator(
            model=cpu_model, config=cfg, dense=dense, device="cpu"),
            "cpu_port", failures)
    with switch_env(FUSED_ENV):
        reset_launches()
        rows["ealignn_fused"] = run_cells(lambda: Calculator(
            model=model, config=canon, dense=True), cells, "ealignn_fused",
            failures)
        launches["ealignn_fused"] = read_launches()
    check_results(rows["ealignn_fused"],
                  [res for _r, _a, res in rows["ealignn_dense"]],
                  "dense_on_card", failures)
    return rows, launches


def write_extra_folder(root: str, n: int) -> str:
    """id_prop.json of ``rocksalt_cells(n)`` (seed 0): each record's atoms,
    its energy target as total_energy and X_FEATURES extra features drawn
    from numpy seed 1."""
    from alignn_tpu_torch.graph.build import rocksalt_cells

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(1)
    entries = [{"jid": f"rocksalt_{i:04d}", "atoms": atoms.to_dict(),
                "total_energy": float(target),
                "extra_features": rng.standard_normal(X_FEATURES).tolist()}
               for i, (atoms, target, _f) in enumerate(rocksalt_cells(n))]
    return write_json(os.path.join(root, "id_prop.json"), entries)


def write_rocksalt_ff_folder(root: str, n: int) -> str:
    """id_prop.json of n 64-atom rocksalt cells: the 2x2x2 supercells of
    ``rocksalt_cells(n)`` (seed 0) with their energy targets as
    total_energy and forces 0.1 N(0, 1) (numpy seed 3)."""
    from alignn_tpu_torch.graph.build import rocksalt_cells

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(3)
    entries = []
    for i, (atoms, target, _f) in enumerate(rocksalt_cells(n)):
        sc = atoms.make_supercell([2, 2, 2])
        entries.append({"jid": f"nacl64_{i:02d}", "atoms": sc.to_dict(),
                        "total_energy": float(target),
                        "forces": rng.normal(0.0, 0.1, (64, 3)).tolist()})
    return write_json(os.path.join(root, "id_prop.json"), entries)


def extra_predict_check(out: str, root: str, failures: list) -> dict:
    """The run's last weights (config.json and last_model.mpk copied
    aside) through ``zoo.predict_structures`` with each test structure's
    extra features, against Test_results.json within 1e-5 (cli.predict
    reads structure files only, as JAX's, so it cannot pass them)."""
    import shutil

    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.zoo import load_model_dir, predict_structures

    last_dir = out + "_last"
    shutil.rmtree(last_dir, ignore_errors=True)
    os.makedirs(last_dir)
    for name in ("config.json", "last_model.mpk"):
        shutil.copy(os.path.join(out, name), last_dir)
    model, _cfg = load_model_dir(last_dir)
    records = {e["jid"]: e for e in json.load(open(os.path.join(
        root, "id_prop.json")))}
    rows = json.load(open(os.path.join(out, "Test_results.json")))
    t = time.perf_counter()
    got = predict_structures(
        model, [Atoms.from_dict(records[r["id"]]["atoms"]) for r in rows],
        extra_features=[records[r["id"]]["extra_features"] for r in rows])
    seconds = time.perf_counter() - t
    diff = float(np.abs(got - np.asarray([r["predictions"] for r in rows]))
                 .max())
    if not diff <= 1e-5:
        failures.append(f"model_families x predict: {diff} from "
                        f"Test_results.json")
    return {"structures": len(rows), "seconds": seconds,
            "max_abs_diff_vs_test_results": diff}


def xff_step(failures: list) -> tuple:
    """(x-ff) docs/mlearn_r4/Si's model config with extra_features: 6:
    the first train steps (2 warm-up, 4 timed) on five si64 cells of
    train_cli's si64_40 folder (one batch of that config) with six seeded
    features each, then the first step against the port's on the CPU.
    Returns (row, launches per step)."""
    import torch

    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.graph.build import build_graph

    base = si_config()
    cfg = {**base["model"], "extra_features": X_FEATURES}
    entries = json.load(open(os.path.join(TRAIN_CLI_DIR, "si64_40",
                                          "id_prop.json")))[:5]
    rng = np.random.default_rng(2)
    graphs = []
    for e in entries:
        atoms = Atoms.from_dict(e["atoms"])
        g = build_graph(atoms, cutoff=base["cutoff"],
                        max_neighbors=base["max_neighbors"],
                        use_canonize=base["use_canonize"])
        g.target = np.array([e["total_energy"]])
        g.forces = np.asarray(e["forces"])
        g.extra_features = rng.standard_normal(X_FEATURES)
        graphs.append(g)

    def batch_on(device):
        return batch_graphs(graphs, BucketSpec.tight_for_batch(graphs),
                            torch.device(device), extra_width=X_FEATURES)

    weights = seeded(cfg).state_dict()
    row, first, launches = train_run(weights, batch_on("cuda"), "xff",
                                     failures, steps=6, cfg=cfg)
    row["first_step_vs_cpu"] = step_diff(
        first, first_step(weights, batch_on("cpu"), cfg), "x-ff", failures)
    return row, launches


DETERMINISM_WARNINGS: set = set()   # ops torch found no fixed order for


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms inside (warn only), restored after:
    ``index_add`` then sums in a fixed order instead of by atomics, whose
    order, and so whose last bits, vary from call to call.  The warnings
    of ops that have no deterministic version are kept, once each, in
    :data:`DETERMINISM_WARNINGS`."""
    import warnings

    import torch

    previous = (torch.are_deterministic_algorithms_enabled(),
                torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
        DETERMINISM_WARNINGS.update(str(w.message)[:200] for w in caught)
    finally:
        torch.use_deterministic_algorithms(previous[0],
                                           warn_only=previous[1])


def icalculator_phase(failures: list) -> tuple:
    """(i) iCalculator: docs/mlearn_r4/Si as the force field and a seeded
    ALIGNNAtomWise at full width (4+4/256, atomwise head 2, additional
    head 22) saved to a model directory, on si64_rattled and
    si512_rattled: E/F/S equal to the plain Calculator's (stress_wt 0.05)
    bit for bit, both called under torch's deterministic algorithms (by
    default the force sums' atomics change the last bits from call to
    call; that difference is recorded too); charges, magmoms and the 22
    properties within 1e-4 x their largest of the port's property model
    on the CPU; ms per call beside the plain Calculator's.  Counts from 0
    over one call a cell.  Returns (rows, launches per call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from alignn_tpu_torch.ff.calculator import Calculator, iCalculator
    from alignn_tpu_torch.graph.build import build_graph
    from alignn_tpu_torch.nn.convert import flax_from_module
    from alignn_tpu_torch.nn.models import atomwise_forward
    from alignn_tpu_torch.train.checkpoint import save_params

    prop_dir = os.path.join(FAMILIES_DIR, "prop_model")
    os.makedirs(prop_dir, exist_ok=True)
    write_json(os.path.join(prop_dir, "config.json"),
               {**si_config(), "model": PROP_MODEL})
    save_params(os.path.join(prop_dir, "best_model.mpk"),
                *flax_from_module(seeded(PROP_MODEL, seed=1)))
    ic = iCalculator(ff_path=MODEL_DIR, prop_path=prop_dir)
    plain = Calculator(path=MODEL_DIR, stress_wt=0.05)
    cpu_prop = Calculator(path=prop_dir, device="cpu")

    def timed(calc, atoms):
        times = []
        for i in range(7):
            t = time.perf_counter()
            res = calc.calculate(atoms)
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t) * 1e3)
        return res, float(np.median(times))

    rows, launches = [], {}
    for name, atoms in si_cells()[1:]:
        n = atoms.num_atoms
        res, ms = timed(ic, atoms)
        pres, plain_ms = timed(plain, atoms)
        reset_launches()
        ic.calculate(atoms)
        launches[name] = read_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ic.calculate(atoms)
            torch.cuda.synchronize()
        by_name, _n_ops = device_ms_by_name(prof)
        atomics_diff = max(float(np.abs(np.asarray(res[k]) - pres[k]).max())
                           for k in ("energy", "forces", "stress"))
        with deterministic():
            res, pres = ic.calculate(atoms), plain.calculate(atoms)
        same = all(np.array_equal(res[k], pres[k])
                   for k in ("energy", "forces", "stress"))
        g = build_graph(atoms, neighbor_strategy=cpu_prop.neighbor_strategy,
                        cutoff=cpu_prop.cutoff,
                        max_neighbors=cpu_prop.max_neighbors,
                        use_canonize=cpu_prop.use_canonize)
        ref = atomwise_forward(cpu_prop.model, cpu_prop.batch_for(g))
        aw = ref["atomwise_pred"].detach().numpy()[:n]
        props = [max(v, 0.0) if "gap" in p else v
                 for p, v in zip(ic.props, ref["additional"].detach()
                                 .numpy()[0])]
        rel = {}
        for key, got, want in (
                ("charges", res["charges"], aw[:, 0]),
                ("magmoms", res["magmoms"], aw[:, 1]),
                ("props", [res[p] for p in ic.props], props)):
            got, want = np.asarray(got), np.asarray(want)
            rel[key] = float(np.abs(got - want).max()
                             / max(float(np.abs(want).max()), 1e-12))
        row = {"cell": name, "atoms": n, "ms_per_calculate": ms,
               "plain_calculator_ms": plain_ms,
               "device_busy_share": sum(by_name.values()) / ms,
               "top_kernels_ms": top_kernels(by_name),
               "efs_bitwise_equal_plain": same,
               "efs_max_abs_diff_plain_by_default": atomics_diff,
               "rel_diff_vs_cpu_port": rel, "props": len(ic.props),
               "launches_per_call": launches[name]}
        if not same:
            failures.append(f"model_families i {name}: E/F/S differ from "
                            f"the plain Calculator's")
        if not (len(ic.props) == 22 and all(v <= 1e-4
                                             for v in rel.values())):
            failures.append(f"model_families i {name}: {rel} vs the CPU "
                            f"port (limit 1e-4)")
        need, banned = LAYOUT_KERNELS["sparse"]
        counts = launches[name]
        if any(counts[k] <= 0 for k in need) or \
                any(counts[k] != 0 for k in banned):
            failures.append(f"model_families i {name}: launches {counts}")
        rows.append(row)
    return rows, launches


def model_families_phase(failures: list) -> tuple:
    """The model families of this slice: (e) eALIGNN serving, (e-train)
    eALIGNN trained through ``cli.train`` on train_cli's si64_40 folder
    with the model block replaced by eALIGNN's defaults, one epoch; (x)
    the ALIGNN property model at its defaults with 6 extra features on
    128 rocksalt cells (96/16/16) in id_prop.json, one epoch sparse, then
    one dense from its graph cache, and the sparse run's last weights
    predicting its test set; (x-ff) the FF config with extra features;
    (i) iCalculator.  Returns (rows, launches a call or step by run)."""
    import shutil

    import torch

    shutil.rmtree(FAMILIES_DIR, ignore_errors=True)
    os.makedirs(FAMILIES_DIR)
    rows, launches = {}, {}
    serving, serving_launches = ealignn_serving(failures)
    for layout, cell_rows in serving.items():
        rows[f"e_{layout}"] = [row for row, _a, _r in cell_rows]
        launches[f"e_{layout}_per_call"] = \
            cell_rows[1][0]["launches_per_call"]      # si512's
        launches[f"e_{layout}_over_cells"] = serving_launches[layout]
    torch.cuda.empty_cache()
    d = FAMILIES_DIR
    cfg_e = {**si_config(), "epochs": 1, "n_train": 32, "n_val": 4,
             "n_test": 4, "model": EALIGNN_MODEL}
    # si64_40's one element would leave the forces, and the gradients
    # that flow through them, at rounding noise (see ealignn_serving)
    e_root = os.path.join(d, "nacl64_40")
    write_rocksalt_ff_folder(e_root, 40)
    rows["e_train"] = cli_train(
        "ealignn", e_root, write_json(os.path.join(d, "ealignn.json"), cfg_e),
        os.path.join(d, "out_ealignn"), failures, float64_if_missed=True)
    launches["e_train_per_step"] = rows["e_train"]["launches_per_train_step"]
    # one bf16 step of (e-train): one batch of 5 cells
    rows["e_train_bf16"] = cli_train(
        "ealignn", e_root, write_json(os.path.join(d, "ealignn_bf16.json"),
                                      {**cfg_e, "n_train": 5,
                                       "dtype": "bfloat16"}),
        os.path.join(d, "out_ealignn_bf16"), failures)
    torch.cuda.empty_cache()
    root = os.path.join(d, f"rocksalt{X_CELLS}_x")
    write_extra_folder(root, X_CELLS)
    out_x = os.path.join(d, "out_x_sparse")
    rows["x_sparse"] = cli_train(
        "x_sparse", root, write_json(os.path.join(d, "x.json"), X_RUN),
        out_x, failures)
    rows["x_predict"] = extra_predict_check(out_x, root, failures)
    rows["x_dense"] = cli_train(
        "x_dense", root, write_json(os.path.join(d, "x_dense.json"),
                                    {**X_RUN, "dense_neighborhoods": True}),
        os.path.join(d, "out_x_dense"), failures, cache_from=out_x)
    for layout in ("x_sparse", "x_dense"):
        launches[f"{layout}_per_step"] = \
            rows[layout]["launches_per_train_step"]
    torch.cuda.empty_cache()
    rows["x_ff"], launches["x_ff_per_step"] = xff_step(failures)
    torch.cuda.empty_cache()
    rows["i"], i_launches = icalculator_phase(failures)
    for cell, counts in i_launches.items():
        launches[f"i_{cell}_per_call"] = counts
    return rows, launches


KERNELS = (  # id, name, source, replaces
    ("K1", "eggc_gated_aggregate", "alignn_tpu_torch/csrc/eggc.cu",
     "alignn_tpu/ops/pallas_eggc.py:45"),
    ("K2", "sorted_segment_sum", "alignn_tpu_torch/csrc/eggc.cu",
     "alignn_tpu/ops/pallas_eggc.py:178"),
    ("K3", "dense_gated_aggregate", "alignn_tpu_torch/csrc/dense.cu",
     "alignn_tpu/ops/pallas_dense.py:72"),
    ("K4", "dense_pair_aggregate", "alignn_tpu_torch/csrc/dense.cu",
     "alignn_tpu/ops/pallas_dense.py:266"),
    ("K5a", "pair_aggregate_bwd", "alignn_tpu_torch/csrc/dense.cu",
     "alignn_tpu/ops/pallas_dense.py:395"),
    ("K5b", "pair_aggregate_bwd2", "alignn_tpu_torch/csrc/dense.cu",
     "alignn_tpu/ops/pallas_dense.py:533"),
    ("K6", "fused_pair_lstage", "alignn_tpu_torch/csrc/fused_lstage.cu",
     "alignn_tpu/ops/pallas_fused_lstage.py:103"),
    ("K7", "fused_lstage_bwd", "alignn_tpu_torch/csrc/fused_lstage.cu",
     "alignn_tpu/ops/pallas_fused_lstage.py:294"),
    ("K8", "windowed_gather", "alignn_tpu_torch/csrc/gather.cu",
     "alignn_tpu/ops/pallas_gather.py:119"),
)
DENSE_KERNELS = ("K3", "K4", "K5a", "K5b", "K6", "K7")
FUSED_ENV = "ALIGNN_TPU_FUSED_LSTAGE"
WGATHER_ENV = "ALIGNN_TPU_ENABLE_WGATHER"


# ---------------------------------------------------------------------------
# the compute dtypes, remat_layers and the fp8 L-tables (phase precision)
# ---------------------------------------------------------------------------

# a 16-bit first step against the f32 step of the same path, weights and
# batch, at the limits tests/test_torch_port_precision.py holds the CPU
# port's 16-bit steps to (its CARD): loss components within loss_rel
# (relative), the gradients' L2 distance within l2_rel of their L2 norm,
# each parameter's max abs difference within grad_top x the model's
# largest gradient
PREC_TOL = {"loss_rel": 2e-2, "l2_rel": 5e-2, "grad_top": 0.15}
# a BatchNorm model's bf16 gradients are mostly cancellation noise (its
# CARD_BN there)
PREC_TOL_BN = {"loss_rel": 2e-2, "l2_rel": 0.2, "grad_top": 0.3}
# the fp8 L-tables round through 3 mantissa bits: the limits of the JAX
# package's own fp8 tests (tests/test_fp8.py: outputs 5 %, forces 15 %)
FP8_TOL = {"loss_rel": 5e-2, "l2_rel": 0.15, "grad_top": 0.15}
FP8_ENV = "ALIGNN_TPU_FP8_LTABLES"
# (run, layout: its kernel lists and its f32 run, dtype, switch, remat);
# the f32 dense step opens and closes the runs, so that bench.py's default
# step is timed between two f32 steps of the same call
PRECISION_RUNS = (
    ("f32_dense_before", "dense", "float32", None, False),
    ("bf16_dense", "dense", "bfloat16", None, False),
    ("bf16_sparse", "sparse", "bfloat16", None, False),
    ("bf16_fused", "fused", "bfloat16", FUSED_ENV, False),
    ("bf16_windowed", "wsparse", "bfloat16", WGATHER_ENV, False),
    ("f16_dense", "dense", "float16", None, False),
    ("remat_f32_dense", "dense", "float32", None, True),
    ("remat_bf16_dense", "dense", "bfloat16", None, True),
    ("fp8_bf16_dense", "dense", "bfloat16", FP8_ENV, False),
    ("fp8_bf16_sparse", "sparse", "bfloat16", FP8_ENV, False),
    ("bf16_envelope", "envelope", "bfloat16", None, False),
    ("f32_dense_after", "dense", "float32", None, False))


def prec_diff(a, b, what: str, failures: list, tol=PREC_TOL) -> dict:
    """Loss components and gradients of two first steps (a 16-bit or fp8
    step against the f32 step), within `tol`; anything not finite
    fails."""
    (la, ga), (lb, gb) = a, b
    loss_rel = max(abs(la[k] - lb[k]) / max(abs(lb[k]), 1e-30)
                   for k in lb if lb[k] != 0)
    top = max(float(g.abs().max()) for g in gb.values())
    worst, worst_name, sq, norm = 0.0, "", 0.0, 0.0
    for k, ref in gb.items():
        d = ga[k].double() - ref.double()
        diff = float(d.abs().max())
        sq += float((d * d).sum())
        norm += float((ref.double() ** 2).sum())
        ratio = diff / (tol["grad_top"] * top)
        if not np.isfinite(ratio):
            ratio = float("inf")
        if ratio > worst:
            worst, worst_name = ratio, k
    l2_rel = float(np.sqrt(sq / norm))
    if not loss_rel <= tol["loss_rel"]:
        failures.append(f"precision {what}: loss components differ by "
                        f"{loss_rel} (relative) > {tol['loss_rel']}")
    if not worst <= 1.0:
        failures.append(f"precision {what}: gradient of {worst_name} at "
                        f"{worst} x its limit")
    if not l2_rel <= tol["l2_rel"]:
        failures.append(f"precision {what}: gradients' L2 distance "
                        f"{l2_rel} of their norm > {tol['l2_rel']}")
    return {"loss_max_rel_diff": loss_rel, "grad_l2_rel": l2_rel,
            "grad_worst_share_of_limit": worst, "grad_worst": worst_name}


def trajectory_gap(run: list, ref: list) -> dict:
    """The largest relative gap of the total loss, step by step, between
    two 12-step trajectories."""
    gaps = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
            for a, b in zip(run, ref)]
    return {"loss_rel_gap_per_step": gaps, "loss_rel_gap_max": max(gaps)}


def precision_phase(weights, graphs, f32_rows: dict, f32_first: dict,
                    failures: list) -> tuple:
    """dense_rocksalt_b64 in the compute dtypes of the JAX trainer:
    bench.py's default step (bf16, dense, b64), bf16 sparse, fused and
    windowed, f16 dense, remat_layers dense in f32 and bf16, the fp8
    L-tables dense and sparse in bf16, and the envelope b16 step in bf16,
    between two f32 dense runs.
    Per run 2 warm-up and 10 timed steps (ms, edges/s, one profiled
    step's busy share, peak memory, launches a step, the 12-step loss
    trajectory beside the f32 run of the same path, `f32_rows`), and its
    first step against the card's f32 first step of the same path on the
    same weights and batch (`f32_first`, else computed here) at PREC_TOL
    (FP8_TOL with fp8; f32 runs at TRAIN_TOL, remat's peak memory below
    the f32 step's).  Returns (rows, launches a step per run)."""
    import torch

    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig,
                                            init_parameters)

    dev = torch.device("cuda")
    batches = train_batches(graphs, dev)
    env_graphs = None
    # envelope_train_phase's weights
    envelope_weights = init_parameters(
        ALIGNNAtomWise(ALIGNNAtomWiseConfig(**ENVELOPE_TRAIN_CFG)),
        torch.Generator().manual_seed(0)).state_dict()
    rows, launches = {}, {}
    for run, layout, dtype, switch, remat in PRECISION_RUNS:
        cfg = TRAIN_CFG
        if layout == "envelope":
            if env_graphs is None:
                from alignn_tpu_torch.graph.batch import (BucketSpec,
                                                          batch_graphs)
                from alignn_tpu_torch.graph.build import rocksalt_graphs

                env_graphs = rocksalt_graphs(
                    ENVELOPE_TRAIN_CELLS, seed=0,
                    neighbor_strategy="radius_graph", cutoff=4.5,
                    use_canonize=False)
                batches["envelope"] = batch_graphs(
                    env_graphs, BucketSpec.tight_for_batch(env_graphs), dev)
            cfg = ENVELOPE_TRAIN_CFG
            w = envelope_weights
        else:
            w = weights
        if remat:
            cfg = {**cfg, "remat_layers": True}
        batch = batches[{"wsparse": "sparse", "fused": "dense"}.get(
            layout, layout)]
        tdtype = getattr(torch, dtype)
        with switch_env(switch) if switch else contextlib.nullcontext():
            row, first, per_step = train_run(
                w, batch, layout, failures, cfg=cfg,
                dtype=None if dtype == "float32" else tdtype)
            if layout not in f32_first:
                f32_first[layout] = first_step(
                    w, batch, {k: v for k, v in cfg.items()
                               if k != "remat_layers"})
        what = f"{run} first step vs f32"
        if dtype == "float32":
            check = step_diff(first, f32_first[layout], what, failures)
        if remat and dtype == "float32":
            peak, ref_peak = row["peak_memory_bytes"], \
                f32_rows[layout]["peak_memory_bytes"]
            check["peak_vs_f32_no_remat"] = peak / ref_peak
            if not peak < ref_peak:
                failures.append(f"precision {run}: peak memory {peak} B not "
                                f"below the step without remat's "
                                f"{ref_peak} B")
        elif dtype != "float32":
            check = prec_diff(first, f32_first[layout], what, failures,
                              FP8_TOL if switch == FP8_ENV else PREC_TOL)
        row = {"run": run, "dtype": dtype, "switch": switch,
               "remat_layers": remat, "first_step_vs_f32": check,
               "f32_ms_per_step": f32_rows[layout]["ms_per_step"],
               "f32_peak_memory_bytes": f32_rows[layout]["peak_memory_bytes"],
               "trajectory_vs_f32": trajectory_gap(
                   row["losses"], f32_rows[layout]["losses"]), **row}
        if run == "bf16_dense":   # bench.py's default step, compiled
            row["captured"] = captured_bench_step(w, batch, cfg, tdtype,
                                                  row, failures)
        rows[run], launches[run] = row, per_step
        del first
        torch.cuda.empty_cache()
    return rows, launches


@contextlib.contextmanager
def switch_env(name: str):
    """The switch `name` set to 1 inside, restored after whatever
    happens."""
    previous = os.environ.get(name)
    os.environ[name] = "1"
    try:
        yield
    finally:
        if previous is None:
            del os.environ[name]
        else:
            os.environ[name] = previous


def fused_slice(new_dense_calc, drows, cpu_calc, failures: list):
    """The dense Calculator with ALIGNN_TPU_FUSED_LSTAGE=1 on the three Si
    cells (it must launch K6 and K7, and no K4, K5a or K1), E/F/S against
    the unfused dense results `drows` of the same cells on the card and, at
    8 and 64 atoms, against `cpu_calc()` (the port's fused path on the
    CPU).  Returns (rows, launches over the three cells)."""
    with switch_env(FUSED_ENV):
        # counts from 0 over the three cells
        reset_launches()
        frows = run_cells(new_dense_calc, si_cells(), "fused", failures)
        launches = read_launches()
        check_results(frows, [res for _r, _a, res in drows], "dense_on_card",
                      failures)
        check_against(frows[:2], cpu_calc, "cpu_port", failures)
    return frows, launches


def segments_probe() -> int:
    """``--segments``: K1 and K2 alone, at the 512-atom L-stage and the
    sparse training batch's (:func:`kernel_phase`), with eggc.cu's ptxas
    lines; no ``{"ok": ...}`` line."""
    import torch

    import alignn_tpu_torch
    from alignn_tpu_torch import _build
    from alignn_tpu_torch.ff.calculator import Calculator
    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs

    print(smi_line(), flush=True)
    t = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "package": os.path.dirname(alignn_tpu_torch.__file__)})
    emit({"phase": "ptxas_eggc",
          "kernels": ptxas_kernels(_build.build_log("eggc"))})
    failures: list = []
    calc = Calculator(path=MODEL_DIR)
    g = calc.graph_for(rattled_supercell(4))
    batch = batch_graphs([g], calc.bucket_for(g), calc.device)
    emit({"phase": "segments", "site": "si512_rattled lg dst",
          **kernel_phase(batch.lg_index.dst, failures)})
    gs = rocksalt_b64()
    batch = batch_graphs(gs, BucketSpec.tight_for_batch(gs), calc.device)
    emit({"phase": "segments", "site": "dense_rocksalt_b64 sparse lg dst",
          **kernel_phase(batch.lg_index.dst, failures)})
    for msg in failures:
        print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    return 1 if failures else 0


def digest(x) -> str:
    """sha256 of a tensor's bytes, to show bit-identity across calls."""
    import hashlib

    import torch

    return hashlib.sha256(x.contiguous().view(-1).view(
        torch.uint8).cpu().numpy().tobytes()).hexdigest()


class SmClock:
    """The SM clock (MHz) that ``nvidia-smi`` reads every 100 ms while the
    ``with`` body runs: its median and maximum."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--id=0", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out = self.proc.communicate(timeout=30)[0]
        mhz = [float(w) for w in out.split() if w.strip().isdigit()]
        self.mhz = {"median": float(np.median(mhz)) if mhz else None,
                    "max": max(mhz) if mhz else None, "samples": len(mhz)}


def sass_loops(lib: str, kernel: str) -> list:
    """For each instance of `kernel` in the library `lib` (``cuobjdump
    -sass``): the innermost loop with the most ``MUFU.EX2`` (one a
    sigmoid), its instructions (NOPs left out) and their count per
    element (over the loop's EX2s), and its opcode histogram.  The count
    is static: code the loop body runs once a row is counted as if it
    ran every iteration."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out = []
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if kernel not in name:
            continue
        code = []
        for line in part.splitlines():
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
            if m:
                ins = re.sub(r"^@!?U?P[T0-9]+\s+", "", m.group(2).strip())
                code.append((int(m.group(1), 16), ins.split()[0], ins))
        loops = []   # backward branches: (target, branch) address ranges
        for addr, op, ins in code:
            tgt = re.search(r"0x[0-9a-f]+", ins) if op.startswith("BRA") \
                else None
            if tgt is not None and int(tgt.group(0), 16) <= addr:
                loops.append((int(tgt.group(0), 16), addr))
        inner = [lo for lo in loops if not any(
            o != lo and lo[0] <= o[0] and o[1] <= lo[1] for o in loops)]
        best = None
        for lo, hi in inner:
            body = [op for a, op, _ in code if lo <= a <= hi and op != "NOP"]
            ex2 = body.count("MUFU.EX2")
            if ex2 and (best is None or ex2 > best["ex2"]):
                hist: dict = {}
                for op in body:
                    hist[op] = hist.get(op, 0) + 1
                best = {"instructions": len(body), "ex2": ex2,
                        "per_element": len(body) / ex2,
                        "mufu": sum(v for k, v in hist.items()
                                    if k.startswith("MUFU")),
                        "opcodes": dict(sorted(hist.items(),
                                               key=lambda kv: -kv[1]))}
        out.append({"kernel": name, "instructions": len(code),
                    "inner_loop": best})
    return out


def pair_probe(batch, failures: list, sass: list, clock_mhz: float) -> dict:
    """K4 alone at the dense shapes of `batch` (its real slot masks
    folded into random logits, F 256), in f32, bf16 and f16: against its
    plain version, fully masked (j, t) rows exactly 0, two launches
    bit-identical, a sha256 of the output; warm and cold ms, the cold
    time's share of the byte bound, the profiler's device time by kernel
    (cold), and the issue floor of the kernel instance's inner loop (its
    static SASS count per element, which counts branches not taken too,
    x elements over 128 instructions a clock on each SM at
    `clock_mhz`)."""
    import torch

    from alignn_tpu_torch.ops import dense as dk

    dev, D = batch.r.device, batch.dense_D
    n, f = batch.z.shape[0], 256
    rows, pairs = n * D, n * D * D
    gen = torch.Generator(device=dev).manual_seed(4)
    m2_raw = torch.randn(pairs, f, device=dev, generator=gen)
    bh32 = torch.randn(rows, f, device=dev, generator=gen)
    empty = batch.lg_mask.reshape(rows, D).sum(dim=1) == 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {"shape": dense_shape(batch), "masked_rows": int(empty.sum())}
    calls = []
    for dtype in kernel_dtypes():
        name = str(dtype).split(".")[1]
        es = torch.tensor([], dtype=dtype).element_size()
        m2 = dk.fold_mask(m2_raw.to(dtype), batch.lg_mask)
        bh = bh32.to(dtype)
        got = dk.dense_pair_aggregate_cuda(m2, bh, D)
        again = dk.dense_pair_aggregate_cuda(m2, bh, D)
        ref = dk.dense_pair_aggregate_plain(m2, bh, D)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            failures.append(f"K4 [{name}]: two launches differ")
        if not bool((got[empty] == 0).all()) or \
                not bool(torch.isfinite(got.float()).all()):
            failures.append(f"K4 [{name}]: a fully masked row is not "
                            f"exactly 0, or h is not finite")
        err = compare(got, ref, name, failures, "K4 dense_pair_aggregate")
        b_ms, b_by = bound((pairs + 2 * rows) * f * es,
                           7.0 * pairs * f + 2.0 * rows * f)
        calls.append(lambda m2=m2, bh=bh: dk.dense_pair_aggregate_cuda(
            m2, bh, D))
        tag = {"float32": "IfLi4E", "bfloat16": "I13__nv_bfloat16Li8E",
               "float16": "I6__halfLi8E"}[name]   # mangled instance
        loop = next((s["inner_loop"] for s in sass if tag in s["kernel"]
                     and s["inner_loop"]), None)
        floor = None if loop is None or not clock_mhz else \
            loop["per_element"] * pairs * f / (128.0 * sms) / \
            (clock_mhz * 1e3)
        res[name] = {**err, "sha256": digest(got),
                     **timed(calls[-1], lambda m2=m2, bh=bh:
                             dk.dense_pair_aggregate_plain(m2, bh, D),
                             b_ms, b_by),
                     "issue_floor_static_ms": floor}
        del got, again, ref
    res["split_ms"] = kernel_split(calls)
    return res


def pairs_probe(steps: bool) -> int:
    """``--pairs``: K4 alone at the si512 dense shape (N 768, D 18) and
    bench.py's b64 (N 512, D 13) (:func:`pair_probe`), with dense.cu's
    ptxas lines and the SASS of K4's inner loop; with ``--steps`` also
    the device time of one profiled dense train step (bench.py's, f32
    and bf16) and of the dense MD chunk's replayed step at si512
    (:func:`md_chunk_phase`).  No ``{"ok": ...}`` line."""
    import torch

    import alignn_tpu_torch
    from alignn_tpu_torch import _build
    from alignn_tpu_torch.ff.calculator import Calculator

    print(smi_line(), flush=True)
    t = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "package": os.path.dirname(alignn_tpu_torch.__file__)})
    emit({"phase": "ptxas_k4", "kernels": [
        e for e in ptxas_kernels(_build.build_log("dense"))
        if "pair_kernel" in e["kernel"]]})
    sass = sass_loops(str(libs["dense"]), "pair_kernel")
    emit({"phase": "sass_k4", "kernels": sass})
    failures: list = []
    from alignn_tpu_torch.ops import dense as dk

    mismatches = dk.sigmoid_mismatches()
    emit({"phase": "sigmoid_select", "f32_patterns": 1 << 32,
          "mismatches": mismatches})
    if mismatches:
        failures.append(f"dense.cu sigmoid differs from 1 / (1 + exp(-x)) "
                        f"on {mismatches} f32 bit patterns")
    dev = torch.device("cuda")
    base = Calculator(path=MODEL_DIR)
    dcalc = Calculator(model=base.model, config={
        **base.config, "use_canonize": True}, dense=True)
    batches = {"si512_rattled": dcalc.batch_for(dcalc.graph_for(
        rattled_supercell(4))),
        "dense_rocksalt_b64": train_batches(rocksalt_b64(), dev)["dense"]}
    # the clock under load: K4 f32 at si512, back to back
    b = batches["si512_rattled"]
    x = torch.randn(b.lg_mask.shape[0], 256, device=dev)
    y = torch.randn(b.edge_mask.shape[0], 256, device=dev)
    with SmClock() as clock:
        t = time.perf_counter()
        while time.perf_counter() - t < 2.0:
            for _ in range(50):
                dk.dense_pair_aggregate_cuda(x, y, b.dense_D)
            torch.cuda.synchronize()
    del x, y
    emit({"phase": "sm_clock_under_k4", **clock.mhz})
    for site, batch in batches.items():
        emit({"phase": "pairs", "site": site,
              **pair_probe(batch, failures, sass, clock.mhz["median"])})
    if steps:
        from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                                ALIGNNAtomWiseConfig,
                                                init_parameters)

        weights = init_parameters(ALIGNNAtomWise(ALIGNNAtomWiseConfig(
            **TRAIN_CFG)), torch.Generator().manual_seed(0)).state_dict()
        for dtype in (None, torch.bfloat16):
            row, _first, per_step = train_run(
                weights, batches["dense_rocksalt_b64"], "dense", failures,
                steps=4, dtype=dtype)
            emit({"phase": "pairs_step", "run": "train dense "
                  + ("float32" if dtype is None else "bfloat16"),
                  "device_busy_ms": row["device_busy_ms"],
                  "ms_per_step": row["ms_per_step"],
                  "K4_per_step": per_step["K4"]})
        del batches
        torch.cuda.empty_cache()
        row = md_chunk_phase(base.model, rattled_supercell(4), "dense",
                             dict(cutoff=8.0, neighbor_strategy="k-nearest"),
                             failures)
        emit({"phase": "pairs_step", "run": "md chunk dense si512",
              "device_busy_ms": row["device_busy_ms_per_step"],
              "ms_per_step": row["captured_ms_per_step"],
              "K4_per_step": row["launches_per_step"]["K4"]})
    for msg in failures:
        print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    return 1 if failures else 0


# ---------------------------------------------------------------------------
# data parallelism (NCCL at world size 1; two gloo ranks on cuda:0), the
# warm-model server and the legacy CLI
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the campaign scripts (alignn_tpu_torch/scripts)
# ---------------------------------------------------------------------------

SCRIPTS_DIR = os.path.join(REPO, "build", "scripts")
FF_SCRIPTS = ("ev_curve", "cubic_mat_relax", "defect", "plot_phonons_ff")
PREDICT_CELLS = 16     # of train_cli's rocksalt POSCARs
# card vs CPU phonon frequencies: F 5e-4 eV/A over the 0.02 A central
# difference is 0.025 eV/A^2 in a force constant, about 0.01 THz at Si's
# optical frequencies
PHONON_TOL_THZ = 1e-2
SCRIPTS_CPU_TIMEOUT_S = 300   # the CPU port's runs, after the card's
# train_mlearn's batch: its first step is held against the CPU port in
# float64, which takes the host about 20 s a 64-atom cell
MLEARN_BATCH = 2


def ff_script_args(name: str, path: str, out: str,
                   supercell: str = "1,1,1") -> list:
    """The arguments of FF script `name` on the POSCAR at `path`, writing
    beside `out`: the scripts' defaults, but the cell itself as the
    vacancy supercell and `supercell` as the phonons'."""
    if name == "plot_phonons_ff":
        return ["--model_path", MODEL_DIR, "--file_path", path,
                "--supercell", supercell, "--output_prefix", out]
    args = ["--model_path", MODEL_DIR, path, "--output", out + ".json"]
    return args + (["--supercell", "1,1,1"] if name == "defect" else [])


def run_script(name: str, args: list) -> tuple:
    """(result, seconds) of ``scripts.<name>.main(args)``, its printing
    swallowed."""
    import importlib

    mod = importlib.import_module(f"alignn_tpu_torch.scripts.{name}")
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = mod.main(args)
    return res, time.perf_counter() - t


def _jsonable(x):
    return np.asarray(x).tolist()


def scripts_cpu_main(jobs_path: str) -> int:
    """``--scripts-cpu JOBS``: the CPU port's runs of the jobs in the json
    file JOBS ({key: [script, args]}, each run with ``--device cpu``),
    each result written to ``<JOBS dir>/<key>.json`` with its seconds."""
    import torch

    torch.set_num_threads(4)
    with open(jobs_path) as f:
        jobs = json.load(f)
    out = os.path.dirname(jobs_path)
    for key, (name, args) in jobs.items():
        res, seconds = run_script(name, args + ["--device", "cpu"])
        with open(os.path.join(out, f"{key}.json"), "w") as f:
            json.dump({"result": res, "seconds": seconds}, f,
                      default=_jsonable)
    return 0


def hold_script(name: str, n_atoms: int, card, cpu) -> dict:
    """The card's result of script `name` against the CPU port's: the
    largest differences and whether each is within its limit."""
    if name == "predict_db":
        d = max(float(np.abs(np.asarray(card[k]) - np.asarray(cpu[k]))
                    .max()) for k in card)
        return {"predictions": d, "ok": sorted(card) == sorted(cpu)
                and d <= 1e-5}
    if name == "plot_phonons_ff":
        d = float(np.abs(np.asarray(card["frequencies_THz"])
                         - np.asarray(cpu["frequencies_THz"])).max())
        return {"frequencies_THz": d, "ok": d <= PHONON_TOL_THZ}
    (c,), (p,) = card.values(), cpu.values()
    tol = CPU_TOL["energy_per_atom"]
    if name == "ev_curve":
        d = float(np.abs(np.asarray(c["energies"])
                         - np.asarray(p["energies"])).max()) / n_atoms
        return {"energy_per_atom": d, "ok": d <= tol}
    if name == "cubic_mat_relax":
        d = abs(c["energy"] - p["energy"]) / n_atoms
        return {"energy_per_atom": d,
                "a_relaxed_A": abs(c["a_relaxed"] - p["a_relaxed"]),
                "steps": [c["steps"], p["steps"]], "ok": d <= tol}
    d = max(max(abs(a["E_vacancy"] - b["E_vacancy"]) / (n_atoms - 1),
                abs(a["E_bulk"] - b["E_bulk"]) / n_atoms)
            for a, b in zip(c, p))
    df = max(abs(a["E_formation"] - b["E_formation"]) for a, b in zip(c, p))
    return {"energy_per_atom": d, "formation_eV": df,
            "ok": d <= tol and df <= tol * n_atoms}


def scripts_inputs() -> dict:
    """The scripts' inputs: the si8 and si64 POSCARs, and from
    ``train_cli`` (run here on a smaller folder when that phase has not
    run) its rocksalt POSCARs, its trained property model and its 40
    labelled si64 cells."""
    import shutil

    from alignn_tpu_torch.ff.calculator import Calculator

    shutil.rmtree(SCRIPTS_DIR, ignore_errors=True)
    os.makedirs(SCRIPTS_DIR)
    cells = {}
    for name, atoms in (("si8", diamond()), ("si64", rattled_supercell(2))):
        cells[name] = (os.path.join(SCRIPTS_DIR, f"POSCAR-{name}"),
                       atoms.num_atoms)
        with open(cells[name][0], "w") as f:
            f.write(atoms.to_poscar())
    root = os.path.join(TRAIN_CLI_DIR, "rocksalt640")
    model = os.path.join(TRAIN_CLI_DIR, "out_sparse")
    ff_root = os.path.join(TRAIN_CLI_DIR, "si64_40")
    made = not os.path.exists(os.path.join(model, "best_model.mpk"))
    if made:   # --scripts alone: one epoch on 64 cells
        root = os.path.join(SCRIPTS_DIR, "rocksalt64")
        model = os.path.join(SCRIPTS_DIR, "out_property")
        write_rocksalt_folder(root, 64)
        cfg = write_json(os.path.join(SCRIPTS_DIR, "property.json"),
                         {**PROPERTY_RUN, "epochs": 1, "n_train": 48,
                          "n_val": 8, "n_test": 8, "batch_size": 16,
                          "num_workers": 0})
        with contextlib.redirect_stdout(io.StringIO()):
            from alignn_tpu_torch.cli import train as cli_train_mod

            cli_train_mod.main(["--root_dir", root, "--config_name", cfg,
                                "--output_dir", model])
    if not os.path.exists(os.path.join(ff_root, "id_prop.json")):
        ff_root = os.path.join(SCRIPTS_DIR, "si64_40")
        write_ff_folder(ff_root, Calculator(path=MODEL_DIR))
    from alignn_tpu_torch.chem.atoms import Atoms

    names = sorted(n for n in os.listdir(root) if n.startswith("POSCAR"))
    records = [{"jid": n, "atoms": Atoms.from_file(
        os.path.join(root, n)).to_dict()} for n in names[:PREDICT_CELLS]]
    rec_path = write_json(os.path.join(SCRIPTS_DIR, "records.json"),
                          records)
    # an mlearn-like data root: Si/ with the labelled cells and the Si
    # config cut to them (as train_cli (c))
    mlearn = os.path.join(SCRIPTS_DIR, "mlearn_root")
    os.makedirs(os.path.join(mlearn, "Si"))
    shutil.copy(os.path.join(ff_root, "id_prop.json"),
                os.path.join(mlearn, "Si", "id_prop.json"))
    with open(os.path.join(MODEL_DIR, "config.json")) as f:
        write_json(os.path.join(mlearn, "Si", "config.json"),
                   {**json.load(f), "n_train": 32, "n_val": 4,
                    "n_test": 4})
    return {"cells": cells, "records": rec_path, "model": model,
            "mlearn_root": mlearn, "train_cli_inputs": not made}


def scripts_phase(failures: list) -> tuple:
    """The campaign scripts on the card, each timed with its launches
    counted from 0: ev_curve, cubic_mat_relax, defect and plot_phonons_ff
    with docs/mlearn_r4/Si (4+4/256) on si8 and si64 (the vacancy
    supercell: the cell; the phonons': si8's cell, and for si64 si8 on
    the 2x2x2 supercell), predict_db on 16 of train_cli's rocksalt
    POSCARs with its trained model, and train_mlearn for one epoch
    (batch MLEARN_BATCH) on the 40 labelled si64 cells at the Si config's
    width.  Meanwhile a process of
    this script (``--scripts-cpu``) runs the same FF scripts on si8 and
    predict_db on the CPU port; each card result is held against it (E
    1e-4 eV/atom, phonon frequencies PHONON_TOL_THZ, predictions 1e-5).
    si64 is held through cubic_mat_relax's relaxed cell: its E/F/S on the
    card against the CPU port (CPU_TOL); its other scripts would take the
    CPU port minutes a call.  train_mlearn's first step (StepTap) is held
    against the CPU port in float64, as train_cli (c).  Returns (rows,
    launches by script run)."""
    import threading

    import torch

    from alignn_tpu_torch.ff.calculator import Calculator

    t0 = time.perf_counter()
    inputs = scripts_inputs()
    cpu_dir = os.path.join(SCRIPTS_DIR, "cpu")
    os.makedirs(cpu_dir)
    jobs = {f"{name}_si8": [name, ff_script_args(
        name, inputs["cells"]["si8"][0], os.path.join(cpu_dir, name))]
        for name in FF_SCRIPTS}
    jobs["predict_db"] = ["predict_db", [
        "--model_dir", inputs["model"], "--records_json", inputs["records"],
        "--output", os.path.join(cpu_dir, "predict_db.json")]]
    jobs_path = write_json(os.path.join(cpu_dir, "jobs.json"), jobs)
    cpu_log = open(os.path.join(SCRIPTS_DIR, "cpu.log"), "w")
    cpu = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                            "--scripts-cpu", jobs_path],
                           stdout=cpu_log, stderr=subprocess.STDOUT)
    rows, launches = {"inputs": {k: v for k, v in inputs.items()
                                 if k != "cells"}}, {}
    card_dir = os.path.join(SCRIPTS_DIR, "card")
    os.makedirs(card_dir)
    try:
        # train_mlearn first, so that its CPU hold overlaps the rest
        out = os.path.join(card_dir, "mlearn_out")
        reset_launches()
        with StepTap() as tap:
            res, seconds = run_script("train_mlearn", [
                "--data_root", inputs["mlearn_root"], "--elements", "Si",
                "--override", "epochs=1", f"batch_size={MLEARN_BATCH}",
                "--output_dir", out])
        torch.cuda.synchronize()
        launches["train_mlearn"] = read_launches()
        row = {"seconds": seconds, "launches": launches["train_mlearn"],
               "launches_first_step": tap.first["launches"],
               "result": res}
        rows["train_mlearn"] = row
        if not all(np.isfinite([res[0].get("test_energy_mae", np.nan),
                                res[0].get("test_force_mae", np.nan)])):
            failures.append(f"scripts train_mlearn: {res}")
        hold = threading.Thread(target=lambda: row.update(
            first_step_vs_cpu=tap.hold_against_cpu(
                os.path.join(out, "Si"), "train_mlearn", failures,
                dtype="float64")))
        hold.start()
        card = {}
        si8 = inputs["cells"]["si8"][0]
        for cell, (path, n) in inputs["cells"].items():
            for name in FF_SCRIPTS:
                key = f"{name}_{cell}"
                # si64's phonons: si8's on the 2x2x2 (64-atom) supercell
                args = ff_script_args(name, si8, os.path.join(
                    card_dir, key), "2,2,2") if key == \
                    "plot_phonons_ff_si64" else ff_script_args(
                        name, path, os.path.join(card_dir, key))
                reset_launches()
                res, seconds = run_script(name, args)
                torch.cuda.synchronize()
                launches[key] = read_launches()
                card[key] = json.loads(json.dumps(res, default=_jsonable))
                rows[key] = {"seconds": seconds, "atoms": n,
                             "launches": launches[key]}
        reset_launches()
        res, seconds = run_script("predict_db", [
            "--model_dir", inputs["model"], "--records_json",
            inputs["records"], "--output",
            os.path.join(card_dir, "predict_db.json")])
        torch.cuda.synchronize()
        launches["predict_db"] = read_launches()
        card["predict_db"] = res
        rows["predict_db"] = {"seconds": seconds, "structures": len(res),
                              "launches": launches["predict_db"]}
        # si64 through its relaxed cell: the card's E/F/S on it against
        # the CPU port's
        (relaxed,) = card["cubic_mat_relax_si64"].values()
        from alignn_tpu_torch.chem.atoms import Atoms

        atoms = Atoms.from_dict(relaxed["atoms"])
        got = Calculator(path=MODEL_DIR).calculate(atoms)
        ref = Calculator(path=MODEL_DIR, device="cpu").calculate(atoms)
        case = [({"cell": "si64 relaxed by cubic_mat_relax"}, atoms, got)]
        check_results(case, [ref], "scripts_cpu_port", failures)
        rows["cubic_mat_relax_si64"]["vs_cpu_port"] = case[0][0]
        d = abs(got["energy"] - relaxed["energy"]) / atoms.num_atoms
        rows["cubic_mat_relax_si64"]["script_energy_vs_calculator"] = d
        hold.join()
        cpu.wait(timeout=SCRIPTS_CPU_TIMEOUT_S)
    finally:
        if cpu.poll() is None:
            cpu.kill()
            cpu.wait()
        cpu_log.close()
    if cpu.returncode != 0:
        failures.append("scripts: the CPU port's runs failed: " + open(
            cpu_log.name).read()[-2000:])
        return rows, launches
    for key in list(jobs):
        with open(os.path.join(cpu_dir, f"{key}.json")) as f:
            ref = json.load(f)
        name = jobs[key][0]
        n = inputs["cells"]["si8"][1]
        rows[key]["cpu_port_seconds"] = ref["seconds"]
        rows[key]["vs_cpu_port"] = held = hold_script(
            name, n, card[key], ref["result"])
        if not held["ok"]:
            failures.append(f"scripts {key}: card vs CPU port {held}")
    for key, counts in launches.items():
        # the property model's forward alone (predict_db) runs K1 only
        need = ("K1",) if key == "predict_db" else ("K1", "K2")
        if any(counts[k] <= 0 for k in need):
            failures.append(f"scripts {key}: launched {counts}, needs "
                            f"{need}")
    rows["seconds"] = time.perf_counter() - t0
    return rows, launches


def scripts_probe() -> int:
    """``--scripts``: the kernels built, then :func:`scripts_phase`
    alone; no ``{"ok"}`` line."""
    import torch

    from alignn_tpu_torch import _build

    print(smi_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    failures: list = []
    rows, launches = scripts_phase(failures)
    for name, row in rows.items():
        emit({"phase": "scripts", "part": name, "row": row}
             if not isinstance(row, dict) else
             {"phase": "scripts", "part": name, **row})
    emit({"launches_scripts": launches})
    for msg in failures:
        print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    return 1 if failures else 0


DP_DIR = os.path.join(REPO, "build", "dp")
DP_STEPS = 12
# the rank step of the two gloo ranks: 8 cells a rank, sparse, eager
GLOO_CELLS, GLOO_STEPS = 8, 4


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def nccl_world_of_one():
    """An NCCL process group of one rank on this process's card (the
    card's host has one GPU), destroyed after; yields its mesh."""
    import torch.distributed as dist

    from alignn_tpu_torch.parallel.mesh import (initialize_distributed,
                                                make_mesh)

    initialize_distributed(f"localhost:{free_port()}", 1, 0, device="cuda")
    try:
        yield make_mesh(1)
    finally:
        dist.destroy_process_group()


def compiled_steps(weights, batch, dtype, mesh, steps: int = DP_STEPS):
    """`steps` compiled E/F/S steps (two eager sightings, a capture,
    replays) of bench.py's model from `weights` on `batch`, single-rank
    (`mesh` None) or through ``make_dp_train_step``; then one replay
    profiled.  Returns (row, [steps, losses] tensor, final state dict,
    launches counted over the run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig)
    from alignn_tpu_torch.parallel.dp import make_dp_train_step
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    model = ALIGNNAtomWise(ALIGNNAtomWiseConfig(**TRAIN_CFG), dtype=dtype)
    model.load_state_dict(weights)
    state = create_train_state(model, batch,
                               build_optimizer("adamw", 1e-3, 1e-5))
    step = make_train_step(model) if mesh is None else \
        make_dp_train_step(model, mesh)
    torch.cuda.synchronize()
    reset_launches()
    times, losses = [], []
    for _ in range(steps):
        t = time.perf_counter()
        state, out = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(torch.stack(list(out.values())))
    launches = read_launches()
    final = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for _ in range(2):   # the first pays the profiler's start-up
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(state, batch)
            torch.cuda.synchronize()
    by_name, n_ops = device_ms_by_name(prof)
    nccl = {k: v for k, v in by_name.items() if "nccl" in k.lower()}
    loops = list(step.compiled.loops.values())
    row = {"ms_steps": times,
           "ms_per_step": float(np.median(times[DP_STEPS // 4:])),
           "device_ms": sum(by_name.values()), "device_ops": n_ops,
           "all_reduce_device_ms": sum(nccl.values()),
           "all_reduce_kernels": {k[:90]: v for k, v in nccl.items()},
           "captures": step.compiled.captures,
           "capture_ms": [lp.capture_ms for lp in loops if lp.graph],
           "launches_per_replayed_step": kernel_launches_in(prof),
           "host_ops_per_replayed_step": host_ops_in(prof)}
    del state, model, step, prof
    torch.cuda.empty_cache()
    return row, torch.stack(losses), final, launches


def dp_train_run(mode: str, out: str) -> int:
    """``--dp-train single|dp OUT``: bench.py's default E/F/S step (bf16,
    64 rocksalt cells, seeded weights), dense then sparse, 12 compiled
    steps each under deterministic algorithms (:func:`compiled_steps`),
    single-rank or through ``make_dp_train_step`` on an NCCL group of one
    rank; the rows, losses and final parameters written under `out`.

    Each side runs in a fresh process with the same history: in one
    process two bf16 runs of the force step can differ in their last bits
    even under deterministic algorithms, because the autograd engine
    orders the outer backward's nodes by sequence numbers kept per thread,
    the force's inner backward creates its nodes on the device's worker
    thread, and that counter runs on from one run to the next
    (``--bf16-order`` shows the backward's operations in another order
    while the forward stays bit for bit)."""
    import torch

    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig,
                                            init_parameters)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    weights = init_parameters(ALIGNNAtomWise(ALIGNNAtomWiseConfig(
        **TRAIN_CFG)), torch.Generator().manual_seed(0)).state_dict()
    batches = train_batches(rocksalt_b64(), torch.device("cuda"))
    rows = {}
    with (nccl_world_of_one() if mode == "dp" else
          contextlib.nullcontext()) as mesh:
        for layout in ("dense", "sparse"):
            with deterministic():
                row, losses, final, launches = compiled_steps(
                    weights, batches[layout], torch.bfloat16, mesh)
            rows[layout] = {**row, "launches_over_run": launches}
            torch.save({"losses": losses.cpu(),
                        "params": {k: v.cpu() for k, v in final.items()}},
                       os.path.join(out, f"{mode}_{layout}.pt"))
    rows["determinism_warnings"] = sorted(DETERMINISM_WARNINGS)
    write_json(os.path.join(out, f"{mode}.json"), rows)
    return 0


def dp_train_phase(failures: list) -> tuple:
    """bench.py's default E/F/S step (bf16, 64 rocksalt cells), dense and
    sparse, through ``make_dp_train_step`` on an NCCL group of one rank,
    compiled (the all-reduces inside the CUDA graph), beside the
    single-rank compiled step, each in a process of its own
    (:func:`dp_train_run`, under a hard timeout), both under deterministic
    algorithms: their 12 steps' losses and final parameters bit for bit;
    ms a step (median of the last 9, host clock), the profiled replay's
    device ms, the all-reduce's device ms and the kernels' launches a
    step.  Launches are counted from 0 over each DP run (its eager
    sightings and its capture; a replay moves no counter).  Returns (rows,
    launches a DP step by layout, from the profiler)."""
    import shutil

    import torch

    t0 = time.perf_counter()
    out = os.path.join(DP_DIR, "dp_train")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    for mode in ("single", "dp"):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--dp-train", mode,
             out], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            timeout=300)
        if res.returncode != 0:
            failures.append(f"dp_train {mode}: "
                            f"{res.stdout.decode(errors='replace')[-2000:]}")
            return {"seconds": time.perf_counter() - t0}, {}
    runs = {mode: read_json(os.path.join(out, f"{mode}.json"))
            for mode in ("single", "dp")}
    rows, per_step = {}, {}
    for layout in ("dense", "sparse"):
        a, b = (torch.load(os.path.join(out, f"{mode}_{layout}.pt"))
                for mode in ("single", "dp"))
        differ = [k for k in a["params"]
                  if not torch.equal(a["params"][k], b["params"][k])]
        single, dp = runs["single"][layout], runs["dp"][layout]
        launches = dp.pop("launches_over_run")
        single.pop("launches_over_run")
        row = {"layout": layout, "dtype": "bfloat16", "dp": dp,
               "single": single,
               "losses_bitwise": bool(torch.equal(a["losses"], b["losses"])),
               "params_bitwise": not differ, "params_differing": differ[:5],
               "launches_over_run": launches}
        rows[layout] = row
        per_step[layout] = dp["launches_per_replayed_step"]
        if not (row["losses_bitwise"] and row["params_bitwise"]):
            failures.append(f"dp_train {layout}: world-size-1 DP step vs "
                            f"single-rank step, losses bitwise "
                            f"{row['losses_bitwise']}, params differing "
                            f"{differ[:5]}")
        if dp["captures"] != 1:
            failures.append(f"dp_train {layout}: {dp['captures']} captures")
        if not torch.isfinite(b["losses"]).all():
            failures.append(f"dp_train {layout}: non-finite losses")
        need, banned = TRAIN_KERNELS[layout]
        if any(launches[k] <= 0 for k in need) or \
                any(launches[k] != 0 for k in banned) or \
                any(dp["launches_per_replayed_step"][k] <= 0 for k in need):
            failures.append(f"dp_train {layout}: launches {launches}, "
                            f"replay {dp['launches_per_replayed_step']} "
                            f"(need {need}, none of {banned})")
    rows["determinism_warnings"] = sorted(
        set(runs["single"]["determinism_warnings"])
        | set(runs["dp"]["determinism_warnings"]))
    rows["seconds"] = time.perf_counter() - t0
    return rows, per_step


@contextlib.contextmanager
def trainer_dp(n_devices: int = 1):
    """``cli.train``'s single-rank trainer replaced by ``train_model_dp``
    over the initialised group inside the ``with``."""
    from alignn_tpu_torch.cli import train as cli_train_mod
    from alignn_tpu_torch.parallel.dp import train_model_dp

    single = cli_train_mod.train_model
    cli_train_mod.train_model = lambda config, tr, va, te, **kw: \
        train_model_dp(config, tr, va, te, n_devices=n_devices, **kw)
    try:
        yield
    finally:
        cli_train_mod.train_model = single


def dp_property_phase(failures: list) -> dict:
    """Property run (a)'s config (the full-width BatchNorm model, batch
    64, 512 train cells, one epoch, no result files) through
    ``train_model_dp`` on the NCCL group of one rank, beside the
    single-rank trainer, both compiled under deterministic algorithms, from
    (a)'s graph cache: step losses, validation history and final weights
    bit for bit; K1/K2 launched in the DP run (counted from 0 over it)."""
    import shutil

    import torch

    t0 = time.perf_counter()
    root = os.path.join(TRAIN_CLI_DIR, "rocksalt640")
    cache = os.path.join(TRAIN_CLI_DIR, "out_sparse")
    if not os.path.exists(os.path.join(cache, "graph_cache")):
        write_rocksalt_folder(root, TRAIN_CLI_CELLS)   # --dp alone
        cache = None
    os.makedirs(DP_DIR, exist_ok=True)
    cfg = write_json(os.path.join(DP_DIR, "property_det.json"),
                     {**PROPERTY_RUN, "epochs": 1, "n_test": 4,
                      "store_outputs": False, "write_predictions": False,
                      "write_checkpoint": False})
    runs = {}
    with deterministic():
        for mode in ("single", "dp"):
            out = os.path.join(DP_DIR, f"property_{mode}")
            with (trainer_dp() if mode == "dp" else
                  contextlib.nullcontext()):
                summary, _tap, seconds, launches, peak = cli_run(
                    root, cfg, out, cache)
            runs[mode] = (summary["step_losses"], final_weights(summary),
                          read_json(os.path.join(out, "history_val.json")),
                          seconds, launches, summary["epoch_s"])
            del summary, _tap
            torch.cuda.empty_cache()
    pair = runs_apart(runs["dp"][0], runs["dp"][1], runs["single"][0],
                      runs["single"][1])
    pair["history_val_bitwise"] = runs["dp"][2] == runs["single"][2]
    row = {"config": "train_cli (a), 1 epoch", **pair,
           "seconds": {m: r[3] for m, r in runs.items()},
           "epoch_s": {m: r[5] for m, r in runs.items()},
           "launches_dp_run": runs["dp"][4]}
    if not (pair["bitwise"] and pair["history_val_bitwise"]):
        failures.append(f"dp_property: train_model_dp at world size 1 vs "
                        f"the single-rank trainer {pair}")
    need, banned = CLI_KERNELS["sparse"]
    if any(runs["dp"][4][k] <= 0 for k in need) or \
            any(runs["dp"][4][k] != 0 for k in banned):
        failures.append(f"dp_property: launches {runs['dp'][4]}")
    row["seconds_total"] = time.perf_counter() - t0
    return row


def gloo_rank_main(rank: int, port: int, out: str) -> int:
    """One of two gloo ranks sharing cuda:0 (``--gloo-rank``): the sparse
    E/F/S step of bench.py's model (f32, seeded weights) on this rank's 8
    of the first 16 rocksalt cells (``BucketedLoader(num_shards=2)``),
    eager, 4 steps; then the same first step on the port on the CPU (the
    same group, CPU tensors).  Writes its numbers to `out`/rank<r>.json.
    A gloo build that refuses CUDA tensors is recorded, not failed."""
    import hashlib

    import torch
    import torch.distributed as dist

    from alignn_tpu_torch.data.dataset import GraphDataset
    from alignn_tpu_torch.data.loader import BucketedLoader, worst_case_spec
    from alignn_tpu_torch.graph.build import rocksalt_graphs
    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig,
                                            init_parameters)
    from alignn_tpu_torch.parallel.dp import make_dp_train_step
    from alignn_tpu_torch.parallel.mesh import (initialize_distributed,
                                                make_mesh)
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import create_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(4)    # two ranks on the host's 8 cores
    initialize_distributed(f"localhost:{port}", 2, rank, device="cuda",
                           backend="gloo")
    result: dict = {"rank": rank}
    try:
        probe = torch.ones(4, device="cuda")
        try:
            dist.all_reduce(probe)
            result["gloo_cuda"] = bool(probe.eq(2).all())
        except RuntimeError as exc:   # the build's capability, recorded
            result.update(gloo_cuda=False, error=str(exc)[:300])
        if result["gloo_cuda"]:
            mesh = make_mesh(2)
            graphs = rocksalt_graphs(2 * GLOO_CELLS)
            weights = init_parameters(ALIGNNAtomWise(ALIGNNAtomWiseConfig(
                **TRAIN_CFG)), torch.Generator().manual_seed(0)).state_dict()

            def run(device, steps):
                loader = BucketedLoader(
                    GraphDataset(graphs, [str(i) for i in range(len(graphs))]),
                    GLOO_CELLS, spec=worst_case_spec(graphs, GLOO_CELLS),
                    num_shards=2, shard_index=rank, prefetch=0,
                    device=device)
                model = ALIGNNAtomWise(ALIGNNAtomWiseConfig(**TRAIN_CFG))
                model.load_state_dict(weights)
                step = make_dp_train_step(model, mesh, cuda_graph=False)
                state, losses, first = None, [], None
                t = time.perf_counter()
                for epoch in range(steps):
                    loader.set_epoch(epoch)
                    for batch in loader:
                        state = state or create_train_state(
                            model, batch, build_optimizer("adamw", 1e-3,
                                                          1e-5))
                        state, lo = step(state, batch)
                        losses.append({k: float(v) for k, v in lo.items()})
                        if first is None:
                            first = ({k: float(v) for k, v in lo.items()},
                                     {k: p.grad.detach().cpu().clone()
                                      for k, p in model.named_parameters()})
                digest = hashlib.sha256(b"".join(
                    v.detach().cpu().numpy().tobytes()
                    for v in model.state_dict().values())).hexdigest()
                return losses, first, digest, time.perf_counter() - t

            losses, card_first, digest, seconds = run("cuda", GLOO_STEPS)
            _l, cpu_first, _d, cpu_s = run("cpu", 1)
            fails: list = []
            result.update(losses=losses, params_sha256=digest,
                          card_seconds=seconds, cpu_seconds=cpu_s,
                          card_vs_cpu_first_step=step_diff(
                              card_first, cpu_first, "gloo card vs CPU",
                              fails),
                          failures=fails)
    finally:
        dist.destroy_process_group()
    write_json(os.path.join(out, f"rank{rank}.json"), result)
    return 0


def gloo_start() -> tuple:
    """Start the two gloo ranks sharing cuda:0 (:func:`gloo_rank_main`,
    each a process of this script); :func:`gloo_phase` waits for them."""
    import shutil

    out = os.path.join(DP_DIR, "gloo")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--gloo-rank", str(r),
         str(port), out], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in (0, 1)]
    return procs, out, time.perf_counter()


def gloo_phase(started: tuple, failures: list) -> dict:
    """The two gloo ranks of :func:`gloo_start`, bounded by a hard
    timeout: their parameters bit for bit, their losses equal, each first
    step against the CPU port's two-rank step at the card-vs-CPU
    first-step limits."""
    procs, out, t0 = started
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        failures.append("gloo: a rank failed: " + " | ".join(
            log[-1500:] for log in logs))
        return {"seconds": time.perf_counter() - t0}
    r0, r1 = (read_json(os.path.join(out, f"rank{r}.json")) for r in (0, 1))
    row = {"gloo_cuda": r0["gloo_cuda"], "seconds": time.perf_counter() - t0}
    if not r0["gloo_cuda"]:
        row["error"] = r0.get("error")
        return row
    row.update(steps=len(r0["losses"]), losses=r0["losses"],
               params_bitwise=r0["params_sha256"] == r1["params_sha256"],
               losses_equal=r0["losses"] == r1["losses"],
               card_seconds=[r0["card_seconds"], r1["card_seconds"]],
               cpu_seconds=[r0["cpu_seconds"], r1["cpu_seconds"]],
               card_vs_cpu_first_step=[r0["card_vs_cpu_first_step"],
                                       r1["card_vs_cpu_first_step"]])
    failures.extend(r0["failures"] + r1["failures"])
    if not (row["params_bitwise"] and row["losses_equal"]) or \
            row["steps"] != GLOO_STEPS:
        failures.append(f"gloo: ranks apart or {row['steps']} steps: {row}")
    return row


def http(url: str, payload=None) -> tuple:
    """(code, JSON body) of a GET, or of a POST of `payload`."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url, data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def serve_phase(failures: list) -> tuple:
    """``cli.serve`` with docs/mlearn_r4/Si and ``--ff`` on an ephemeral
    localhost port: /health; /predict on si8, si64 and a batch of the two
    and si512; /ff on si64; a malformed request.  Warm ms a request
    (median of 5 after 2 warm-ups, host clock, default mode), /predict
    within 1e-5 of ``zoo.predict_structures``, then one more /ff under
    deterministic algorithms bit for bit ``Calculator.calculate``; graphs
    captured, and K1/K2 launches a request from one profiled request (a
    replay moves no counter).  Returns (row, {request: launches})."""
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    from alignn_tpu_torch.cli.serve import serve
    from alignn_tpu_torch.ff.calculator import Calculator
    from alignn_tpu_torch.zoo import predict_structures

    t0 = time.perf_counter()
    cfg = si_config()
    kw = dict(cutoff=float(cfg.get("cutoff", 8.0)),
              max_neighbors=int(cfg.get("max_neighbors", 12)))
    cells = dict((name, atoms) for name, atoms in si_cells())
    requests = {
        "predict_si8": ("/predict", {"atoms": cells["diamond8"].to_dict()}),
        "predict_si64": ("/predict",
                         {"atoms": cells["si64_rattled"].to_dict()}),
        "predict_batch": ("/predict", {"atoms_list": [
            cells[n].to_dict() for n in ("diamond8", "si64_rattled",
                                         "si512_rattled")]}),
        "ff_si64": ("/ff", {"atoms": cells["si64_rattled"].to_dict()})}
    reset_launches()
    server, service = serve(MODEL_DIR, port=0, ff=True, **kw)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    row: dict = {"model": "docs/mlearn_r4/Si", **kw}
    launches: dict = {}
    try:
        code, health = http(url + "/health")
        row["health"] = [code, health["ff"]]
        row["malformed"] = http(url + "/predict", {"bogus": 1})[0]
        if row["health"] != [200, True] or row["malformed"] != 400:
            failures.append(f"serve: /health {row['health']}, malformed "
                            f"request {row['malformed']}")
        answers, ms = {}, {}
        for name, (path, payload) in requests.items():
            times = []
            for _ in range(7):
                t = time.perf_counter()
                code, answers[name] = http(url + path, payload)
                times.append((time.perf_counter() - t) * 1e3)
                if code != 200:
                    failures.append(f"serve {name}: {code} {answers[name]}")
                    break
            ms[name] = float(np.median(times[2:]))
        # bit for bit needs index_add's fixed order on both sides
        with deterministic():
            ff = http(url + "/ff", requests["ff_si64"][1])[1]
            ref_ff = Calculator(path=MODEL_DIR).calculate(
                cells["si64_rattled"])
        ff_bitwise = ff.get("energy") == ref_ff["energy"] and \
            np.array_equal(np.asarray(ff.get("forces")), ref_ff["forces"]) \
            and np.array_equal(np.asarray(ff.get("stress")),
                               ref_ff["stress"])
        gaps = {}
        for name in ("predict_si8", "predict_si64", "predict_batch"):
            structs = [cells[n] for n in {
                "predict_si8": ["diamond8"],
                "predict_si64": ["si64_rattled"],
                "predict_batch": ["diamond8", "si64_rattled",
                                  "si512_rattled"]}[name]]
            ref = predict_structures(service.model, structs, **kw)
            got = np.asarray(answers[name].get("predictions"))
            gaps[name] = float(np.abs(got - ref).max()) \
                if got.shape == ref.shape else float("inf")
        if not ff_bitwise or not max(gaps.values()) <= 1e-5:
            failures.append(f"serve: /ff bitwise {ff_bitwise}, /predict "
                            f"gaps {gaps}")
        # one request of each kind in this thread, profiled
        for name, (path, payload) in requests.items():
            call = (lambda p=payload: service.ff(p["atoms"])) \
                if path == "/ff" else \
                (lambda p=payload: service.predict(
                    p.get("atoms_list") or [p["atoms"]]))
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            launches[name] = kernel_launches_in(prof)
        counted = read_launches()
        row.update(warm_ms_per_request=ms, ff_bitwise=ff_bitwise,
                   predict_max_abs_gap=gaps,
                   signatures=len(service.forward.loops),
                   graphs_captured=service.forward.captures,
                   launches_per_request=launches,
                   launches_counted_over_phase=counted)
        if service.forward.captures < 1 or counted["K1"] <= 0 or \
                counted["K2"] <= 0 or \
                any(launches[n]["K1"] <= 0 for n in requests):
            failures.append(f"serve: captures {service.forward.captures}, "
                            f"launches {counted}, per request {launches}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    del service, server
    torch.cuda.empty_cache()
    row["seconds"] = time.perf_counter() - t0
    return row, launches


LEGACY_CELLS = 48


def legacy_phase(failures: list) -> dict:
    """``cli.legacy`` on the card: one epoch of the ALIGNN property model
    at its defaults (4+4/256) on ``<cache>/dft_3d.json`` (48 rattled
    rocksalt cells of ``rocksalt_cells``, batch 8, 32/8/8), trained into a
    scratch directory: metrics.json, fullconfig.json and the checkpoints
    beside the config, finite losses, K1/K2 launched (counted from 0 over
    the run)."""
    import shutil

    from alignn_tpu_torch.cli import legacy
    from alignn_tpu_torch.graph.build import rocksalt_cells

    t0 = time.perf_counter()
    d = os.path.join(DP_DIR, "legacy")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(os.path.join(d, "cache"))
    records = [{"jid": f"rs-{i}", "atoms": atoms.to_dict(),
                "formation_energy_peratom": float(target)}
               for i, (atoms, target, _f) in
               enumerate(rocksalt_cells(LEGACY_CELLS))]
    write_json(os.path.join(d, "cache", "dft_3d.json"), records)
    cfg = write_json(os.path.join(d, "config.json"), {
        "dataset": "dft_3d", "target": "formation_energy_peratom",
        "epochs": 1, "batch_size": 8, "n_train": 32, "n_val": 8,
        "n_test": 8, "num_workers": 0, "model": {"name": "alignn"}})
    previous = os.environ.get("ALIGNN_TPU_DATA_CACHE")
    os.environ["ALIGNN_TPU_DATA_CACHE"] = os.path.join(d, "cache")
    reset_launches()
    try:
        hist = legacy.main([cfg, "--checkpoint_dir",
                            os.path.join(d, "scratch")])
    finally:
        if previous is None:
            del os.environ["ALIGNN_TPU_DATA_CACHE"]
        else:
            os.environ["ALIGNN_TPU_DATA_CACHE"] = previous
    launches = read_launches()
    files = sorted(os.listdir(d))
    metrics = read_json(os.path.join(d, "metrics.json"))
    row = {"files": files, "epoch_s": metrics["epoch_s"],
           "step_losses": metrics["step_losses"],
           "test_mae": metrics.get("test_mae"), "launches": launches,
           "seconds": time.perf_counter() - t0}
    need = {"metrics.json", "fullconfig.json", "best_model.mpk",
            "last_model.mpk"}
    losses = [v for ep in hist["step_losses"] for v in ep]
    if not need <= set(files) or not losses or \
            not all(np.isfinite(losses)) or launches["K1"] <= 0 or \
            launches["K2"] <= 0:
        failures.append(f"legacy: {row}")
    return row


def dp_phases(failures: list) -> tuple:
    """The phases of data parallelism, serving and the legacy CLI, each
    with its seconds.  Returns (rows, launches a DP step, launches a serve
    request)."""
    rows = {}
    rows["dp_train"], dp_launches = dp_train_phase(failures)
    # the gloo ranks start up and run beside dp_property, which times
    # nothing that this summary compares
    gloo = gloo_start()
    try:
        with nccl_world_of_one():
            rows["dp_property"] = dp_property_phase(failures)
    finally:   # waits for the ranks, or kills them at the timeout
        rows["gloo_two_ranks"] = gloo_phase(gloo, failures)
    rows["serve"], serve_launches = serve_phase(failures)
    rows["legacy"] = legacy_phase(failures)
    return rows, dp_launches, serve_launches


# ---------------------------------------------------------------------------
# graph parallelism (the ring and the dense halo), fjvp and gated_bwd
# ---------------------------------------------------------------------------

GP_DIR = os.path.join(REPO, "build", "gp")
# the ranks' logs (stages, memory, a stack dump of a rank that hangs)
GP_LOG_DIR = os.path.join(GP_DIR, "logs")
GP_STEPS = 3          # E/F/S train steps of each si512 leg
GP_ROW_CELLS = 32     # bench.py's 64 rocksalt cells, half a data row
FJVP_CELLS = 8        # si64 cells of the fjvp step (train_cli (c)'s data)
GP_TIMEOUT_S = 480    # the four ranks of the gp phase, start-up included


GP_LOG = []   # this rank's log file, once gp_rank_main opened it


def gp_log(*what):
    """A line in this rank's log: seconds, the card's peak and reserved
    GB, and `what`."""
    import torch

    if GP_LOG:
        GP_LOG[0].write(f"{time.perf_counter():.2f} "
                        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} "
                        f"{torch.cuda.memory_reserved() / 1e9:.2f} "
                        + " ".join(str(w) for w in what) + "\n")
        GP_LOG[0].flush()


def row_mesh_of(mesh):
    """The 1-D graph mesh of this rank's data row."""
    import dataclasses

    return dataclasses.replace(mesh, axis_names=("graph",), shape=(2,),
                               axes={"graph": mesh.axis("graph")})


def labelled(g, seed: int):
    """`g` with seeded energy, force and stress labels."""
    rng = np.random.default_rng(seed)
    g.target = np.array([rng.standard_normal()])
    g.forces = 0.1 * rng.standard_normal((g.num_nodes, 3))
    g.stress = 0.01 * rng.standard_normal((3, 3))
    return g


def grads_of(model) -> dict:
    return {k: p.grad.detach().cpu().clone()
            for k, p in model.named_parameters()}


def profiled(fn):
    """(launches of each kernel, device ms, collective seconds and calls)
    of one profiled call of `fn`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from alignn_tpu_torch.parallel import mesh as meshlib

    meshlib.reset_collective_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, n_ops = device_ms_by_name(prof)
    return {"launches": kernel_launches_in(prof),
            "device_ms": sum(by_name.values()), "device_ops": n_ops,
            "collective_ms": meshlib.COLLECTIVE_STATS["seconds"] * 1e3,
            "collective_calls": meshlib.COLLECTIVE_STATS["calls"],
            "collective_bytes": meshlib.COLLECTIVE_STATS["bytes"]}


def gp_si512_leg(layout: str, mesh, fails: list) -> dict:
    """One data row's two ranks on si512 (rattled 0.03 A) with
    docs/mlearn_r4/Si at full width: the ring (chain and gather mode) or
    the dense halo.  E/F/S against the one-process Calculator on the card
    (CPU_TOL), then GP_STEPS E/F/S train steps, each step's losses and
    gradients against the one-process step from the same parameters
    (TRAIN_TOL, on the row's first rank), and one step profiled."""
    import torch

    from alignn_tpu_torch.ff.calculator import Calculator
    from alignn_tpu_torch.nn.models import ALIGNNAtomWise
    from alignn_tpu_torch.parallel import dense_gp, dp_gp, graph_parallel
    from alignn_tpu_torch.parallel import mesh as meshlib
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    axis = mesh.axis("graph")
    base = Calculator(path=MODEL_DIR)
    dense = layout == "dense"
    config = {**base.config, "use_canonize": True} if dense else base.config
    calc = Calculator(model=base.model, config=config, dense=dense)
    atoms = rattled_supercell(4)
    g = labelled(calc.graph_for(atoms), 7)
    batch = calc.batch_for(g)
    row = {"layout": layout, "atoms": atoms.num_atoms,
           "edges": int(batch.src.shape[0]),
           "lg_rows": int(batch.lg_src.shape[0]), "dense_D": batch.dense_D}
    if bool(batch.dense_D) != dense:
        fails.append(f"gp_{layout}: the Calculator built the other layout")
        return row
    row["counts"] = {"e_pad": int(batch.src.shape[0]),
                     "l_pad": int(batch.lg_src.shape[0]),
                     "n_nodes": int(batch.z.shape[0]),
                     "n_graphs": int(batch.graph_mask.shape[0])}
    if dense:
        idx = dense_gp.make_dense_gp_index(batch, axis.size)
        # the halo plans of the projection's other axis sizes (host only)
        row["halo_steps"] = {
            str(d): [list(ix.node_halo.steps), list(ix.edge_halo.steps)]
            for d in (2, 4, 8)
            if not (batch.z.shape[0] % d or batch.src.shape[0] % d)
            for ix in [dense_gp.make_dense_gp_index(batch, d)]}
        row["halo_rows"] = {"node": idx.node_halo.total,
                            "edge": idx.edge_halo.total,
                            "node_steps": idx.node_halo.steps,
                            "edge_steps": idx.edge_halo.steps,
                            "node_rows_local": batch.z.shape[0] // 2,
                            "edge_rows_local": batch.src.shape[0] // 2}
    else:
        ring = graph_parallel.make_ring_index(batch, axis.size)
        row["ring_steps"] = ring.steps
    ref = calc.calculate(atoms)
    gp_log(layout, "one-process calculate")
    lead = axis.index == 0
    modes = ("chain", "gather") if not dense else ("halo",)
    for mode in modes:
        if not dense:
            os.environ["ALIGNN_TPU_GP_RING"] = mode
        make = dense_gp.make_dense_gp_forward if dense else \
            graph_parallel.make_gp_forward
        fwd = make(base.model, mesh)
        gp_calc = Calculator(model=base.model, config=config, dense=dense)
        gp_calc.forward = lambda b: dict(zip(("out", "grad", "stresses"),
                                             fwd(b)))
        gp_calc.calculate(atoms)            # warm
        torch.cuda.synchronize()
        gp_log(layout, mode, "gp calculate warm")
        reset_launches()
        meshlib.reset_collective_stats()
        t = time.perf_counter()
        got = gp_calc.calculate(atoms)
        m = {"ms": (time.perf_counter() - t) * 1e3,
             "launches": read_launches(),
             "collective_ms": meshlib.COLLECTIVE_STATS["seconds"] * 1e3}
        case = [({"cell": f"si512 gp_{layout} {mode}"}, atoms, got)]
        check_results(case, [ref], "one_process_calculator", fails)
        m.update(case[0][0])
        m["profiled"] = profiled(lambda: gp_calc.calculate(atoms))
        row[f"serve_{mode}"] = m
        row[f"audit_{mode}"] = gp_audit(base.model, mesh, batch, layout,
                                        mode, fails)
        gp_log(layout, mode, "audit")

        model = ALIGNNAtomWise(base.model.cfg).cuda()
        model.load_state_dict(base.model.state_dict())
        step = (dense_gp.make_dense_gp_train_step if dense else
                dp_gp.make_dp_gp_train_step)(model, mesh)
        state = create_train_state(model, batch,
                                   build_optimizer("adamw", 1e-3, 1e-5))
        steps = []
        for k in range(GP_STEPS):
            if lead:   # the one-process step from the same parameters
                one = ALIGNNAtomWise(base.model.cfg).cuda()
                one.load_state_dict(model.state_dict())
                one_state = create_train_state(
                    one, batch, build_optimizer("adamw", 1e-3, 1e-5))
                one_step = make_train_step(one, cuda_graph=False)
                torch.cuda.synchronize()
                t = time.perf_counter()
                _s, lo = one_step(one_state, batch)
                torch.cuda.synchronize()
                one_ms = (time.perf_counter() - t) * 1e3
                want = ({k2: float(v) for k2, v in lo.items()},
                        grads_of(one))
                if k == GP_STEPS - 1:   # its device time, once, and
                    # its forward's (the energy alone), the projection's
                    # anchor
                    def forward():
                        with torch.no_grad():
                            one(batch, batch.r)

                    row[f"one_process_{mode}"] = {
                        "ms": one_ms, "device_ms": profiled(
                            lambda: one_step(one_state, batch))[
                                "device_ms"],
                        "forward_device_ms": profiled(forward)[
                            "device_ms"]}
                del one, one_state, one_step
                torch.cuda.empty_cache()
                gp_log(layout, mode, "one-process step", k)
            torch.cuda.synchronize()
            reset_launches()
            meshlib.reset_collective_stats()
            t = time.perf_counter()
            state, lo = step(state, batch)
            torch.cuda.synchronize()
            s = {"ms": (time.perf_counter() - t) * 1e3,
                 "launches": read_launches(),
                 "collective_ms": meshlib.COLLECTIVE_STATS["seconds"] * 1e3,
                 "losses": {k2: float(v) for k2, v in lo.items()}}
            gp_log(layout, mode, "gp step", k, s["ms"])
            if lead:
                s["one_process_ms"] = one_ms
                s["vs_one_process"] = step_diff(
                    (s["losses"], grads_of(model)), want,
                    f"gp_{layout} {mode} step {k}", fails)
            steps.append(s)
        row[f"train_{mode}"] = {"steps": steps,
                                "profiled": profiled(
                                    lambda: step(state, batch))}
        del model, state, step
        torch.cuda.empty_cache()
    os.environ.pop("ALIGNN_TPU_GP_RING", None)
    need = ("K3", "K4", "K5a", "K5b") if dense else ("K2",)
    for mode in modes:
        counts = row[f"train_{mode}"]["profiled"]["launches"]
        if any(counts[k] <= 0 for k in need):
            fails.append(f"gp_{layout} {mode}: a train step on rank "
                         f"{mesh.rank} launched {counts}, needs {need}")
    return row


def gp_audit(model, mesh, batch, layout: str, mode: str,
             fails: list) -> dict:
    """One recorded and profiled E/F/S forward of the leg
    (``collective_audit.audit_gp_forward``): shift counts and bytes by
    phase against the analytic model of this batch's e_pad (or halo
    plan), dtype and axis size, to the byte; the forward ring payloads'
    overlap verdict; the reverse's chain links; the profiler's overlap
    finding; its E/F/S against the unrecorded forward's (CPU_TOL)."""
    from alignn_tpu_torch.parallel import collective_audit as ca
    from alignn_tpu_torch.parallel import dense_gp, graph_parallel

    t = time.perf_counter()
    r = ca.audit_gp_forward(model, mesh, batch, "dense" if layout ==
                            "dense" else "ring")
    out = {**ca.summary_json(r), "seconds": time.perf_counter() - t}
    plain = (dense_gp.make_dense_gp_forward if layout == "dense" else
             graph_parallel.make_gp_forward)(model, mesh)(batch)
    out["vs_unrecorded"] = diff = {
        k: float((a - b).abs().max())
        for k, a, b in zip(("out", "forces", "stress"), r["outputs"], plain)}
    if not (diff["forces"] <= CPU_TOL["forces"]
            and diff["stress"] <= CPU_TOL["stress"]):
        fails.append(f"gp_{layout} {mode} audit: the recorded forward "
                     f"differs from the unrecorded one by {diff}")
    if not r["bytes_match"]:
        fails.append(f"gp_{layout} {mode} audit: shift bytes "
                     f"{r['summary']} differ from the analytic "
                     f"{r['expected']}")
    if layout != "dense" and r["summary"]["forward_overlap_capable"] \
            is not True:
        fails.append(f"gp_{layout} {mode} audit: a forward ring payload "
                     f"depends on its stage's segment sum: "
                     f"{r['exchanges']}")
    if r["summary"]["transpose_chain_links"] is None:
        fails.append(f"gp_{layout} {mode} audit: no reverse structure "
                     f"recorded")
    return out


def gp_2d_legs(mesh, fails: list) -> dict:
    """The 2 x 2 (data, graph) legs on bench.py's 64 rocksalt cells (32 a
    data row), bench.py's model (f32, seeded): one data x dense-halo step
    and one data x ring step, each against the mean of the two rows'
    one-process steps (on rank 0)."""
    import torch

    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.graph.dense import (dense_batch_graphs,
                                              dense_spec_for_graphs)
    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig,
                                            init_parameters)
    from alignn_tpu_torch.parallel import dense_gp, dp_gp
    from alignn_tpu_torch.parallel import mesh as meshlib
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import create_train_state

    graphs = rocksalt_b64()
    rows = [graphs[:GP_ROW_CELLS], graphs[GP_ROW_CELLS:2 * GP_ROW_CELLS]]
    weights = init_parameters(ALIGNNAtomWise(ALIGNNAtomWiseConfig(
        **TRAIN_CFG)), torch.Generator().manual_seed(0)).state_dict()
    dev = torch.device("cuda")
    out = {}
    for layout in ("dense", "sparse"):
        if layout == "dense":
            spec = dense_spec_for_graphs(graphs, GP_ROW_CELLS)
            batches = [dense_batch_graphs(r, spec, dev) for r in rows]
            make = dense_gp.make_dp_dense_gp_train_step
        else:
            spec = BucketSpec.for_graphs(graphs, GP_ROW_CELLS)
            batches = [batch_graphs(r, spec, dev) for r in rows]
            make = dp_gp.make_dp_gp_train_step
        batch = batches[mesh.axis("data").index]
        model = ALIGNNAtomWise(ALIGNNAtomWiseConfig(**TRAIN_CFG)).cuda()
        model.load_state_dict(weights)
        state = create_train_state(model, batch,
                                   build_optimizer("adamw", 1e-3, 1e-5))
        step = make(model, mesh)
        torch.cuda.synchronize()
        reset_launches()
        meshlib.reset_collective_stats()
        t = time.perf_counter()
        state, lo = step(state, batch)
        torch.cuda.synchronize()
        row = {"ms": (time.perf_counter() - t) * 1e3,
               "launches": read_launches(),
               "collective_ms": meshlib.COLLECTIVE_STATS["seconds"] * 1e3,
               "losses": {k: float(v) for k, v in lo.items()}}
        first_grads = grads_of(model)
        meshlib.reset_collective_stats()
        t = time.perf_counter()
        step(state, batch)     # the second step, warm
        torch.cuda.synchronize()
        row["ms_second_step"] = (time.perf_counter() - t) * 1e3
        row["collective_ms_second_step"] = \
            meshlib.COLLECTIVE_STATS["seconds"] * 1e3
        if mesh.rank == 0:
            firsts = [first_step(weights, b) for b in batches]
            mean = ({k: (firsts[0][0][k] + firsts[1][0][k]) / 2
                     for k in firsts[0][0]},
                    {k: (firsts[0][1][k] + firsts[1][1][k]) / 2
                     for k in firsts[0][1]})
            row["vs_mean_one_process"] = step_diff(
                (row["losses"], first_grads), mean,
                f"gp_2d {layout}", fails)
        row["params_sha256"] = digest_params(model)
        need = ("K3", "K4", "K5a", "K5b") if layout == "dense" else ("K2",)
        if any(row["launches"][k] <= 0 for k in need):
            fails.append(f"gp_2d {layout}: rank {mesh.rank} launched "
                         f"{row['launches']}, needs {need}")
        out[layout] = row
        gp_log("2d", layout, row["ms"])
        del model, state, step
        torch.cuda.empty_cache()
    return out


def digest_params(model) -> str:
    import hashlib

    return hashlib.sha256(b"".join(
        v.detach().cpu().numpy().tobytes()
        for v in model.state_dict().values())).hexdigest()


def gp_rank_main(rank: int, port: int, out: str) -> int:
    """One of four gloo ranks sharing cuda:0 (``--gp-rank``), a
    ("data", "graph") mesh of shape (2, 2): data row 0 runs the si512
    ring and halo legs (:func:`gp_si512_leg`) while row 1 waits, then all
    four run :func:`gp_2d_legs`.  Writes its numbers to
    `out`/rank<r>.json."""
    import torch
    import torch.distributed as dist

    from alignn_tpu_torch.parallel.mesh import (initialize_distributed,
                                                make_mesh, shift_transport)

    import faulthandler

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(2)    # four ranks on the host's 8 cores
    os.makedirs(GP_LOG_DIR, exist_ok=True)
    GP_LOG.append(open(os.path.join(GP_LOG_DIR, f"rank{rank}.log"), "w"))
    faulthandler.dump_traceback_later(GP_TIMEOUT_S - 60, file=GP_LOG[0])
    initialize_distributed(f"localhost:{port}", 4, rank, device="cuda",
                           backend="gloo")
    gp_log("joined")
    fails: list = []
    result: dict = {"rank": rank}
    try:
        mesh = make_mesh(4, ("data", "graph"), (2, 2))
        result["transport"] = shift_transport(
            torch.zeros(1, device="cuda"), mesh.axis("graph").group)
        t = time.perf_counter()
        if mesh.axis("data").index == 0:
            row_mesh = row_mesh_of(mesh)
            result["gp_ring"] = gp_si512_leg("sparse", row_mesh, fails)
            result["gp_dense"] = gp_si512_leg("dense", row_mesh, fails)
        result["si512_seconds"] = time.perf_counter() - t
        dist.barrier()
        t = time.perf_counter()
        result["gp_2d"] = gp_2d_legs(mesh, fails)
        result["gp_2d_seconds"] = time.perf_counter() - t
    finally:
        result["failures"] = fails
        write_json(os.path.join(out, f"rank{rank}.json"), result)
        dist.destroy_process_group()
    return 0


def gp_p2p_rank(rank: int, port: int) -> int:
    """``--gp-p2p``: whether gloo's send/recv takes CUDA tensors (two
    ranks; rank 1 prints what arrived).  Run apart from everything: gloo
    reads the send buffer as host memory."""
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    try:
        x = torch.full((4,), float(rank + 1), device="cuda")
        if rank == 0:
            dist.send(x, 1)
        else:
            dist.recv(x, 0)
            print(json.dumps({"received": x.cpu().tolist()}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def gp_p2p_probe() -> dict:
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--gp-p2p", str(r),
         str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=90)[0].decode(
                errors="replace"))
    except subprocess.TimeoutExpired:
        logs.append("timeout")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ok = all(p.returncode == 0 for p in procs) and \
        '"received": [1.0, 1.0, 1.0, 1.0]' in logs[1]
    return {"gloo_p2p_takes_cuda": ok,
            "returncodes": [p.returncode for p in procs],
            "log_tail": [log[-300:] for log in logs]}


def gp_phase(failures: list) -> dict:
    """The four gloo ranks of :func:`gp_rank_main`, bounded by a hard
    timeout: the ring and halo legs (gp_ring, gp_dense) and the 2 x 2
    legs (gp_2d), their failures, and the four ranks' parameters bit for
    bit after each 2 x 2 step."""
    import shutil

    out = os.path.join(GP_DIR, "ranks")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    os.makedirs(GP_LOG_DIR, exist_ok=True)
    t0 = time.perf_counter()
    port = free_port()
    logs = [open(os.path.join(GP_LOG_DIR, f"rank{r}.out"), "w")
            for r in range(4)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--gp-rank", str(r),
         str(port), out], stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(4)]
    try:   # a failed rank ends the others at once (they would wait in a
        # collective); all end by the deadline
        while time.perf_counter() - t0 < GP_TIMEOUT_S and \
                any(p.poll() is None for p in procs) and \
                not any(p.poll() for p in procs):
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    logs = [open(f.name).read() for f in logs]
    rows = {"seconds": time.perf_counter() - t0}
    got = [read_json(os.path.join(out, f"rank{r}.json"))
           if os.path.exists(os.path.join(out, f"rank{r}.json")) else None
           for r in range(4)]
    if any(p.returncode != 0 for p in procs) or None in got:
        failures.append("gp: a rank failed: " + " | ".join(
            log[-2000:] for log in logs))
        return rows
    for r in got:
        failures.extend(r["failures"])
    rows["transport"] = got[0]["transport"]
    rows["gp_ring"] = {f"rank{r}": got[r]["gp_ring"] for r in (0, 1)}
    rows["gp_dense"] = {f"rank{r}": got[r]["gp_dense"] for r in (0, 1)}
    rows["gp_2d"] = {f"rank{r}": got[r]["gp_2d"] for r in range(4)}
    rows["rank_seconds"] = [(r["si512_seconds"], r["gp_2d_seconds"])
                            for r in got]
    for layout in ("dense", "sparse"):
        shas = {r["gp_2d"][layout]["params_sha256"] for r in got}
        if len(shas) != 1:
            failures.append(f"gp_2d {layout}: the four ranks' parameters "
                            f"differ after the step")
    rows["link_projection"] = link_projection_rows(got[0], failures)
    return rows


GP_ANCHOR = os.path.join(GP_DIR, "link_anchor.json")


def link_projection_rows(rank0: dict, failures: list) -> dict:
    """The anchor of ``parallel.link_projection`` from rank 0's si512
    legs (the one-process train step's and forward's device ms, sparse
    and dense, the batch's counts, the audits at the legs' axis size and
    the halo plans of 2, 4 and 8 ranks), written to GP_ANCHOR, and the
    projection's rows: each a projection from a published bandwidth, not
    a measurement."""
    from alignn_tpu_torch.parallel import link_projection as lp

    ring, dense = rank0["gp_ring"], rank0["gp_dense"]
    with open(os.path.join(MODEL_DIR, "config.json")) as f:
        mcfg = json.load(f)["model"]
    anchor = {
        "card": smi_line(), "cell": "si512_rattled",
        "model": "docs/mlearn_r4/Si", "buf_bytes": 4,
        "hidden": mcfg["hidden_features"],
        "alignn_layers": mcfg["alignn_layers"],
        "gcn_layers": mcfg["gcn_layers"],
        "counts": {**ring["counts"],
                   "dense_n_nodes": dense["counts"]["n_nodes"]},
        "anchors": {
            layout: {"t1_ms": leg[f"one_process_{mode}"]["device_ms"],
                     "fwd_ms": leg[f"one_process_{mode}"][
                         "forward_device_ms"],
                     "what": "one-process E/F/S train step and energy "
                             "forward, device ms (torch.profiler)"}
            for layout, leg, mode in (("sparse", ring, "chain"),
                                      ("dense", dense, "halo"))},
        "audit_devices": ring["audit_chain"]["devices"],
        "audit": {"chain": ring["audit_chain"]["summary"],
                  "gather": ring["audit_gather"]["summary"],
                  "halo": dense["audit_halo"]["summary"]},
        "halo_steps": dense["halo_steps"]}
    write_json(GP_ANCHOR, anchor)
    rows = lp.projection_rows(anchor)
    if not rows or any(r["what"] != lp.LABEL for r in rows):
        failures.append("link_projection: no labelled rows")
    return {"anchor": GP_ANCHOR, "label": lp.LABEL, "links": lp.LINKS,
            "rows": rows}


def fjvp_phase(failures: list) -> dict:
    """train_cli (c)'s FF config (docs/mlearn_r4/Si, full width) on
    FJVP_CELLS labelled si64 cells: the fjvp step against the standard
    step on the card (losses and gradients, TRAIN_TOL), both steps' wall
    and device ms; then each forward-mode rule against ``torch.func.jvp``
    of its plain version on the card."""
    import torch

    from alignn_tpu_torch.ff.calculator import Calculator
    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.nn.models import ALIGNNAtomWise
    from alignn_tpu_torch.train.fjvp import make_train_step_fjvp
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    t0 = time.perf_counter()
    base = Calculator(path=MODEL_DIR)
    graphs = []
    for seed in range(FJVP_CELLS):
        sc = diamond().make_supercell([2, 2, 2])
        cart = sc.cart_coords + np.random.default_rng(seed).normal(
            0.0, 0.05, sc.cart_coords.shape)
        from alignn_tpu_torch.chem.atoms import Atoms

        atoms = Atoms(lattice_mat=sc.lattice_mat,
                      frac_coords=cart @ np.linalg.inv(sc.lattice_mat),
                      elements=sc.elements)
        graphs.append(labelled(base.graph_for(atoms), 100 + seed))
    batch = batch_graphs(graphs, BucketSpec.tight_for_batch(graphs),
                         torch.device("cuda"))
    weights = base.model.state_dict()
    row = {"config": "docs/mlearn_r4/Si", "cells": FJVP_CELLS,
           "edges": int(batch.src.shape[0]),
           "lg_rows": int(batch.lg_src.shape[0])}
    results = {}
    for name, make in (("standard", lambda m: make_train_step(
            m, cuda_graph=False)), ("fjvp", make_train_step_fjvp)):
        model = ALIGNNAtomWise(base.model.cfg).cuda()
        model.load_state_dict(weights)
        state = create_train_state(model, batch,
                                   build_optimizer("adamw", 1e-3, 1e-5))
        step = make(model)
        reset_launches()
        _s, lo = step(state, batch)
        first = ({k: float(v) for k, v in lo.items()}, grads_of(model))
        launches = read_launches()
        times = []
        for _ in range(3):
            model.load_state_dict(weights)
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        prof = profiled(lambda: step(state, batch))
        results[name] = first
        row[name] = {"ms": float(np.median(times)), "ms_runs": times,
                     "device_ms": prof["device_ms"],
                     "device_ops": prof["device_ops"],
                     "launches_first_step": launches,
                     "launches_profiled": prof["launches"],
                     "losses": first[0]}
        if any(launches[k] <= 0 for k in ("K1", "K2")):
            failures.append(f"fjvp {name}: launches {launches}")
        del model, state, step
        torch.cuda.empty_cache()
    row["fjvp_vs_standard"] = step_diff(results["fjvp"],
                                        results["standard"],
                                        "fjvp vs standard", failures)
    if row["standard"]["device_ms"] > 0:
        row["device_ms_ratio"] = row["fjvp"]["device_ms"] / \
            row["standard"]["device_ms"]
    row["jvp_rules"] = jvp_rules_on_card(batch, failures)
    row["seconds"] = time.perf_counter() - t0
    return row


def jvp_rules_on_card(batch, failures: list) -> dict:
    """Each forward-mode rule (the kernels for primal and tangent) against
    ``torch.func.jvp`` of its plain version, f32, on the card: K1/K2 and
    the gathers at the fjvp batch's L-stage segments (F 256), K3/K4 at
    D 13, F 256, 64 nodes."""
    import torch
    from torch.autograd import forward_ad

    from alignn_tpu_torch.ops import dense as od
    from alignn_tpu_torch.ops import eggc as oe

    gen = torch.Generator(device="cuda").manual_seed(5)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    lg = batch.lg_index
    seg, rows, f, D, n = lg.dst, lg.dst.ids.shape[0], 256, 13, 64
    e = batch.src.shape[0]
    rules = {
        "K1": (lambda m, bh: oe.gated_aggregate(m, bh, seg),
               lambda m, bh: oe.gated_aggregate_plain(m, bh, seg),
               (rand(rows, f), rand(rows, f))),
        "K2": (lambda x: oe.sorted_segment_sum(x, seg),
               lambda x: oe.sorted_segment_sum_plain(x, seg),
               (rand(rows, f),)),
        "sorted_gather": (lambda x: oe.sorted_gather(x, seg),
                          lambda x: x[seg.ids], (rand(e, f),)),
        "gather_nodes": (
            lambda x: oe.gather_nodes(x, lg.src, lg.src_perm,
                                      lg.src_perm_inv, lg.src_sorted),
            lambda x: x[lg.src], (rand(e, f),)),
        "permute_rows": (
            lambda x: oe.permute_rows(x, lg.src_perm, lg.src_perm_inv),
            lambda x: x[lg.src_perm], (rand(rows, f),)),
        "K3": (lambda m, bh: od.dense_gated_aggregate(m, bh, D),
               lambda m, bh: od.dense_gated_aggregate_plain(m, bh, D),
               (rand(n * D, f), rand(n * D, f))),
        "K4": (lambda m2, bh: od.dense_pair_aggregate(m2, bh, D),
               lambda m2, bh: od.dense_pair_aggregate_plain(m2, bh, D),
               (rand(n * D * D, f), rand(n * D, f))),
    }
    out = {}
    for name, (op, plain, primals) in rules.items():
        tangents = tuple(rand(*x.shape) for x in primals)
        _o, want = torch.func.jvp(plain, primals, tangents)
        reset_launches()
        with forward_ad.dual_level():
            duals = [forward_ad.make_dual(x, t)
                     for x, t in zip(primals, tangents)]
            got = forward_ad.unpack_dual(op(*duals)).tangent
        torch.cuda.synchronize()
        out[name] = {**compare(got, want, "float32", failures,
                               f"jvp rule {name}"),
                     "launches": {k: v for k, v in read_launches().items()
                                  if v}}
    return out


def gated_bwd_phase(failures: list) -> dict:
    """bench.py's dense E/F/S step (f32, seeded, the first 16 rocksalt
    cells) with ``ALIGNN_TPU_GATED_BWD_OP=1`` against without it on the
    card: the first step's losses and gradients (TRAIN_TOL), and each
    way's eager step (median ms of 3 after a warm-up, device ms of one
    profiled step)."""
    import torch

    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig,
                                            init_parameters)
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    t0 = time.perf_counter()
    weights = init_parameters(ALIGNNAtomWise(ALIGNNAtomWiseConfig(
        **TRAIN_CFG)), torch.Generator().manual_seed(0)).state_dict()
    batch = train_batches(rocksalt_b64()[:16],
                          torch.device("cuda"))["dense"]
    row = {"cells": 16}
    firsts = {}
    for name in ("off", "on"):
        ctx = switch_env("ALIGNN_TPU_GATED_BWD_OP") if name == "on" \
            else contextlib.nullcontext()
        with ctx:
            firsts[name] = first_step(weights, batch)
            model = ALIGNNAtomWise(ALIGNNAtomWiseConfig(**TRAIN_CFG)).cuda()
            model.load_state_dict(weights)
            state = create_train_state(model, batch,
                                       build_optimizer("adamw", 1e-3, 1e-5))
            step = make_train_step(model, cuda_graph=False)
            step(state, batch)                 # warm
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                step(state, batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            row[name] = {"ms": float(np.median(times)), "ms_runs": times,
                         "device_ms": profiled(
                             lambda: step(state, batch))["device_ms"]}
            del model, state, step
    row["on_vs_off"] = step_diff(firsts["on"], firsts["off"],
                                 "gated_bwd on vs off", failures)
    row["seconds"] = time.perf_counter() - t0
    return row


def gp_phases(failures: list) -> dict:
    """The graph-parallel phases (gp_transport, gp: gp_ring, gp_dense and
    gp_2d), then fjvp and gated_bwd, each with its seconds."""
    rows = {}
    t = time.perf_counter()
    rows["gp_transport"] = {**gp_p2p_probe(),
                            "seconds": time.perf_counter() - t}
    rows["gp"] = gp_phase(failures)
    rows["fjvp"] = fjvp_phase(failures)
    rows["gated_bwd"] = gated_bwd_phase(failures)
    return rows


def gp_launches(rows: dict) -> dict:
    """{leg: launches of each kernel} of the GP phases: rank 0's profiled
    train step of each si512 leg and its 2 x 2 steps, and fjvp's first
    step."""
    gp = rows.get("gp", {})
    out = {}
    for leg, modes in (("gp_ring", ("chain", "gather")),
                       ("gp_dense", ("halo",))):
        for mode in modes:
            r0 = gp.get(leg, {}).get("rank0", {})
            if f"train_{mode}" in r0:
                out[f"{leg}_{mode}_rank0"] = \
                    r0[f"train_{mode}"]["profiled"]["launches"]
    for layout, r in gp.get("gp_2d", {}).get("rank0", {}).items():
        out[f"gp_2d_{layout}_rank0"] = r["launches"]
    if "fjvp" in rows:
        out["fjvp_step"] = rows["fjvp"]["fjvp"]["launches_first_step"]
    return out


def gp_probe() -> int:
    """``--gp``: the kernels built, then :func:`gp_phases` alone; no
    ``{"ok"}`` line."""
    from alignn_tpu_torch import _build

    print(smi_line(), flush=True)
    _build.build_all()
    failures: list = []
    rows = gp_phases(failures)
    for name, row in rows.items():
        emit({"phase": name, **row})
    emit({"launches_gp": gp_launches(rows)})
    for msg in failures:
        print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    return 1 if failures else 0


def order_probe() -> int:
    """``--bf16-order``: bench.py's E/F/S step (bf16, dense, 64 rocksalt
    cells), forward and backward, eager, under deterministic algorithms,
    three times in this process from the same weights; for each pair of
    runs whether the aten operations came in the same order, where they
    first part, and whether the forward's outputs and the gradients agree
    bit for bit.  The reason :func:`dp_train_run` compares fresh
    processes.  No ``{"ok"}`` line."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from alignn_tpu_torch import _build
    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig,
                                            atomwise_forward,
                                            init_parameters)

    class Order(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    print(smi_line(), flush=True)
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    weights = init_parameters(ALIGNNAtomWise(ALIGNNAtomWiseConfig(
        **TRAIN_CFG)), torch.Generator().manual_seed(0)).state_dict()
    batch = train_batches(rocksalt_b64(), torch.device("cuda"))["dense"]
    runs = []
    with deterministic():
        for _ in range(3):
            model = ALIGNNAtomWise(ALIGNNAtomWiseConfig(**TRAIN_CFG),
                                   dtype=torch.bfloat16).cuda()
            model.load_state_dict(weights)
            model.train()
            order = Order()
            with order:
                res = atomwise_forward(model, batch, create_graph=True)
                loss = res["out"].float().sum() + \
                    res["grad"].float().pow(2).sum()
                loss.backward()
            runs.append((order.ops, res["out"].detach().clone(),
                         res["grad"].detach().clone(),
                         [p.grad.clone() for p in model.parameters()
                          if p.grad is not None]))
    for i, j in ((0, 1), (1, 2), (0, 2)):
        a, b = runs[i], runs[j]
        part = next((k for k, (x, y) in enumerate(zip(a[0], b[0]))
                     if x != y), None)
        emit({"phase": "bf16_order", "runs": [i, j], "ops": len(a[0]),
              "order_parts_at": part,
              "op_there": None if part is None else [a[0][part],
                                                     b[0][part]],
              "forward_bitwise": bool(torch.equal(a[1], b[1])
                                      and torch.equal(a[2], b[2])),
              "gradients_differing": sum(
                  not torch.equal(x, y) for x, y in zip(a[3], b[3])),
              "gradients": len(a[3])})
    return 0


def dp_probe() -> int:
    """``--dp``: the kernels built, then the phases of :func:`dp_phases`
    alone (the property run writes its own folder); no ``{"ok"}`` line."""
    from alignn_tpu_torch import _build

    print(smi_line(), flush=True)
    _build.build_all()
    failures: list = []
    rows, dp_launches, serve_launches = dp_phases(failures)
    for name, row in rows.items():
        emit({"phase": name, **row})
    emit({"launches_per_dp_step": dp_launches,
          "launches_per_serve_request": serve_launches})
    for msg in failures:
        print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    return 1 if failures else 0


def main() -> int:
    import torch

    args = sys.argv[1:]
    if "--root" in args:   # import the port from another checkout
        sys.path.insert(0, os.path.abspath(args[args.index("--root") + 1]))
    if "--scripts-cpu" in args:  # the CPU port's side of the scripts phase
        return scripts_cpu_main(args[args.index("--scripts-cpu") + 1])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 2
    if "--gloo-rank" in args:   # a rank of the gloo phase's two
        i = args.index("--gloo-rank")
        return gloo_rank_main(int(args[i + 1]), int(args[i + 2]),
                              args[i + 3])
    if "--dp-train" in args:    # one side of the dp_train phase
        i = args.index("--dp-train")
        return dp_train_run(args[i + 1], args[i + 2])
    if "--segments" in args:
        return segments_probe()
    if "--pairs" in args:
        return pairs_probe("--steps" in args)
    if "--gp-rank" in args:     # a rank of the gp phase's four
        i = args.index("--gp-rank")
        return gp_rank_main(int(args[i + 1]), int(args[i + 2]),
                            args[i + 3])
    if "--gp-p2p" in args:      # a rank of the gloo send/recv probe
        i = args.index("--gp-p2p")
        return gp_p2p_rank(int(args[i + 1]), int(args[i + 2]))
    if "--dp" in args:
        return dp_probe()
    if "--gp" in args:
        return gp_probe()
    if "--scripts" in args:
        return scripts_probe()
    if "--bf16-order" in args:
        return order_probe()
    from alignn_tpu_torch import _build
    from alignn_tpu_torch.ff.calculator import Calculator
    from alignn_tpu_torch.graph.batch import batch_graphs

    # the card, probed in a fresh process before the first phase; a
    # transient failure is retried there, each retry on a line of its own
    from alignn_tpu_torch.backend_retry import (ProbesExhausted,
                                                probe_devices_subprocess,
                                                retry_transient)

    t = time.perf_counter()
    try:
        retry_transient(probe_devices_subprocess, timeout_s=180.0,
                        attempts=3, backoffs=(10, 20),
                        log=lambda m: emit({"phase": "backend_probe",
                                            "retry": m}))
    except Exception as e:
        raise ProbesExhausted(f"the card failed its probes: "
                              f"{type(e).__name__}: {e}") from e
    emit({"phase": "backend_probe", "seconds": time.perf_counter() - t})
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
    emit({"phase": "ptxas_k5", "kernels": k5_ptxas(_build.build_log("dense"))})
    eggc_ptxas = ptxas_kernels(_build.build_log("eggc"))
    emit({"phase": "ptxas_eggc", "kernels": eggc_ptxas})
    from alignn_tpu_torch.ops import dense as dk

    # dense.cu's sigmoid (a select below -88.75) against the exact one on
    # every f32 bit pattern
    mismatches = dk.sigmoid_mismatches()
    emit({"phase": "sigmoid_select", "f32_patterns": 1 << 32,
          "mismatches": mismatches})
    if mismatches:
        failures.append(f"dense.cu sigmoid differs from 1 / (1 + exp(-x)) "
                        f"on {mismatches} f32 bit patterns")

    base = Calculator(path=MODEL_DIR)            # default device: cuda
    canon = {**base.config, "use_canonize": True}

    def new_calc():
        return Calculator(model=base.model, config=base.config)

    def new_dense_calc():
        return Calculator(model=base.model, config=canon, dense=True)

    def new_canon_sparse_calc():
        return Calculator(model=base.model, config=canon, dense=False)

    calc = new_calc()
    g = calc.graph_for(rattled_supercell(4))
    batch = batch_graphs([g], calc.bucket_for(g), calc.device)
    kernels = kernel_phase(batch.lg_index.dst, failures)
    shape = kernels.pop("shape")
    del batch
    dcalc = new_dense_calc()
    dbatch = dcalc.batch_for(dcalc.graph_for(rattled_supercell(4)))
    if not dbatch.dense_D:
        failures.append("si512_rattled: the dense Calculator built a "
                        "sparse batch")
    else:
        dshape = dense_shape(dbatch)
        kernels.update(dense_kernel_phase(dbatch, failures))
        kernels.update(fused_kernel_phase(dbatch, failures))
    del dbatch
    torch.cuda.empty_cache()

    cpu_base = Calculator(path=MODEL_DIR, device="cpu")

    # sparse slice: counts from 0 over its three cells
    reset_launches()
    rows = run_cells(new_calc, si_cells(), "sparse", failures)
    sparse_launches = read_launches()
    check_against(rows[:2], lambda: cpu_base, "cpu_port", failures)
    for row, _a, _r in rows:
        emit({"phase": "slice", **row})

    # dense slice: counts from 0 over its three cells
    reset_launches()
    drows = run_cells(new_dense_calc, si_cells(), "dense", failures)
    dense_launches = read_launches()
    check_against(drows, new_canon_sparse_calc, "sparse_on_card", failures)
    check_against(drows[:2], lambda: Calculator(
        model=cpu_base.model, config=canon, dense=True, device="cpu"),
        "cpu_port", failures)
    for row, _a, _r in drows:
        emit({"phase": "dense_slice", **row})

    # fused dense slice (ALIGNN_TPU_FUSED_LSTAGE=1): counts from 0 over its
    # three cells
    frows, fused_launches = fused_slice(
        new_dense_calc, drows, lambda: Calculator(
            model=cpu_base.model, config=canon, dense=True, device="cpu"),
        failures)
    for row, _a, _r in frows:
        emit({"phase": "fused_slice", **row})
    emit({"phase": "batch", **batch_phase(base.model, failures)})
    torch.cuda.empty_cache()

    # training: counts from 0 over each layout's 12 steps
    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig,
                                            init_parameters)

    graphs = rocksalt_b64()
    weights = init_parameters(ALIGNNAtomWise(ALIGNNAtomWiseConfig(
        **TRAIN_CFG)), torch.Generator().manual_seed(0)).state_dict()
    train_row, train_launches, train_kernels, train_shape, first = \
        train_phase(weights, graphs, failures)
    emit({"phase": "train", **train_row})
    with switch_env(FUSED_ENV):
        fused_row, train_launches["fused"] = fused_train_phase(
            weights, graphs, first["dense"], failures)
    emit({"phase": "fused_train", **fused_row})

    # the windowed sparse path (ALIGNN_TPU_ENABLE_WGATHER=1): K8 at the
    # training batch's gathers, then serving the batch, training on it
    # (counts from 0 over its 12 steps) and one loader epoch
    gbatch = train_batches(graphs, torch.device("cuda"))["sparse"]
    kernels["K8"] = gather_kernel_phase(gbatch, failures)
    del gbatch
    emit({"phase": "wgather_batch",
          **wgather_batch_phase(base.model, cpu_base.model, failures)})
    torch.cuda.empty_cache()
    with switch_env(WGATHER_ENV):
        wtrain_row, train_launches["wsparse"] = wgather_train_phase(
            weights, graphs, first["sparse"], failures)
    emit({"phase": "wgather_train", **wtrain_row})
    with switch_env(WGATHER_ENV):
        emit({"phase": "loader", **loader_phase(weights, failures)})
    torch.cuda.empty_cache()

    # the envelope-weighted potentials: serving (counts from 0 over its
    # four cells), then training (counts from 0 over its 12 steps)
    erows, envelope_launches, envelope_k2 = envelope_slice(failures)
    for row, _a, _r in erows:
        emit({"phase": "envelope_slice", **row})
    torch.cuda.empty_cache()
    erow, train_launches["envelope"] = envelope_train_phase(failures)
    emit({"phase": "envelope_train", **erow})
    torch.cuda.empty_cache()

    # the compute dtypes, remat and the fp8 L-tables on the same cells:
    # counts from 0 over each run's 12 steps
    t = time.perf_counter()
    prec_rows, precision_launches = precision_phase(
        weights, graphs, {"dense": train_row["dense"],
                          "sparse": train_row["sparse"],
                          "fused": fused_row["fused"],
                          "wsparse": wtrain_row["wsparse"],
                          "envelope": erow["envelope"]},
        dict(first), failures)
    for row in prec_rows.values():
        emit({"phase": "precision", **row})
    emit({"phase": "precision", "part": "total",
          "seconds": time.perf_counter() - t})

    # the C++ neighbour list, the FF tasks, the on-device MD and FIRE loops
    env_calc = Calculator(path=ENVELOPE_DIRS["Si"])
    cu_calc = Calculator(path=ENVELOPE_DIRS["Cu"])
    knn_calc = new_calc()
    for row in native_graph_phase(
            {"knn": (base.model, base.config),
             "radius": (env_calc.model, env_calc.config),
             "cu": (cu_calc.model, cu_calc.config)}, failures):
        emit({"phase": "native_graph", **row})
    emit({"phase": "ff_science",
          **ff_science_phase(env_calc, knn_calc, failures)})
    md = md_device_phase(env_calc, knn_calc, failures)
    emit({"phase": "md_device", **md})
    emit({"phase": "relax_device", **relax_device_phase(env_calc, failures)})
    del env_calc, cu_calc, knn_calc
    torch.cuda.empty_cache()

    # folder training through the CLIs: counts from 0 over each run
    t = time.perf_counter()
    cli_rows, property_launches = train_cli_phase(failures)
    for name, row in cli_rows.items():
        emit({"phase": "train_cli", "part": name, **row})
    emit({"phase": "train_cli", "part": "total",
          "seconds": time.perf_counter() - t})

    # the model families: counts from 0 over each run
    t = time.perf_counter()
    family_rows, family_launches = model_families_phase(failures)
    for name, row in family_rows.items():
        emit({"phase": "model_families", "part": name, "rows": row}
             if isinstance(row, list) else
             {"phase": "model_families", "part": name, **row})
    emit({"phase": "model_families", "part": "total",
          "seconds": time.perf_counter() - t})

    # the campaign scripts on train_cli's inputs: counts from 0 over each
    # script run
    script_rows, script_launches = scripts_phase(failures)
    for name, row in script_rows.items():
        emit({"phase": "scripts", "part": name, "row": row}
             if not isinstance(row, dict) else
             {"phase": "scripts", "part": name, **row})
    torch.cuda.empty_cache()

    # data parallelism (NCCL at world size 1, two gloo ranks), the
    # server and the legacy CLI: counts from 0 over each run
    t = time.perf_counter()
    dp_rows, dp_launches, serve_launches = dp_phases(failures)
    for name, row in dp_rows.items():
        emit({"phase": name, **row})
    emit({"phase": "dp_serve_legacy", "part": "total",
          "seconds": time.perf_counter() - t})

    # graph parallelism (four gloo ranks on cuda:0), the forward-over-
    # reverse step and the opt-in gated_aggregate_bwd: counts from 0 over
    # each leg
    t = time.perf_counter()
    gp_rows = gp_phases(failures)
    for name, row in gp_rows.items():
        emit({"phase": name, **row})
    gp_counts = gp_launches(gp_rows)
    emit({"phase": "gp_fjvp_gated_bwd", "part": "total",
          "seconds": time.perf_counter() - t})

    line = []
    for key, name, source, replaces in KERNELS:
        r = kernels.get(key)
        if r is None:
            continue
        dense = key in DENSE_KERNELS
        # K5b runs only in training: its count, numbers and shape are the
        # dense train step's; the other dense kernels' are the si512 cell's,
        # K6's and K7's counts those of the fused slice
        if key == "K5b":
            r, launches, kshape = train_kernels[key], \
                {key: train_launches["dense"][key] * 12}, train_shape
        elif key == "K8":
            # K8 runs only on windowed batches: its count is the windowed
            # train step's (12 steps), its numbers the L-stage gathers'
            launches, kshape = {key: train_launches["wsparse"][key] * 12}, \
                r["float32"]["shape"]
        else:
            launches = fused_launches if key in ("K6", "K7") else \
                dense_launches if dense else sparse_launches
            kshape = dshape if dense else shape
        f32 = r["float32"]
        line.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches[key],
            "launches_envelope_slice": envelope_launches[key],
            "launches_per_md_step": {
                layout: md["chunks"][layout]["launches_per_step"][key]
                for layout in ("sparse", "dense", "envelope")},
            "launches_per_train_step": {
                layout: per_step[key]
                for layout, per_step in train_launches.items()},
            "launches_per_property_train_step": {
                layout: per_step[key]
                for layout, per_step in property_launches.items()},
            "launches_model_families": {
                run: counts[key] for run, counts in family_launches.items()},
            "launches_per_precision_step": {
                run: counts[key]
                for run, counts in precision_launches.items()},
            # counted from the profiler: the DP step's replay (bf16) and
            # one warm request of each kind
            "launches_per_dp_step": {
                layout: counts[key] for layout, counts in dp_launches.items()},
            "launches_per_serve_request": {
                req: counts[key] for req, counts in serve_launches.items()},
            # each campaign script's run, counted from 0
            "launches_scripts": {
                run: counts[key] for run, counts in script_launches.items()},
            # the graph-parallel legs' profiled steps (rank 0) and the
            # fjvp step's
            "launches_per_gp_step": {
                leg: counts[key] for leg, counts in gp_counts.items()},
            # counted from the profiler: a replay moves no counter
            "launches_per_captured_step": {
                **{run: cli_rows[run]["replayed_step"][
                    "launches_from_profile"][key]
                   for run in ("a_sparse", "b_dense", "c_ff_si")},
                "bench_bf16_dense": prec_rows["bf16_dense"]["captured"][
                    "launches_per_replayed_step"][key]},
            "max_abs_err": f32["max_abs_err"], "rel_err": f32["rel_err"],
            "tol_rel": f32["tol_rel"],
            "ms": f32["ms"], "kernel_ms": f32["ms"],
            "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"],
            "library_ms": f32.get("library_ms"),
            **({"gemm_only_ms": f32["gemm_only_ms"]}
               if "gemm_only_ms" in f32 else {}),
            "shape": kshape,
            "bfloat16": r["bfloat16"], "float16": r["float16"],
            **({"at_shape": {"si512_rattled": {"shape": dshape,
                                               **kernels[key]},
                             "dense_rocksalt_b64": {"shape": train_shape,
                                                    **train_kernels[key]}}}
               if dense else {}),
            **({"backward": r["backward"]} if "backward" in r else {}),
            **({"at_envelope_si512": envelope_k2} if key == "K2" else {}),
            **({"cold_ms": f32["cold_ms"], "bound_share": f32["bound_share"]}
               if "cold_ms" in f32 else {}),
            **({"at_train_sparse_lstage": {
                "shape": train_kernels["sparse_lstage"]["shape"],
                **train_kernels["sparse_lstage"][key]},
                "split_ms": r["split_ms"],
                # the kernel's instances: eggc.cu's GATED template flag
                "ptxas": [e for e in eggc_ptxas if
                          ("Lb1E" if key == "K1" else "Lb0E") in e["kernel"]]}
               if key in ("K1", "K2") else {}),
            **({"host_us": f32["host_us"],
                "library_host_us": f32["library_host_us"],
                "dst_float32": r["dst_float32"], "sites": r["checks"]}
               if key == "K8" else {})})
    if DETERMINISM_WARNINGS:
        emit({"phase": "determinism_warnings",
              "warnings": sorted(DETERMINISM_WARNINGS)})
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
