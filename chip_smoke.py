#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``alignn_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases:
1. set-up: the card's name and power limit, TF32 off, the CUDA kernels
   built from ``alignn_tpu_torch/csrc`` (build seconds printed);
2. every kernel of the serving and training paths against its plain
   PyTorch version on the card, in f32 and bf16, with device times (CUDA
   events, median of 20 after warm-up, queued behind a spin kernel) and
   the bound: K1 gated aggregation and K2 sorted segment sum at the sparse
   L-stage shape of the 512-atom cell below; K3 dense gated aggregation,
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
   and 10 timed steps, the first against the same step on the CPU port.

K3 is also launched twice at both dense shapes (bit-identical), with its
fully masked (padded) nodes exactly 0 and one fill of its output timed
beside it; every dense kernel's entry carries its share of the bound.

Prints JSON lines; the last line is ``{"ok": true, "device": {...}}``.
Exits non-zero, without that line, on any failed check, and when no CUDA
device is present.
"""

from __future__ import annotations

import contextlib
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
    """Median device time of fn() over `reps` runs (CUDA events).

    The timed runs queue up behind a spin kernel that outlasts the host's
    time to enqueue them, so each event pair brackets device work only,
    not the Python wrapper's launch overhead (which exceeds the run time
    of the smaller kernels).
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int((2 * reps * host_s + 1e-3) * SPIN_CYCLES_PER_S))
    for start, end in events:
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
    time depends on the operands: bf16 x bf16 accumulated in f32 is exact
    and runs on the tensor cores at the bf16 rate; an f32-grade product
    runs on the tensor cores as the 3xTF32 split (hi.hi + hi.lo + lo.hi,
    f32 sums), three TF32 products at the TF32 rate.
    """
    if dtype == "bfloat16":
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


def dense_kernel_phase(batch, failures: list):
    """K3/K4/K5a/K5b against their plain versions at the dense shapes of
    `batch`, with its real slot masks folded into random logits, and
    their share of the bound; K3 and K5a/K5b also launched twice
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

    m32 = dk.fold_mask(randn(rows, f), batch.edge_mask)
    bh32 = randn(rows, f)
    m2_32 = dk.fold_mask(randn(pairs, f), batch.lg_mask)
    g32 = randn(rows, f)
    u32, v32 = randn(pairs, f), randn(rows, f)
    masked_pairs = batch.lg_mask == 0
    for key, fn in (("K3", "dense_gated_aggregate"),
                    ("K4", "dense_pair_aggregate"),
                    ("K5a", "pair_aggregate_bwd"),
                    ("K5b", "pair_aggregate_bwd2")):
        kern, plain = getattr(dk, fn + "_cuda"), getattr(dk, fn + "_plain")
        out = {}
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            es = torch.tensor([], dtype=dtype).element_size()
            bh, g = bh32.to(dtype), g32.to(dtype)
            if key == "K3":
                args = (m32.to(dtype), bh, D)
                # read m, bh; write h.  sigmoid 4, gated sum 2, gate sum 1
                # per element; add and divide per output
                nbytes, ops = (2 * rows + n) * f * es, 7.0 * rows * f + \
                    2.0 * n * f
            elif key == "K4":
                args = (m2_32.to(dtype), bh, D)
                nbytes, ops = (pairs + 2 * rows) * f * es, 7.0 * pairs * f + \
                    2.0 * rows * f
            elif key == "K5a":
                args = (m2_32.to(dtype), bh, g, D)
                # read m2, bh, g; write dm2, dbh.  per pair element:
                # sigmoid 4, sums 3, dm2 6, dbh 2; per row: ginv, gh 5
                nbytes = (2 * pairs + 3 * rows) * f * es
                ops = 15.0 * pairs * f + 5.0 * rows * f
            else:
                args = (m2_32.to(dtype), bh, g, u32.to(dtype), v32.to(dtype),
                        D)
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
            ms = cuda_ms(lambda: kern(*args))
            out[name] = {**err, "ms": ms,
                         "plain_ms": cuda_ms(lambda: plain(*args)),
                         "bound_ms": b_ms, "bound_by": b_by,
                         "bound_share": b_ms / ms, "library_ms": None,
                         **occupancy}
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
    sg32 = dk.fold_mask(randn(rows, f), batch.edge_mask)
    dg32 = dk.fold_mask(randn(rows, f), batch.edge_mask)
    bh32, dh32 = randn(rows, f), randn(rows, f)
    de32 = randn(pairs, f) * batch.lg_mask[:, None]
    results = {"K6": {}, "K7": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        es = torch.tensor([], dtype=dtype).element_size()
        z = z32.to(dtype)
        args = (z, w, b, sg32.to(dtype), dg32.to(dtype), bh32.to(dtype), sc,
                bi, D)
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


def k5_ptxas(log: str) -> list:
    """Registers, stack and spills of dense.cu's K5a/K5b kernels, from its
    ``nvcc -Xptxas -v`` build log, one entry per compiled instance."""
    out, entry, name, props = [], None, "", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            entry = None
            for kind in ("pair_bwd2_slab", "pair_bwd_slab", "pair_bwd2_2pass",
                         "pair_bwd_2pass"):
                if kind in name:
                    vec = name.split(kind)[1].split("Li")[1].split("E")[0]
                    entry = {"kernel": kind, "vec": int(vec),
                             "dtype": "bfloat16" if "bfloat16" in name
                             else "float32"}
                    out.append(entry)
                    break
        elif "Function properties for" in line:
            props = line.split("Function properties for")[1].strip()
        elif entry is not None and "spill stores" in line and props == name:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            entry.update(stack_bytes=nums[0], spill_store_bytes=nums[1],
                         spill_load_bytes=nums[2])
        elif entry is not None and "Used" in line:
            entry["registers"] = int(line.split("Used")[1].split()[0])
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

    from alignn_tpu_torch.nn.models import atomwise_forward

    clock = [time.perf_counter()]

    def lap():
        torch.cuda.synchronize()
        clock.append(time.perf_counter())
        return (clock[-1] - clock[-2]) * 1e3

    g = calc.graph_for(atoms)
    stages = {"graph": lap()}
    batch = calc.batch_for(g)
    stages["batch"] = lap()
    res = atomwise_forward(calc.model, batch)
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
LAYOUT_KERNELS = {"sparse": (("K1", "K2"), ("K6", "K7", "K8")),
                  "dense": (("K3", "K4", "K5a"), ("K1", "K6", "K7", "K8")),
                  "fused": (("K3", "K6", "K7"), ("K1", "K4", "K5a", "K8")),
                  "envelope": (("K2",), NOT_K2)}
TRAIN_KERNELS = {"sparse": LAYOUT_KERNELS["sparse"],
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
        if row["abs_sum_force"] > 1e-3:
            failures.append(f"{name}: |sum F| = {row['abs_sum_force']}")
        if layout in ("dense", "fused") and (calc._spec is None
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


def first_step(weights, batch, cfg=TRAIN_CFG):
    """(loss components, gradient of every parameter) of one train step
    of a fresh model of config `cfg` from `weights` on `batch`'s
    device."""
    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig)
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    model = ALIGNNAtomWise(ALIGNNAtomWiseConfig(**cfg))
    model.load_state_dict(weights)
    state = create_train_state(model, batch,
                               build_optimizer("adamw", 1e-3, 1e-5))
    _state, losses = make_train_step(model)(state, batch)
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
              warmup: int = 2, cfg=TRAIN_CFG):
    """`steps` E/F/S train steps of a fresh model of config `cfg` from
    `weights` on `batch`, the first `warmup` untimed: ms per step, edges
    per second over the timed window, launches per step, peak memory, one
    profiled step.  Returns (row, first step's losses and gradients,
    launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig)
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    model = ALIGNNAtomWise(ALIGNNAtomWiseConfig(**cfg))
    model.load_state_dict(weights)
    state = create_train_state(model, batch,
                               build_optimizer("adamw", 1e-3, 1e-5))
    step = make_train_step(model)
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
    if not all(np.isfinite(v) for ls in trajectory for v in ls.values()):
        failures.append(f"train {layout}: non-finite losses")
    need, banned = TRAIN_KERNELS[layout]
    if any(launches[k] <= 0 for k in need) or \
            any(launches[k] != 0 for k in banned):
        failures.append(f"train {layout}: launches {launches} (need {need}, "
                        f"none of {banned})")
    del state, model, prof
    torch.cuda.empty_cache()
    return row, first, {k: v / steps for k, v in launches.items()}


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
        for dtype in (torch.float32, torch.bfloat16):
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
            ("float32", "lstage_src", (torch.float32, torch.bfloat16)),
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
            results[key if dtype == torch.float32 else "bfloat16"] = entry
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
    to build a batch against the step's, and the launches of the epoch."""
    import torch

    from alignn_tpu_torch.data.dataset import GraphDataset
    from alignn_tpu_torch.data.loader import BucketedLoader, worst_case_spec
    from alignn_tpu_torch.graph.batch import WIN_FIELDS
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
           "host_batch_build_ms": build_ms, "steps": steps,
           "floors": dict(loader._win_floor),
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
    del state, model, first
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
    emit({"phase": "ptxas_k5", "kernels": k5_ptxas(_build.build_log("dense"))})
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
    seg = batch.lg_index.dst
    shape = {"rows": int(seg.ids.shape[0]), "segments": seg.num,
             "features": calc.model.cfg.hidden_features,
             "longest_segment": int((seg.row_ptr[1:] - seg.row_ptr[:-1])
                                    .max().item())}
    kernels = kernel_phase(seg, failures)
    del batch, seg
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
            "launches_per_train_step": {
                layout: per_step[key]
                for layout, per_step in train_launches.items()},
            "max_abs_err": f32["max_abs_err"], "rel_err": f32["rel_err"],
            "tol_rel": f32["tol_rel"],
            "ms": f32["ms"], "kernel_ms": f32["ms"],
            "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"],
            "library_ms": f32.get("library_ms"),
            **({"gemm_only_ms": f32["gemm_only_ms"]}
               if "gemm_only_ms" in f32 else {}),
            "shape": kshape,
            "bfloat16": r["bfloat16"],
            **({"at_shape": {"si512_rattled": {"shape": dshape,
                                               **kernels[key]},
                             "dense_rocksalt_b64": {"shape": train_shape,
                                                    **train_kernels[key]}}}
               if dense else {}),
            **({"backward": r["backward"]} if "backward" in r else {}),
            **({"at_envelope_si512": envelope_k2} if key == "K2" else {}),
            **({"host_us": f32["host_us"],
                "library_host_us": f32["library_host_us"],
                "dst_float32": r["dst_float32"], "sites": r["checks"]}
               if key == "K8" else {})})
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
