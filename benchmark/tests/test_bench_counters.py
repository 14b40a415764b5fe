"""The FLOP and byte counters against hand counts."""

import pytest

from harness import flops
from harness.peaks import (H100_BYTES_PER_S, eggc_bytes_flops,
                           eggc_least_seconds)
from reference import model as rmodel

F = 256


def test_one_eggc_layer_flops_match_the_hand_count():
    """One EGGC forward: four dense layers over the nodes (src_gate,
    dst_gate, src_update, dst_update) and one over the edges (edge_gate),
    2 F^2 FLOPs a row each: 2 F^2 (4 N + E)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    n, e = 40, 300
    p = {}
    for lin in rmodel.eggc_linears("layer"):
        p[lin + ".weight"] = torch.zeros(F, F, device="meta")
        p[lin + ".bias"] = torch.zeros(F, device="meta")
    for norm in ("layer.norm_nodes", "layer.norm_edges"):
        p[norm + ".weight"] = torch.ones(F, device="meta")
        p[norm + ".bias"] = torch.zeros(F, device="meta")
    x = torch.zeros(n, F, device="meta")
    y = torch.zeros(e, F, device="meta")
    idx = torch.zeros(e, dtype=torch.int64, device="meta")
    with FlopCounterMode(display=False) as fc:
        rmodel.eggc(p, "layer", x, y, idx, idx, rmodel.layer_norm)
    assert fc.get_total_flops() == 2 * F * F * (4 * n + e)


@pytest.mark.parametrize("kind", ["forward", "forces"])
def test_step_flops_are_linear_in_the_counts(kind):
    """The linear model of a step's FLOPs reproduces a direct count at
    counts it was not fitted on."""
    cfg = {"alignn_layers": 1, "gcn_layers": 1, "atom_input_features": 92,
           "edge_input_features": 80, "triplet_input_features": 40,
           "embedding_features": 64, "hidden_features": F,
           "output_features": 1, "use_cutoff_function": True,
           "inner_cutoff": 3.0, "exponent": 5, "energy_mult_natoms": True,
           "use_penalty": True, "penalty_threshold": 1.0,
           "penalty_factor": 0.1, "add_reverse_forces": True,
           "grad_multiplier": -1}
    model = flops.StepFlops(cfg, kind)
    assert model(100, 900, 7000, 3) == flops.count(cfg, kind, 100, 900,
                                                   7000, 3)


def test_k1_and_k2_bytes_match_the_hand_count():
    rows, segs, f = 385_024, 16_000, 256
    # K1 reads m and bh, the CSR pointer, writes [segments, F]
    assert eggc_bytes_flops("K1", rows, segs, f, 4) == (
        2 * rows * f * 4 + 4 * (segs + 1) + segs * f * 4,
        7.0 * rows * f + 2.0 * segs * f)
    # K2 reads x once
    assert eggc_bytes_flops("K2", rows, segs, f, 2) == (
        rows * f * 2 + 4 * (segs + 1) + segs * f * 2, 1.0 * rows * f)
    # both are bound by their bytes at these shapes
    nbytes, _ = eggc_bytes_flops("K2", rows, segs, f, 4)
    assert eggc_least_seconds("K2", rows, segs, f, 4) == pytest.approx(
        nbytes / H100_BYTES_PER_S)
