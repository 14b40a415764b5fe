"""Model FLOPs of a step, counted by ``torch.utils.flop_counter`` over the
plain reference on meta tensors (shapes only: no memory, no arithmetic).

Every product of the model is a dense layer over the rows of one table
(atoms, bonds, bond pairs or structures), so a step's FLOPs are linear
in the real, unpadded counts (N, E, L, G).  :class:`StepFlops` counts a
base batch and one step in each count once, and evaluates any batch
from those coefficients; padding rows are not work and are never
counted.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from reference import model as ref


def _meta_batch(n: int, e: int, l: int, g: int, cfg: dict):
    dev = "meta"
    i64 = torch.int64
    return {"feats": torch.zeros(n, cfg["atom_input_features"], device=dev),
            "src": torch.zeros(e, dtype=i64, device=dev),
            "dst": torch.zeros(e, dtype=i64, device=dev),
            "lg_src": torch.zeros(l, dtype=i64, device=dev),
            "lg_dst": torch.zeros(l, dtype=i64, device=dev),
            "node_graph": torch.zeros(n, dtype=i64, device=dev),
            "n_nodes": torch.ones(g, device=dev),
            "r": torch.ones(e, 3, device=dev)}


def count(cfg: dict, kind: str, n: int, e: int, l: int, g: int) -> int:
    """FLOPs of one `kind` pass over a batch of these real counts."""
    prop = kind in ("forward", "train_property")
    params = {k: torch.zeros(s, device="meta", requires_grad=True)
              for k, s in ref.shapes(cfg, prop).items()}
    b = _meta_batch(n, e, l, g, cfg)
    with FlopCounterMode(display=False) as fc:
        if kind == "forward":
            with torch.no_grad():
                ref.forward(params, cfg, b, b["r"], property_model=True)
        elif kind == "train_property":
            out, _ = ref.forward(params, cfg, b, b["r"], property_model=True)
            torch.autograd.grad(out.abs().sum(), list(params.values()),
                                allow_unused=True)
        elif kind == "forces":
            ref.energy_forces(params, cfg, b, b["r"])
        elif kind == "train_forces":
            out, _e, forces = ref.energy_forces(params, cfg, b, b["r"],
                                                create_graph=True)
            loss = out.abs().sum() + forces.abs().sum()
            torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
        else:
            raise ValueError(kind)
    return int(fc.get_total_flops())


class StepFlops:
    """FLOPs of `kind` passes as a linear function of (N, E, L, G)."""

    BASE = (64, 512, 4096, 2)

    def __init__(self, cfg: dict, kind: str):
        self.cfg, self.kind = cfg, kind
        base = self.BASE
        f0 = count(cfg, kind, *base)
        self.base, self.f0 = base, f0
        self.coef = []
        for k in range(4):
            bumped = list(base)
            bumped[k] += base[k]
            self.coef.append((count(cfg, kind, *bumped) - f0) / base[k])

    def __call__(self, n: int, e: int, l: int, g: int) -> float:
        return self.f0 + sum(c * (x - b) for c, x, b in
                             zip(self.coef, (n, e, l, g), self.base))

