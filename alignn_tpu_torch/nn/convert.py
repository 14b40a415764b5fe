"""Carry the JAX package's parameter tree across to the port's modules, and
back.

A flax tree is nested dicts of arrays (``{"trunk": {"gcn_layers_0":
{"src_gate": {"kernel": [in, out], "bias": [out]}}}}``).  The port names
its submodules after that tree, so the mapping is mechanical: dots join
the path, a Dense ``kernel`` is transposed into a Linear ``weight``, a
norm's ``scale`` becomes ``weight``, and a BatchNorm's ``batch_stats``
``{mean, var}`` become its buffers of the same names.  The same functions
read and write the ``.mpk`` checkpoints
(:mod:`alignn_tpu_torch.train.checkpoint`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from alignn_tpu_torch.nn.layers import MaskedBatchNorm, MaskedLayerNorm


def state_dict_from_flax(params: Mapping[str, Any],
                         dtype: torch.dtype = torch.float32,
                         batch_stats: Optional[Mapping[str, Any]] = None
                         ) -> Dict[str, torch.Tensor]:
    """{dotted name: tensor} for ``module.load_state_dict``, cast to dtype;
    with `batch_stats`, the BatchNorm buffers too."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping[str, Any], prefix: str, rename: bool):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.", rename)
                continue
            arr = np.asarray(value)
            if rename and key == "kernel":
                key, arr = "weight", arr.T
            elif rename and key == "scale":
                key = "weight"
            out[prefix + key] = torch.tensor(arr, dtype=dtype)  # a copy

    walk(params, "", True)
    walk(batch_stats or {}, "", False)
    return out


def flax_from_module(model: nn.Module) -> Tuple[Dict, Dict]:
    """(params, batch_stats) of `model` as the JAX package's nested trees
    of f32 numpy arrays: the inverse of :func:`state_dict_from_flax`
    (Linear ``weight`` back to a transposed ``kernel``, a norm's
    ``weight`` back to ``scale``).  batch_stats is {} without BatchNorm."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    covered = set()

    def put(tree: Dict, path: str, leaf: str, value: torch.Tensor):
        node = tree
        for part in path.split("."):
            node = node.setdefault(part, {})
        node[leaf] = value.detach().to("cpu", torch.float32).numpy().copy()

    for name, m in model.named_modules():
        if isinstance(m, nn.Linear):
            put(params, name, "kernel", m.weight.t())
            put(params, name, "bias", m.bias)
        elif isinstance(m, (MaskedLayerNorm, MaskedBatchNorm)):
            put(params, name, "scale", m.weight)
            put(params, name, "bias", m.bias)
            if isinstance(m, MaskedBatchNorm):
                put(stats, name, "mean", m.mean)
                put(stats, name, "var", m.var)
        else:
            continue
        covered.update(id(p) for p in m.parameters(recurse=False))
    missed = [n for n, p in model.named_parameters() if id(p) not in covered]
    if missed:
        raise ValueError(f"no flax name for parameters {missed}")
    return params, stats
