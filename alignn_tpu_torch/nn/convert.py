"""Carry the JAX package's parameter tree across to the port's modules.

A flax tree is nested dicts of arrays (``{"trunk": {"gcn_layers_0":
{"src_gate": {"kernel": [in, out], "bias": [out]}}}}``).  The port names
its submodules after that tree, so the mapping is mechanical: dots join
the path, a Dense ``kernel`` is transposed into a Linear ``weight``, a
LayerNorm ``scale`` becomes ``weight``.  The same function loads the
``.mpk`` checkpoints (:mod:`alignn_tpu_torch.train.checkpoint`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def state_dict_from_flax(params: Mapping[str, Any],
                         dtype: torch.dtype = torch.float32
                         ) -> Dict[str, torch.Tensor]:
    """{dotted name: tensor} for ``module.load_state_dict``, cast to dtype."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping[str, Any], prefix: str):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.")
                continue
            arr = np.asarray(value)
            if key == "kernel":
                key, arr = "weight", arr.T
            elif key == "scale":
                key = "weight"
            out[prefix + key] = torch.tensor(arr, dtype=dtype)  # a copy

    walk(params, "")
    return out
