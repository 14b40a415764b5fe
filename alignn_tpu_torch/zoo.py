"""Load a trained model directory (counterpart of ``alignn_tpu/zoo.py``).

A model directory holds ``config.json`` and a flax ``.mpk`` weights file
written by the JAX package.  Nothing is downloaded here.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from alignn_tpu_torch import resolve_device
from alignn_tpu_torch.config import model_config_from_dict
from alignn_tpu_torch.nn.convert import state_dict_from_flax
from alignn_tpu_torch.nn.models import ALIGNNAtomWise
from alignn_tpu_torch.train.checkpoint import (check_feature_table,
                                               load_params_with_meta)


def _find(root: str, suffixes) -> Optional[str]:
    """First file under root matching the highest-priority suffix."""
    all_files = []
    for dirpath, _dirs, files in os.walk(root):
        for f in sorted(files):
            all_files.append(os.path.join(dirpath, f))
    for suffix in suffixes:
        for path in all_files:
            if path.endswith(suffix):
                return path
    return None


def load_model_dir(model_dir: str, device=None
                   ) -> Tuple[ALIGNNAtomWise, Dict[str, Any]]:
    """(model in eval mode on `device`, config dict) from a model directory.

    The checkpoint's float16 storage is cast to the model's float32.  A
    per-species energy baseline stamped into the checkpoint (or stored as
    ``species_baseline.json``) is returned in the config dict.
    """
    device = resolve_device(device)
    cfg_path = _find(model_dir, ["config.json"])
    if cfg_path is None:
        raise FileNotFoundError(f"no config.json under {model_dir}")
    with open(cfg_path) as f:
        cfg_dict = json.load(f)
    model = ALIGNNAtomWise(model_config_from_dict(cfg_dict.get("model",
                                                               cfg_dict)))
    mpk = _find(model_dir, ["best_model.mpk", "last_model.mpk",
                            "current_model.mpk", ".mpk"])
    if mpk is None:
        raise FileNotFoundError(f"no .mpk checkpoint under {model_dir}")
    params, _batch_stats, meta = load_params_with_meta(mpk)
    check_feature_table(meta, cfg_dict.get("atom_features", "cgcnn"), mpk)
    sb = meta.get("species_baseline")
    if sb is None:
        sb_path = _find(model_dir, ["species_baseline.json"])
        if sb_path is not None:
            with open(sb_path) as f:
                sb = json.load(f)
    if sb is not None:
        cfg_dict = {**cfg_dict, "species_baseline": sb}
    model.load_state_dict(state_dict_from_flax(params, dtype=torch.float32))
    return model.to(device).eval(), cfg_dict
