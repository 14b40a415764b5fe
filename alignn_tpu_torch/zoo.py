"""Trained model directories and bulk prediction (counterpart of
``alignn_tpu/zoo.py``).

A model directory holds ``config.json`` and a flax ``.mpk`` weights file,
written by either package, or a checkpoint of the reference
implementation (``.pt``), converted at load and cached beside it as
``converted_model.mpk``.  :func:`load_model_dir` builds the model the
config names (``alignn``, ``alignn_atomwise`` or ``ealignn_atomwise``)
with its BatchNorm statistics; :func:`predict_structures` runs it over
structures, padded into shared buckets.  The registry of the reference's figshare models is
this package's copy of ``zoo_models.json``; nothing is downloaded here.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from alignn_tpu_torch import resolve_device
from alignn_tpu_torch.chem.atoms import Atoms
from alignn_tpu_torch.config import model_config_from_dict
from alignn_tpu_torch.nn.convert import flax_from_module, state_dict_from_flax
from alignn_tpu_torch.nn.models import init_parameters
from alignn_tpu_torch.train.checkpoint import (check_feature_table,
                                               checkpoint_meta,
                                               convert_torch_checkpoint,
                                               load_params_with_meta,
                                               merge_converted, save_params)

_REGISTRY_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "zoo_models.json")


def get_all_models() -> Dict[str, Dict[str, Any]]:
    """{model name: {url, output_features}} of the reference's zoo."""
    with open(_REGISTRY_PATH) as f:
        return json.load(f)


def get_figshare_model(model_name: str = "jv_formation_energy_peratom_alignn",
                       cache_dir: Optional[str] = None):
    """Not ported: fetching a zoo model downloads it.  Load a local model
    directory with :func:`load_model_dir` instead."""
    raise NotImplementedError(
        f"{model_name}: downloading zoo models is not ported; pass a local "
        f"model directory (load_model_dir, --model_path)")


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
                   ) -> Tuple[torch.nn.Module, Dict[str, Any]]:
    """(model in eval mode on `device`, config dict) from a model directory.

    The checkpoint's float16 storage is cast to the model's float32, and
    its ``batch_stats`` become the BatchNorm buffers.  A per-species
    energy baseline stamped into the checkpoint (or stored as
    ``species_baseline.json``) is returned in the config dict.

    Without an ``.mpk`` (or with a ``converted_model.mpk`` older than the
    ``.pt`` beside it) a reference ``.pt`` is converted, as JAX does,
    with the nested layout whatever the model, and laid over the model's
    own weights, which are drawn from seed 0; the parameters it does not
    cover keep them (an eALIGNN ``.pt``'s trunk and embeddings do: a
    quirk of the JAX package, kept).  The result is cached as
    ``converted_model.mpk`` beside the ``.pt`` where the directory is
    writable.
    """
    from alignn_tpu_torch.train.trainer import build_model

    device = resolve_device(device)
    cfg_path = _find(model_dir, ["config.json"])
    if cfg_path is None:
        raise FileNotFoundError(f"no config.json under {model_dir}")
    with open(cfg_path) as f:
        cfg_dict = json.load(f)
    model = build_model(model_config_from_dict(cfg_dict.get("model",
                                                            cfg_dict)))
    mpk = _find(model_dir, ["best_model.mpk", "last_model.mpk",
                            "current_model.mpk", ".mpk"])
    if mpk is not None and os.path.basename(mpk) == "converted_model.mpk":
        # a replaced .pt wins over the cache of its older conversion
        pt_src = _find(model_dir, [".pt"])
        if pt_src is not None and \
                os.path.getmtime(pt_src) > os.path.getmtime(mpk):
            mpk = None
    if mpk is None:
        return _load_pt(model_dir, model, cfg_dict, device)
    params, batch_stats, meta = load_params_with_meta(mpk)
    check_feature_table(meta, cfg_dict.get("atom_features", "cgcnn"), mpk)
    sb = meta.get("species_baseline")
    if sb is None:
        sb_path = _find(model_dir, ["species_baseline.json"])
        if sb_path is not None:
            with open(sb_path) as f:
                sb = json.load(f)
    if sb is not None:
        cfg_dict = {**cfg_dict, "species_baseline": sb}
    model.load_state_dict(state_dict_from_flax(
        params, dtype=torch.float32, batch_stats=batch_stats))
    return model.to(device).eval(), cfg_dict


def _load_pt(model_dir: str, model: torch.nn.Module,
             cfg_dict: Dict[str, Any], device
             ) -> Tuple[torch.nn.Module, Dict[str, Any]]:
    """The ``.pt`` half of :func:`load_model_dir`."""
    pt = _find(model_dir, ["best_model.pt", "current_model.pt",
                           "last_model.pt", ".pt"])
    if pt is None:
        raise FileNotFoundError(f"no checkpoint under {model_dir}")
    init_parameters(model, torch.Generator().manual_seed(0))
    params, stats = flax_from_module(model)
    cparams, cstats = convert_torch_checkpoint(pt)
    params, report = merge_converted(params, cparams)
    if report["missing"]:
        print(f"[zoo] {len(report['missing'])} params not in checkpoint "
              f"(kept init): {report['missing'][:4]}...")
    if cstats and stats:
        stats, _ = merge_converted(stats, cstats)
    model.load_state_dict(state_dict_from_flax(params, batch_stats=stats))
    cache = os.path.join(os.path.dirname(pt), "converted_model.mpk")
    try:
        save_params(cache, params, stats or None, meta=checkpoint_meta(
            cfg_dict.get("atom_features", "cgcnn"),
            converted_from=os.path.basename(pt)))
    except OSError:    # a read-only model directory: converted in memory
        pass
    return model.to(device).eval(), cfg_dict


def graph_kwargs_from_config(cfg_dict) -> Dict[str, Any]:
    """The graph and featurisation arguments a checkpoint was trained
    with (its cutoff, neighbour count, strategy and feature table)."""
    cfg_dict = cfg_dict or {}
    return {
        "cutoff": float(cfg_dict.get("cutoff", 8.0)),
        "max_neighbors": int(cfg_dict.get("max_neighbors", 12)),
        "neighbor_strategy": cfg_dict.get("neighbor_strategy", "k-nearest"),
        "atom_features": cfg_dict.get("atom_features", "cgcnn"),
    }


def predict_structures(model: torch.nn.Module, atoms_list: List[Atoms],
                       cutoff: float = 8.0, max_neighbors: int = 12,
                       neighbor_strategy: str = "k-nearest",
                       atom_features: str = "cgcnn",
                       batch_size: int = 32,
                       extra_features=None) -> np.ndarray:
    """[n, T] predictions of `model` (on its own device, in eval mode)
    for each structure, batches padded to one bucket; a force field's
    graph-level output.  A model with ``extra_features`` takes them from
    `extra_features`, one vector a structure."""
    from alignn_tpu_torch.data.loader import worst_case_spec
    from alignn_tpu_torch.graph.batch import batch_graphs
    from alignn_tpu_torch.graph.build import build_graph
    from alignn_tpu_torch.nn.ealignn import eALIGNNAtomWise, ealignn_forward
    from alignn_tpu_torch.nn.models import ALIGNNAtomWise, atomwise_forward

    device = next(model.parameters()).device
    graphs = [build_graph(a, neighbor_strategy=neighbor_strategy,
                          cutoff=cutoff, max_neighbors=max_neighbors)
              for a in atoms_list]
    for g, x in zip(graphs, extra_features or ()):
        g.extra_features = np.asarray(x, dtype=np.float64).reshape(-1)
    spec = worst_case_spec(graphs, min(batch_size, len(graphs)))
    model.eval()
    outs = []
    for s in range(0, len(graphs), batch_size):
        chunk = graphs[s:s + batch_size]
        batch = batch_graphs(chunk, spec, device,
                             atom_features=atom_features,
                             gather_windows=False,
                             extra_width=model.cfg.extra_features)
        if isinstance(model, eALIGNNAtomWise):
            out = ealignn_forward(model, batch)["out"]
        elif isinstance(model, ALIGNNAtomWise):
            out = atomwise_forward(model, batch)["out"]
        else:
            with torch.no_grad():
                out = model(batch)
        outs.append(out.detach().cpu().numpy()[:len(chunk)])
    return np.concatenate(outs, axis=0)
