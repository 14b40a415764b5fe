"""Datasets by name, from the local cache (the cache half of
``alignn_tpu/data/figshare.py``).

The reference names 23 JARVIS datasets (``alignn/config.py:131-154``),
each a JSON list of records (``jid``, ``atoms``, one key a property)
hosted on figshare.  :func:`load_dataset` reads ``<cache_dir>/<name>.json``,
the file the JAX package writes after its download, or one placed there by
hand.  Downloading is not ported (ROADMAP.md §1 "Not ported, by
decision"): without the file, a dataset with a known URL raises
``NotImplementedError`` and one without raises JAX's ``ValueError``.

The cache directory is ``ALIGNN_TPU_DATA_CACHE``, else
``~/.cache/alignn_tpu/data``, read at each call.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

# dataset -> figshare ndownloader url (jarvis-tools scheme), as in JAX
DATASET_URLS: Dict[str, Optional[str]] = {
    "dft_3d": "https://ndownloader.figshare.com/files/29204826",
    "jdft_3d-8-18-2021": "https://ndownloader.figshare.com/files/29204826",
    "dft_2d": "https://ndownloader.figshare.com/files/26808917",
    "megnet": "https://ndownloader.figshare.com/files/26724977",
    "megnet2": None,
    "mp_3d_2020": "https://ndownloader.figshare.com/files/26724921",
    "qm9": None,
    "qm9_dgl": "https://ndownloader.figshare.com/files/28541196",
    "qm9_std_jctc": "https://ndownloader.figshare.com/files/28715319",
    "oqmd_3d_no_cfid": "https://ndownloader.figshare.com/files/26790182",
    "edos_up": None,
    "edos_pdos": None,
    "qmof": None,
    "qe_tb": None,
    "hmof": None,
    "hpov": None,
    "pdbbind": None,
    "pdbbind_core": None,
    "tinnet_OH": None,
    "tinnet_O": None,
    "tinnet_N": None,
    "user_data": None,
}

# per-dataset training presets (reference train_props.py:100-174)
DATASET_PRESETS: Dict[str, Dict[str, Any]] = {
    "qm9_std_jctc": {"n_train": 110000, "n_val": 10000, "n_test": 13885,
                     "cutoff": 5.0,
                     "target_multiplication_factor": 27.211386024367243},
    "megnet": {"n_train": 60000, "n_val": 5000, "n_test": 4239},
    "dft_3d": {},
    "dft_2d": {},
}


def _cache_root() -> str:
    return os.environ.get(
        "ALIGNN_TPU_DATA_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "alignn_tpu",
                     "data"))


def dataset_cache_path(name: str) -> str:
    """Where :func:`load_dataset` looks for dataset `name`."""
    return os.path.join(_cache_root(), f"{name}.json")


def load_dataset(name: str, url: Optional[str] = None,
                 cache_dir: Optional[str] = None) -> List[Dict[str, Any]]:
    """The records of dataset `name` from ``<cache_dir>/<name>.json``."""
    path = os.path.join(cache_dir or _cache_root(), f"{name}.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    url = url or DATASET_URLS.get(name)
    if url is None:
        raise ValueError(
            f"no known figshare url for dataset '{name}'; pass url= or "
            f"place the records at {path}")
    raise NotImplementedError(
        f"dataset '{name}' is not in the cache, and downloading it from "
        f"{url} is not ported (ROADMAP.md §1 \"Not ported, by decision\"); "
        f"place the records at {path}")


def train_prop_model(dataset: str = "dft_3d",
                     prop: str = "formation_energy_peratom", device=None,
                     **overrides):
    """Preset training on a cached dataset (reference train_props.py):
    the dataset's presets, then `overrides`, as a TrainingConfig; the
    standard loaders and trainer on `device` (``cuda`` by default)."""
    from alignn_tpu_torch.config import TrainingConfig
    from alignn_tpu_torch.data.loader import get_train_val_loaders
    from alignn_tpu_torch.train.trainer import train_model

    preset = dict(DATASET_PRESETS.get(dataset, {}))
    tmf = preset.pop("target_multiplication_factor", None)
    config = TrainingConfig(**{"dataset": dataset, "target": prop, **preset,
                               **overrides})
    records = load_dataset(dataset)
    for r in records:
        r["target"] = r.get(prop)
    tr, va, te, _mad = get_train_val_loaders(
        records, target="target", id_tag=config.id_tag,
        atom_features=config.atom_features,
        neighbor_strategy=config.neighbor_strategy,
        cutoff=config.cutoff, max_neighbors=config.max_neighbors,
        batch_size=config.batch_size,
        n_train=config.n_train, n_val=config.n_val, n_test=config.n_test,
        train_ratio=config.train_ratio, val_ratio=config.val_ratio,
        test_ratio=config.test_ratio,
        keep_data_order=config.keep_data_order,
        target_multiplication_factor=tmf,
        output_dir=config.output_dir, num_workers=config.num_workers,
        device=device)
    return train_model(config, tr, va, te)
