"""Training configuration (counterpart of ``alignn_tpu/config.py``).

Plain dataclasses with strict unknown-key rejection, a JSON round trip
and environment overrides under the ``ALIGNN_TPU_`` prefix, which fill
only the fields still at their default (an explicit value in the config
file wins over a stale shell variable).

The model sub-config is a tagged union on ``name``: ``alignn`` (the
property model, BatchNorm), ``alignn_atomwise`` (the force field) and
``ealignn_atomwise`` (eALIGNN).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Union

from alignn_tpu_torch.chem.features import FEATURESET_SIZE
from alignn_tpu_torch.nn.ealignn import eALIGNNAtomWiseConfig
from alignn_tpu_torch.nn.models import ALIGNNAtomWiseConfig, ALIGNNConfig


def _git_version() -> str:
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stderr=subprocess.DEVNULL).decode().strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


VERSION = _git_version()

DATASETS = (
    "dft_3d", "jdft_3d-8-18-2021", "dft_2d", "megnet", "megnet2",
    "mp_3d_2020", "qm9", "qm9_dgl", "qm9_std_jctc", "user_data",
    "oqmd_3d_no_cfid", "edos_up", "edos_pdos", "qmof", "qe_tb", "hmof",
    "hpov", "pdbbind", "pdbbind_core", "tinnet_OH", "tinnet_O", "tinnet_N",
)

# the reference's known target names: a soft check (a warning), since
# folder training takes free-form keys
TARGET_ENUM = frozenset([
    "formation_energy_peratom", "optb88vdw_bandgap", "bulk_modulus_kv",
    "shear_modulus_gv", "mbj_bandgap", "slme", "magmom_oszicar",
    "spillage", "kpoint_length_unit", "encut", "optb88vdw_total_energy",
    "epsx", "epsy", "epsz", "mepsx", "mepsy", "mepsz", "max_ir_mode",
    "min_ir_mode", "n-Seebeck", "p-Seebeck", "n-powerfact", "p-powerfact",
    "ncond", "pcond", "nkappa", "pkappa", "ehull", "exfoliation_energy",
    "dfpt_piezo_max_dielectric", "dfpt_piezo_max_eij",
    "dfpt_piezo_max_dij", "gap pbe", "e_form", "e_hull",
    "energy_per_atom", "formation_energy_per_atom", "band_gap",
    "e_above_hull", "mu_b", "bulk modulus", "shear modulus",
    "elastic anisotropy", "U0", "HOMO", "LUMO", "R2", "ZPVE", "omega1",
    "mu", "alpha", "homo", "lumo", "gap", "r2", "zpve", "U", "H", "G",
    "Cv", "A", "B", "C", "all", "target", "max_efg", "avg_elec_mass",
    "avg_hole_mass", "_oqmd_band_gap", "_oqmd_delta_e",
    "_oqmd_stability", "edos_up", "pdos_elast", "bandgap",
    "energy_total", "net_magmom", "b3lyp_homo", "b3lyp_lumo",
    "b3lyp_gap", "b3lyp_scharber_pce", "b3lyp_scharber_voc",
    "b3lyp_scharber_jsc", "log_kd_ki", "max_co2_adsp", "min_co2_adsp",
    "lcd", "pld", "void_fraction", "surface_area_m2g",
    "surface_area_m2cm3", "indir_gap", "f_enp", "final_energy", "ead",
])

MODEL_CONFIGS = {"alignn": ALIGNNConfig,
                 "alignn_atomwise": ALIGNNAtomWiseConfig,
                 "ealignn_atomwise": eALIGNNAtomWiseConfig}


def model_config_from_dict(d: Dict[str, Any]):
    """Config dataclass for d['name'] (default alignn_atomwise)."""
    name = d.get("name", "alignn_atomwise")
    if name not in MODEL_CONFIGS:
        raise ValueError(f"unknown model name: {name}")
    return MODEL_CONFIGS[name].from_dict(d)


def _strict_from_dict(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - known - {"version"}
    if unknown:
        raise ValueError(f"unknown {cls.__name__} keys: {sorted(unknown)}")
    return {k: v for k, v in d.items() if k in known}


def _coerce_env(env: str):
    """An environment override: JSON first, then Python-style booleans
    and None (a 'False' string would be truthy on a bool field), else the
    string itself."""
    try:
        return json.loads(env)
    except json.JSONDecodeError:
        low = env.strip().lower()
        if low in ("true", "false"):
            return low == "true"
        if low in ("none", "null"):
            return None
        return env


@dataclass
class TrainingConfig:
    """A whole training run (the same fields and defaults as JAX's)."""

    version: str = VERSION
    # dataset
    dataset: str = "dft_3d"
    target: str = "formation_energy_peratom"
    atom_features: str = "cgcnn"
    neighbor_strategy: str = "k-nearest"
    id_tag: str = "jid"
    # training
    dtype: str = "float32"
    random_seed: Optional[int] = 123
    classification_threshold: Optional[float] = None
    n_val: Optional[int] = None
    n_test: Optional[int] = None
    n_train: Optional[int] = None
    train_ratio: Optional[float] = 0.8
    val_ratio: Optional[float] = 0.1
    test_ratio: Optional[float] = 0.1
    target_multiplication_factor: Optional[float] = None
    epochs: int = 300
    batch_size: int = 64
    weight_decay: float = 0.0
    learning_rate: float = 1e-2
    filename: str = "sample"
    warmup_steps: int = 2000
    criterion: str = "mse"  # mse | l1 | poisson | zig
    optimizer: str = "adamw"  # adamw | sgd
    scheduler: str = "onecycle"  # onecycle | onecycle_full | none
    pin_memory: bool = False
    save_dataloader: bool = False
    write_checkpoint: bool = True
    write_predictions: bool = True
    store_outputs: bool = True
    progress: bool = True
    log_tensorboard: bool = False
    standard_scalar_and_pca: bool = False
    use_canonize: bool = True
    compute_line_graph: bool = True
    num_workers: int = 4
    cutoff: float = 8.0
    cutoff_extra: float = 3.0
    max_neighbors: int = 12
    keep_data_order: bool = True
    normalize_graph_level_loss: bool = False
    distributed: bool = False
    data_parallel: bool = False
    n_early_stopping: Optional[int] = None
    output_dir: str = field(default_factory=lambda: os.path.abspath("."))
    use_cache: bool = True
    bucket_slack: float = 1.0
    donate_batch: bool = True
    mesh_shape: Optional[Dict[str, int]] = None
    dense_neighborhoods: bool = False
    per_species_energy_baseline: bool = False
    lg_cutoff: Optional[float] = None
    # model
    model: Union[ALIGNNConfig, ALIGNNAtomWiseConfig, eALIGNNAtomWiseConfig,
                 Any] = field(
        default_factory=lambda: ALIGNNAtomWiseConfig(name="alignn_atomwise"))

    def __post_init__(self):
        if isinstance(self.model, dict):
            self.model = model_config_from_dict(self.model)
        defaults = {f.name: (f.default if f.default
                             is not dataclasses.MISSING else None)
                    for f in dataclasses.fields(self)}
        for f in dataclasses.fields(self):
            env = os.environ.get(f"ALIGNN_TPU_{f.name.upper()}")
            if env is None or f.name == "model":
                continue
            if f.default is not dataclasses.MISSING and \
                    getattr(self, f.name) != defaults[f.name]:
                continue  # set by the caller: the environment loses
            setattr(self, f.name, _coerce_env(env))
        if self.atom_features not in FEATURESET_SIZE:
            raise ValueError(f"unknown atom_features: {self.atom_features}")
        if self.target not in TARGET_ENUM and self.dataset != "user_data":
            warnings.warn(
                f"target '{self.target}' is not in the reference's known "
                f"target list (dataset {self.dataset!r}); proceeding",
                stacklevel=2)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainingConfig":
        return cls(**_strict_from_dict(cls, d))

    @classmethod
    def from_json(cls, path: str) -> "TrainingConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["version"] = VERSION
        return d

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)
