"""Model configuration dispatch (counterpart of ``alignn_tpu/config.py``).

The model sub-config is a tagged union on ``name``; the port has the
``alignn_atomwise`` force-field model so far.
"""

from __future__ import annotations

from typing import Any, Dict

from alignn_tpu_torch.nn.models import ALIGNNAtomWiseConfig

MODEL_CONFIGS = {"alignn_atomwise": ALIGNNAtomWiseConfig}


def model_config_from_dict(d: Dict[str, Any]):
    """Config dataclass for d['name'] (default alignn_atomwise)."""
    name = d.get("name", "alignn_atomwise")
    if name not in MODEL_CONFIGS:
        raise ValueError(f"model {name!r} is not ported yet "
                         f"(ported: {sorted(MODEL_CONFIGS)})")
    return MODEL_CONFIGS[name].from_dict(d)
