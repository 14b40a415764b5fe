"""PyTorch/CUDA port of alignn_tpu for NVIDIA Hopper (H100).

The package mirrors the module names of the JAX package ``alignn_tpu`` and
imports nothing of it (nor of ``jax``/``flax``): torch, numpy and the
standard library only.  Hand-written CUDA kernels live in ``csrc/`` and
are compiled at first use by :mod:`alignn_tpu_torch._build`.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import threading
from typing import Optional, Union

# Held by a helper thread around its device work (the loaders' prefetch)
# and by a CUDA-graph capture (ff/step_loop.py), which no other thread may
# interleave device work with.
DEVICE_WORK_LOCK = threading.Lock()


def resolve_device(device: Optional[Union[str, "torch.device"]] = None
                   ) -> "torch.device":
    """The device an entry point runs on: ``cuda`` unless the caller asks.

    Asking for nothing on a host without a GPU raises instead of running
    silently on the CPU.  (torch is imported here, not with the package:
    the graph-building workers of ``data/dataset.py`` import no torch.)
    """
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "alignn_tpu_torch runs on CUDA by default and no CUDA device "
                "is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
