"""The process group and its 1-D data mesh (counterpart of
``alignn_tpu/parallel/mesh.py``).

JAX runs one program per host over a mesh of that host's devices.  The
port runs one process, a rank, per GPU (PyTorch's idiom): the "mesh" is the
group of ranks, and each rank computes on its own device.

- :func:`initialize_distributed` is the rendezvous, ``init_process_group``
  with NCCL for CUDA devices and gloo for the CPU.  With no address it reads
  the environment ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``,
  ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``).  On the card it selects the
  rank's device (``cuda:<local rank>``) before anything touches the card.
- :func:`make_mesh` describes the initialised group: world size, rank, the
  rank's device, the backend and the group.  Only the 1-D data mesh is
  ported; a 2-D (data x graph) shape raises.
- :func:`all_reduce_sum` is a differentiable all-reduce: its backward
  all-reduces the incoming gradient, as the transpose of JAX's ``psum``
  inside ``shard_map`` does.  The cross-rank BatchNorm
  (:class:`~alignn_tpu_torch.nn.layers.MaskedBatchNorm`) reduces its sums
  through it.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from alignn_tpu_torch import resolve_device

GRAPH_AXIS_REFUSAL = ('edge partitioning over a "graph" mesh axis is not '
                      'ported (ROADMAP.md §1 "Multi-GPU, part 2")')

# a rank that waits this long in a collective or the rendezvous raises
# instead of hanging
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)

# the device initialize_distributed chose for this rank
_RANK_DEVICE: Optional[torch.device] = None


@dataclass(frozen=True)
class Mesh:
    """The data-parallel group as this rank sees it."""

    world_size: int
    rank: int
    device: torch.device
    backend: str
    group: Any

    @property
    def size(self) -> int:
        """Ranks on the data axis (JAX's ``mesh.devices.size``)."""
        return self.world_size


def _local_rank(rank: int) -> int:
    """The rank's GPU: ``LOCAL_RANK`` under torchrun, else its rank
    modulo the visible devices."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % max(torch.cuda.device_count(), 1)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None, backend: Optional[str] = None
                           ) -> torch.device:
    """Join the process group; returns this rank's device.

    `coordinator_address` is ``host:port`` (or a ``tcp://`` URL) of rank
    0's store; with it, `num_processes` and `process_id` name the world
    and this rank.  Without it the ``torchrun`` environment does.  The
    backend is NCCL for a CUDA `device` (the default) and gloo for the CPU;
    `backend` overrides it (gloo also takes CUDA tensors)."""
    global _RANK_DEVICE
    if coordinator_address is None and (num_processes is not None
                                        or process_id is not None):
        raise ValueError(
            "num_processes/process_id require coordinator_address: "
            "falling back to the environment would ignore the explicit "
            "process identity")
    device = resolve_device(device)
    if coordinator_address is None:
        init_method = "env://"
        rank = int(os.environ.get("RANK", "0"))
    else:
        init_method = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        rank = int(process_id or 0)
    if device.type == "cuda":
        device = torch.device("cuda", _local_rank(rank))
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=COLLECTIVE_TIMEOUT)
    _RANK_DEVICE = device
    return device


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """The 1-D data mesh over every rank of the initialised group.

    `n_devices`, where given, must equal the world size: each rank holds
    one device.  A 2-D `shape` or a second axis name raises."""
    if (shape is not None and len(shape) > 1) or len(axis_names) > 1:
        raise NotImplementedError(
            f"mesh shape {tuple(shape or ())} over {tuple(axis_names)}: "
            f"{GRAPH_AXIS_REFUSAL}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the process group: call "
                           "initialize_distributed first")
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"a mesh of {n_devices} devices over {world} "
                         f"ranks: each rank holds one device")
    device = _RANK_DEVICE
    if device is None:   # a group this module did not start
        device = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend() == "nccl" else torch.device("cpu")
    return Mesh(world_size=world, rank=dist.get_rank(), device=device,
                backend=dist.get_backend(), group=dist.group.WORLD)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of `group`; the gradient is summed the same way
    (every rank's output depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = torch.clone(x, memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the ranks of `group`, differentiable."""
    return _AllReduceSum.apply(x, group)


def all_reduce_mean_(flat: torch.Tensor, group) -> torch.Tensor:
    """`flat` replaced in place by its mean over the ranks: a SUM (gloo has
    no AVG) divided by the world size."""
    dist.all_reduce(flat, group=group)
    return flat.div_(dist.get_world_size(group))
