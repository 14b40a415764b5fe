"""The process group, its mesh and the differentiable collectives on a
mesh axis (counterpart of ``alignn_tpu/parallel/mesh.py`` and of the
``lax.psum``/``ppermute``/``all_gather`` calls inside JAX's ``shard_map``).

JAX runs one program per host over a mesh of that host's devices.  The
port runs one process, a rank, per device (PyTorch's idiom): the "mesh" is
the group of ranks laid out as JAX lays out its devices, rank
``d * G + g`` at (data ``d``, graph ``g``) of a ``("data", "graph")``
mesh of shape (D, G), and each rank computes on its own device.

- :func:`initialize_distributed` is the rendezvous, ``init_process_group``
  with NCCL for CUDA devices and gloo for the CPU.  With no address it reads
  the environment ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``,
  ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``).  On the card it selects the
  rank's device (``cuda:<local rank>``) before anything touches the card.
- :func:`make_mesh` describes the initialised group: world size, rank, the
  rank's device, the backend, and for each axis the subgroup of this
  rank's neighbours along it (:class:`Axis`): on a (data, graph) mesh the
  ranks of this rank's data row (the "graph" axis) and of its graph
  column (the "data" axis).
- :func:`all_reduce_sum` is a differentiable all-reduce: its backward
  all-reduces the incoming gradient, as the transpose of JAX's ``psum``
  inside ``shard_map`` does.  The cross-rank BatchNorm
  (:class:`~alignn_tpu_torch.nn.layers.MaskedBatchNorm`) reduces its sums
  through it.
- :func:`ring_shift` moves each rank's tensor k places along an axis (JAX's
  ``ppermute`` with the pairs ``j -> j + k``); its backward is the shift by
  -k.  :func:`all_gather` stacks the axis' tensors in axis order; its
  backward is the reduce-scatter of the cotangent.  Each backward calls the
  same Functions, so a gradient of a gradient (the force loss) crosses the
  ranks as well.

The transport of a shift is the backend's point-to-point send and receive.
gloo's moves host memory only, so with gloo a CUDA tensor is staged
through a host copy on each side (:func:`shift_transport`); the compute
stays on the card.  The all-reduce takes CUDA tensors under both backends,
and :func:`all_gather` is an all-reduce of the tensor placed in its slot.
:data:`COLLECTIVE_STATS` adds up the calls, bytes and host seconds of the
collectives of this module.  While
:func:`~alignn_tpu_torch.parallel.collective_audit.record_collectives` is
open (:data:`RECORDER`), each differentiable collective also reports its
kind, payload, phase and shift distance to it; with none open that costs
one test of a module global.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from alignn_tpu_torch import resolve_device

# a rank that waits this long in a collective or the rendezvous raises
# instead of hanging
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)

# the device initialize_distributed chose for this rank
_RANK_DEVICE: Optional[torch.device] = None


# calls, bytes moved (sent, or summed) and host seconds of the collectives
# below, for a caller that splits a step's time (chip_smoke.py)
COLLECTIVE_STATS: Dict[str, float] = {"calls": 0, "bytes": 0, "seconds": 0.0}


# the recorder of parallel.collective_audit.record_collectives while one is
# open, else None
RECORDER = None


def _audit_label():
    """The open recorder's label of the collective being made (stored on
    its Function's ctx, so that its backward reports under it)."""
    return None if RECORDER is None else RECORDER.label()


def _backward_of(ctx):
    """Around a collective Function's backward: its collectives report in
    the transpose phase, under the forward's label."""
    if RECORDER is None:
        return contextlib.nullcontext()
    return RECORDER.transposing(getattr(ctx, "audit_label", None))


def collective_exchange():
    """Marks the collectives made inside as one exchange (a ring, or one
    halo exchange) for the open recorder; nothing when none is open."""
    if RECORDER is None:
        return contextlib.nullcontext()
    return RECORDER.exchange()


def reset_collective_stats() -> None:
    for k in COLLECTIVE_STATS:
        COLLECTIVE_STATS[k] = 0


@dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: the subgroup of the ranks that
    differ from it only along the axis, their global ranks in axis order,
    and this rank's place among them."""

    name: str
    group: Any
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclass(frozen=True)
class Mesh:
    """The group as this rank sees it, laid out as JAX's device mesh."""

    world_size: int
    rank: int
    device: torch.device
    backend: str
    group: Any
    axis_names: Tuple[str, ...] = ("data",)
    shape: Tuple[int, ...] = ()
    axes: Dict[str, Axis] = field(default_factory=dict)

    @property
    def size(self) -> int:
        """Ranks of the mesh (JAX's ``mesh.devices.size``)."""
        return self.world_size

    def axis(self, name: str) -> Axis:
        if name not in self.axes:
            raise KeyError(f"mesh axes {self.axis_names} have no {name!r}")
        return self.axes[name]


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
    """The mesh over every rank of the initialised group.

    `n_devices`, where given, must equal the world size: each rank holds
    one device.  `shape` (default: all ranks on one axis) must multiply
    to the world size, one entry per axis name.  Every rank must call
    this alike: the subgroups of a multi-axis mesh are made by all ranks
    together."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the process group: call "
                           "initialize_distributed first")
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"a mesh of {n_devices} devices over {world} "
                         f"ranks: each rank holds one device")
    axis_names = tuple(axis_names)
    shape = (world,) if shape is None else tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} over axes {axis_names} does "
                         f"not lay out {world} ranks")
    rank = dist.get_rank()
    grid = np.arange(world).reshape(shape)
    axes = {}
    for a, name in enumerate(axis_names):
        if len(shape) == 1:
            axes[name] = Axis(name, dist.group.WORLD, tuple(range(world)),
                              rank)
            continue
        for row in np.moveaxis(grid, a, -1).reshape(-1, shape[a]):
            ranks = tuple(int(r) for r in row)
            group = dist.new_group(list(ranks))   # every rank, every row
            if rank in ranks:
                axes[name] = Axis(name, group, ranks, ranks.index(rank))
    device = _RANK_DEVICE
    if device is None:   # a group this module did not start
        device = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend() == "nccl" else torch.device("cpu")
    return Mesh(world_size=world, rank=rank, device=device,
                backend=dist.get_backend(), group=dist.group.WORLD,
                axis_names=axis_names, shape=shape, axes=axes)


# the order token of the collectives of one step (ordered_collectives)
_ORDER = {"token": None}


@contextlib.contextmanager
def ordered_collectives(device):
    """Inside, every differentiable collective of this module takes the
    order token of the one before it and hands a new one on, so that in a
    backward pass each collective's node waits for the next one's: the
    ranks then meet their collectives in one order, the reverse of the
    order in which they were made.

    Without it the autograd engine picks among ready nodes by sequence
    numbers that each thread counts for itself.  A force loss's inner
    backward makes its nodes on the device's worker thread, the forward
    on the calling one, so in the outer backward the order between the
    two kinds of nodes depends on how much autograd work each thread has
    done before; ranks that did different work (one of them validated, or
    computed a reference) would then wait in different collectives."""
    before = _ORDER["token"]
    _ORDER["token"] = torch.zeros((), device=device, requires_grad=True)
    try:
        yield
    finally:
        _ORDER["token"] = before


def _chained(fn, *args):
    """``fn.apply(*args, token)``, with the order token threaded through
    where a chain is active (fn returns its output and the next token)."""
    token = _ORDER["token"]
    out, nxt = fn.apply(*args, token)
    if token is not None:
        _ORDER["token"] = nxt
    return out


def _next_token(token):
    return None if token is None else token.new_zeros(())


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of `group`; the gradient is summed the same way
    (every rank's output depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group, token):
        ctx.group, ctx.audit_label = group, _audit_label()
        out = torch.clone(x, memory_format=torch.contiguous_format)
        t0 = time.perf_counter()
        dist.all_reduce(out, group=group)
        _count(t0, out)
        return out, _next_token(token)

    @staticmethod
    def backward(ctx, grad: torch.Tensor, _token_grad):
        with _backward_of(ctx):
            return all_reduce_sum(grad, ctx.group), None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the ranks of `group`, differentiable."""
    if RECORDER is None:
        return _chained(_AllReduceSum, x, group)
    return RECORDER.collective("all_reduce", x, 0, _nbytes(x),
                               lambda: _chained(_AllReduceSum, x, group))


def all_reduce_mean_(flat: torch.Tensor, group) -> torch.Tensor:
    """`flat` replaced in place by its mean over the ranks: a SUM (gloo has
    no AVG) divided by the world size."""
    dist.all_reduce(flat, group=group)
    return flat.div_(dist.get_world_size(group))


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _count(t0: float, x: torch.Tensor) -> None:
    COLLECTIVE_STATS["calls"] += 1
    COLLECTIVE_STATS["bytes"] += _nbytes(x)
    COLLECTIVE_STATS["seconds"] += time.perf_counter() - t0


def shift_transport(x: torch.Tensor, group) -> str:
    """How :func:`ring_shift` moves `x`: ``"host-staged"`` (gloo, a CUDA
    tensor: copied to the host, sent, copied back) or ``"direct"``."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return "host-staged"
    return "direct"


def _shift(x: torch.Tensor, axis: Axis, k: int) -> torch.Tensor:
    """Rank j's `x` arrives at rank j + k (mod the axis size)."""
    d = axis.size
    if k % d == 0:
        return x.clone()
    t0 = time.perf_counter()
    staged = shift_transport(x, axis.group) == "host-staged"
    send = x.detach().contiguous()
    if staged:
        send = send.cpu()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, axis.ranks[(axis.index + k) % d],
                      axis.group),
           dist.P2POp(dist.irecv, recv, axis.ranks[(axis.index - k) % d],
                      axis.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    out = recv.to(x.device) if staged else recv
    _count(t0, send)
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, axis: Axis, k: int, token):
        ctx.axis, ctx.k, ctx.audit_label = axis, k, _audit_label()
        return _shift(x, axis, k), _next_token(token)

    @staticmethod
    def backward(ctx, g: torch.Tensor, _token_grad):
        with _backward_of(ctx):
            return ring_shift(g, ctx.axis, -ctx.k), None, None, None


def ring_shift(x: torch.Tensor, axis: Axis, k: int = 1) -> torch.Tensor:
    """The `x` of the rank k places before this one along `axis` (JAX's
    ``ppermute`` with pairs ``(j, (j + k) % d)``); differentiable, its
    backward the shift by -k."""
    if RECORDER is None or k % axis.size == 0:
        return _chained(_RingShift, x, axis, k)
    return RECORDER.collective("shift", x, k, _nbytes(x),
                               lambda: _chained(_RingShift, x, axis, k),
                               axis_size=axis.size)


def all_gather(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The axis' `x` concatenated along dim 0 in axis order (JAX's
    ``all_gather`` then reshape); differentiable, its backward the
    reduce-scatter of the cotangent (each rank's slot of its sum).

    It is the all-reduce of `x` placed in this rank's slot of zeros, so
    that it runs under gloo on CUDA tensors too."""
    n = x.shape[0]
    before = x.new_zeros((axis.index * n,) + tuple(x.shape[1:]))
    after = x.new_zeros(((axis.size - axis.index - 1) * n,)
                        + tuple(x.shape[1:]))
    if RECORDER is None:
        return all_reduce_sum(torch.cat([before, x, after]), axis.group)
    return RECORDER.collective(
        "all_gather", x, 0, _nbytes(x) * axis.size,
        lambda: _chained(_AllReduceSum, torch.cat([before, x, after]),
                         axis.group))
