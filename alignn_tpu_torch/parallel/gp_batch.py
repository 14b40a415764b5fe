"""Host-side layout of the ring-pipelined graph parallelism (counterpart of
``alignn_tpu/parallel/gp_batch.py``).

The edge space of one batch is sharded over the G ranks of a "graph" axis:

- edges: contiguous shards of the dst-sorted edge array, ``E/G`` rows a
  rank; the bond vectors ``r`` and the bond features live only on their
  owner;
- L-edges: owned by the rank holding their destination edge e2 (L-edges
  are sorted by e2, so ownership is contiguous).  Each rank's L-edges are
  regrouped by the owner shard of their SOURCE edge e1 into G step groups:
  at ring step k, rank c processes the group whose e1 lives in shard
  (c - k) mod G, the shard whose bond-message buffer has just arrived
  (:mod:`alignn_tpu_torch.parallel.gp_model`).

The index arrays are numpy, stacked on a leading rank axis ``[G, ...]``,
equal to JAX's.  :func:`ring_steps` gives one rank its row as tensors: one
:class:`~alignn_tpu_torch.graph.batch.Incidence` a ring step (the step's
src gather with its argsort, and the CSR :class:`~alignn_tpu_torch.ops.
eggc.Segments` of its sorted lg_dst columns), so that the step's sums run
through the sorted segment sum (K2 on the card).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from alignn_tpu_torch.graph.batch import Incidence, _incidence


def host(x) -> np.ndarray:
    """`x` as a numpy array (a tensor is copied off its device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclass
class RingIndex:
    """Per-rank ring-ordered L(g) index arrays (leading axis = rank).

    Ring step k occupies columns ``[offsets[k], offsets[k+1])``; the step
    widths are per step (step 0, the shard-local pairs, dominates for
    batches of small crystals).
    """

    lg_src: np.ndarray   # int32, index into the step's SOURCE shard [0, E/G)
    lg_dst: np.ndarray   # int32, index into the LOCAL edge shard [0, E/G)
    lg_mask: np.ndarray  # float32 {0, 1}
    steps: tuple = ()
    n_shards: int = 1

    @property
    def offsets(self):
        out = [0]
        for s in self.steps:
            out.append(out[-1] + s)
        return out

    @property
    def cols(self) -> int:
        return int(sum(self.steps))


def _round_up(x: int, q: int) -> int:
    return ((x + q - 1) // q) * q


def _ring_step_needs(batch, n_shards: int) -> tuple:
    """Per-step group-size maxima without building the placement."""
    d = n_shards
    e_loc = host(batch.src).shape[0] // d
    real = host(batch.lg_mask) > 0.5
    e1 = host(batch.lg_src)[real].astype(np.int64)
    e2 = host(batch.lg_dst)[real].astype(np.int64)
    step_of = ((e2 // e_loc) - (e1 // e_loc)) % d
    sizes = np.bincount((e2 // e_loc) * d + step_of,
                        minlength=d * d).reshape(d, d)
    return tuple(max(int(sizes[:, k].max()), 1) for k in range(d))


def make_ring_index(batch, n_shards: int, quantum: int = 128,
                    steps: Optional[tuple] = None) -> RingIndex:
    """Regroup the batch's L(g) into per-rank, per-ring-step blocks.

    Every real L-edge (lg_mask 1) goes to owner(e2), in that rank's step
    group k = (owner(e2) - owner(e1)) mod G; each step's block pads to the
    largest group over ranks (rounded up to `quantum`), or to the forced
    `steps`.  Within a group the L-edges sort by (e2, e1), so each step's
    destinations ascend.  Padded columns point at the shard's last edge
    with mask 0.
    """
    d = n_shards
    e_pad = host(batch.src).shape[0]
    if e_pad % d:
        raise ValueError(f"padded edge count {e_pad} % {d} != 0")
    e_loc = e_pad // d

    lg_src = host(batch.lg_src)
    lg_dst = host(batch.lg_dst)
    real = host(batch.lg_mask) > 0.5
    e1 = lg_src[real].astype(np.int64)
    e2 = lg_dst[real].astype(np.int64)
    own1 = e1 // e_loc
    own2 = e2 // e_loc
    step_of = (own2 - own1) % d

    order = np.lexsort((e1, e2, step_of, own2))
    e1, e2, own1, own2, step_of = (a[order] for a in
                                   (e1, e2, own1, own2, step_of))
    group_key = own2 * d + step_of
    sizes = np.bincount(group_key, minlength=d * d).reshape(d, d)

    if steps is None:
        steps = tuple(_round_up(max(int(sizes[:, k].max()), 1), quantum)
                      for k in range(d))
    else:
        need = tuple(int(sizes[:, k].max()) for k in range(d))
        if any(n > s for n, s in zip(need, steps)):
            raise ValueError(f"forced steps {steps} < required {need}")
    col_off = np.zeros(d + 1, dtype=np.int64)
    np.cumsum(np.asarray(steps), out=col_off[1:])
    cols = int(col_off[-1])

    ring_src = np.full((d, cols), e_loc - 1, dtype=np.int32)
    ring_dst = np.full((d, cols), e_loc - 1, dtype=np.int32)
    ring_mask = np.zeros((d, cols), dtype=np.float32)

    starts = np.zeros(d * d + 1, dtype=np.int64)
    np.cumsum(sizes.reshape(-1), out=starts[1:])
    pos_in_group = np.arange(e1.shape[0]) - starts[group_key]
    col = col_off[step_of] + pos_in_group
    ring_src[own2, col] = (e1 % e_loc).astype(np.int32)
    ring_dst[own2, col] = (e2 % e_loc).astype(np.int32)
    ring_mask[own2, col] = 1.0

    return RingIndex(lg_src=ring_src, lg_dst=ring_dst, lg_mask=ring_mask,
                     steps=tuple(int(s) for s in steps), n_shards=d)


def make_stacked_ring(rows: Sequence, n_shards: int, quantum: int = 128,
                      min_steps: Optional[tuple] = None) -> RingIndex:
    """Ring indices for the micro-batches of a (data x graph) step, one a
    data row (JAX takes them stacked ``[D, ...]``): arrays ``[D, G, ...]``.

    All rows share one per-step width tuple (the elementwise max over
    rows, floored by `min_steps`, a monotone floor a caller keeps across
    batches)."""
    needs = [_ring_step_needs(row, n_shards) for row in rows]
    steps = tuple(_round_up(max(n[k] for n in needs), quantum)
                  for k in range(n_shards))
    if min_steps is not None:
        steps = tuple(max(a, b) for a, b in zip(steps, min_steps))
    rings = [make_ring_index(row, n_shards, quantum, steps=steps)
             for row in rows]
    return RingIndex(
        lg_src=np.stack([r.lg_src for r in rings]),
        lg_dst=np.stack([r.lg_dst for r in rings]),
        lg_mask=np.stack([r.lg_mask for r in rings]),
        steps=steps, n_shards=n_shards)


@dataclass
class RingSteps:
    """One rank's row of a :class:`RingIndex` as tensors on its device:
    ``steps[k]`` indexes ring step k's columns (src into the arriving
    shard, dst its CSR over the local shard's edges), ``mask`` [cols] is
    the ring-ordered L-edge mask, ``offsets`` the column offsets."""

    steps: List[Incidence]
    mask: torch.Tensor
    offsets: List[int]
    n_shards: int


def ring_steps(ring: RingIndex, index: int, e_loc: int,
               device) -> RingSteps:
    """Rank `index`'s ring steps over a shard of `e_loc` edges."""
    off = ring.offsets
    src, dst = ring.lg_src[index], ring.lg_dst[index]
    steps = [_incidence(src[off[k]:off[k + 1]].astype(np.int64),
                        dst[off[k]:off[k + 1]].astype(np.int64),
                        e_loc, e_loc, device)
             for k in range(ring.n_shards)]
    mask = torch.as_tensor(ring.lg_mask[index]).to(device)
    return RingSteps(steps=steps, mask=mask, offsets=off,
                     n_shards=ring.n_shards)
