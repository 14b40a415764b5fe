"""Batched on-device structure relaxation: per-graph FIRE on the device.

Counterpart of ``alignn_tpu/ff/relax_jit.py`` (``batch_relax``): G
structures are padded into one GraphBatch and relaxed at once, with
per-graph FIRE state (dt, alpha, the count of downhill steps) and the
neighbour topology fixed for a chunk of steps, the bond vectors
recomputed from the positions at every step.  Positions, velocities and
the FIRE state stay on the device; the host fetches them once per chunk
and rebuilds the graphs.

On the card the FIRE step is captured once as a CUDA graph and replayed
for every step of the chunk (:class:`~alignn_tpu_torch.ff.step_loop.
StepLoop`), reused from chunk to chunk while the batch's launch sizes stay
the same; ``cuda_graph=False`` runs it eagerly, as every run on the CPU
does.  The per-graph max force is a ``scatter_reduce`` with ``amax``
(JAX's ``segment_max``).

Positions-only relaxation (no cell DOF); use ``ff.relax.fire_relax`` for
lattice co-optimization of a single structure.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from alignn_tpu_torch import resolve_device
from alignn_tpu_torch.chem.atoms import Atoms
from alignn_tpu_torch.data.loader import worst_case_spec
from alignn_tpu_torch.ff.md_jit import energy_and_forces
from alignn_tpu_torch.ff.relax import FireParams
from alignn_tpu_torch.ff.step_loop import (StepLoop, batch_signature,
                                           with_item_capacity)
from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
from alignn_tpu_torch.graph.build import build_graph
from alignn_tpu_torch.ops.segment import segment_sum


def segment_max(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Max of `values` per segment (-inf where a segment is empty)."""
    out = values.new_full((num_segments,), float("-inf"))
    return out.scatter_reduce(0, segment_ids, values, "amax",
                              include_self=True)


class FireChunk:
    """The static state of a batch's FIRE loop: positions, velocities,
    per-graph dt / alpha / downhill count, the inverse lattices, and the
    last step's energies and max forces."""

    def __init__(self, model, batch, p: FireParams,
                 cuda_graph: bool = True):
        self.model, self.batch, self.p = model, batch, p
        dev, f32 = batch.z.device, batch.frac_coords.dtype
        n, ng = batch.z.shape[0], batch.graph_mask.shape[0]
        self.frac = torch.zeros((n, 3), device=dev, dtype=f32)
        self.vel = torch.zeros((n, 3), device=dev, dtype=f32)
        self.dt = torch.zeros(ng, device=dev, dtype=f32)
        self.alpha = torch.zeros(ng, device=dev, dtype=f32)
        self.n_pos = torch.zeros(ng, device=dev, dtype=torch.int32)
        self.inv_lat = torch.zeros((ng, 3, 3), device=dev, dtype=f32)
        self.energy = torch.zeros(ng, device=dev, dtype=f32)
        self.fmax = torch.zeros(ng, device=dev, dtype=f32)
        self.loop = StepLoop(self._step, batch, cuda_graph=cuda_graph)

    def _step(self):
        b, p = self.batch, self.p
        ng, gid = b.graph_mask.shape[0], b.node_graph
        _e, forces, out = energy_and_forces(self.model, b, self.frac)
        energy = out * b.graph_mask
        v = self.vel

        def per_graph(x):
            return segment_sum(x.sum(dim=1, keepdim=True), gid, ng)[:, 0]

        pw = per_graph(forces * v)
        vnorm = torch.sqrt(per_graph(v * v))
        fnorm = torch.sqrt(torch.clamp_min(per_graph(forces * forces),
                                           1e-24))
        uphill = pw <= 0
        alpha, dt = self.alpha, self.dt
        mix = (1 - alpha)[gid, None] * v + alpha[gid, None] * forces * (
            vnorm / fnorm)[gid, None]
        v_new = torch.where(uphill[gid, None], torch.zeros_like(v), mix)
        n_pos_new = torch.where(uphill, torch.zeros_like(self.n_pos),
                                self.n_pos + 1)
        grow = (~uphill) & (n_pos_new > p.nmin)
        dt_new = torch.where(grow, torch.clamp_max(dt * p.finc, p.dtmax),
                             torch.where(uphill, dt * p.fdec, dt))
        alpha_new = torch.where(
            grow, alpha * p.fa,
            torch.where(uphill, torch.full_like(alpha, p.astart), alpha))
        v_new = v_new + dt_new[gid, None] * forces
        dr = dt_new[gid, None] * v_new
        # per-atom displacement cap
        dnorm = torch.linalg.norm(dr, dim=1, keepdim=True)
        dr = dr * torch.clamp_max(p.maxstep / torch.clamp_min(dnorm, 1e-12),
                                  1.0)
        cart = torch.einsum("ni,nij->nj", self.frac, b.lattice[gid]) + dr
        frac_new = torch.einsum("ni,nij->nj", cart, self.inv_lat[gid])
        fmax = segment_max(torch.linalg.norm(forces, dim=1) * b.node_mask,
                           gid, ng)
        self.frac.copy_(frac_new)
        self.vel.copy_(v_new)
        self.dt.copy_(dt_new)
        self.alpha.copy_(alpha_new)
        self.n_pos.copy_(n_pos_new)
        self.energy.copy_(energy)
        self.fmax.copy_(fmax)

    def run(self, batch, vel: np.ndarray, dt: np.ndarray, alpha: np.ndarray,
            n_pos: np.ndarray, n_steps: int):
        """Load `batch` (same signature) and the FIRE state, run `n_steps`;
        returns (frac, vel, dt, alpha, n_pos, energies, fmax) as numpy,
        from one fetch."""
        if batch is not self.batch:
            self.loop.load_batch(batch)
        b = self.batch
        f32 = self.frac.dtype
        lat = b.lattice.detach().cpu().numpy().astype(np.float64)
        self.inv_lat.copy_(torch.as_tensor(np.linalg.inv(lat), dtype=f32))
        self.frac.copy_(b.frac_coords)
        for dst, src in ((self.vel, vel), (self.dt, dt),
                         (self.alpha, alpha), (self.n_pos, n_pos)):
            dst.copy_(torch.as_tensor(src, dtype=dst.dtype))
        self.loop.run(n_steps)
        n, ng = b.z.shape[0], b.graph_mask.shape[0]
        parts = [self.frac.reshape(-1), self.vel.reshape(-1), self.dt,
                 self.alpha, self.n_pos.to(f32), self.energy, self.fmax]
        out = torch.cat(parts).cpu().numpy()
        sizes = np.cumsum([0, 3 * n, 3 * n, ng, ng, ng, ng, ng])
        frac, v, dt_o, alpha_o, npos_o, energy, fmax = (
            out[a:z] for a, z in zip(sizes[:-1], sizes[1:]))
        return (frac.reshape(n, 3), v.reshape(n, 3), dt_o, alpha_o,
                npos_o.astype(np.int32), energy, fmax)


def batch_relax(model, atoms_list: List[Atoms],
                fmax: float = 0.05, max_steps: int = 200,
                chunk_steps: int = 25,
                cutoff: float = 5.0, max_neighbors: int = 12,
                neighbor_strategy: str = "radius_graph",
                atom_features: str = "cgcnn",
                params: Optional[FireParams] = None,
                device=None, cuda_graph: bool = True
                ) -> Tuple[List[Atoms], np.ndarray, np.ndarray]:
    """Relax all structures simultaneously on the device.

    Returns (relaxed_atoms_list, final_energies [G], final_fmax [G]):
    the energies and max forces at the start of each chunk's last step,
    as in JAX.  Topology refreshes between chunks (``build_graph``'s
    defaults, ``tie_tol`` 0); graphs that converge keep rattling in place
    until the batch finishes.  `device` is ``cuda`` unless ``"cpu"`` is
    passed; `cuda_graph` False runs the step eagerly on the card.
    """
    device = resolve_device(device)
    model = model.to(device).eval()
    p = params or FireParams()
    cur = list(atoms_list)
    ng = len(cur)
    spec: Optional[BucketSpec] = None
    chunk: Optional[FireChunk] = None
    energies = np.zeros(ng)
    fmaxes = np.full(ng, np.inf)
    done = 0
    # persistent per-graph FIRE state across chunks
    dt_g = np.full(ng + 1, p.dt)
    alpha_g = np.full(ng + 1, p.astart)
    npos_g = np.zeros(ng + 1, dtype=np.int32)
    vel: Optional[np.ndarray] = None
    while done < max_steps:
        graphs = [build_graph(a, neighbor_strategy=neighbor_strategy,
                              cutoff=cutoff, max_neighbors=max_neighbors)
                  for a in cur]
        if spec is None:
            spec = worst_case_spec(graphs, ng, slack=1.4)
            spec = BucketSpec(n_nodes=spec.n_nodes, n_edges=spec.n_edges,
                              n_lg_edges=spec.n_lg_edges, n_graphs=ng + 1)
        batch = with_item_capacity(batch_graphs(
            graphs, spec, device, atom_features=atom_features,
            gather_windows=False))
        n_pad = batch.z.shape[0]
        if vel is None or vel.shape[0] != n_pad:
            vel = np.zeros((n_pad, 3))
        if chunk is None or chunk.loop.signature != batch_signature(batch):
            chunk = None                # frees the old graph's memory
            chunk = FireChunk(model, batch, p, cuda_graph=cuda_graph)
        frac, vel, dt_g, alpha_g, npos_g, es, fs = chunk.run(
            batch, vel, dt_g, alpha_g, npos_g, chunk_steps)
        energies = es[:ng].astype(np.float64)
        fmaxes = fs[:ng].astype(np.float64)
        off = 0
        new_cur = []
        for a in cur:
            n = a.num_atoms
            new_cur.append(a.with_positions(frac_coords=frac[off:off + n]))
            off += n
        cur = new_cur
        done += chunk_steps
        if (fmaxes < fmax).all():
            break
    return cur, energies, fmaxes
