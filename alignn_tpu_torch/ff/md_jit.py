"""On-device MD: chunks of velocity-Verlet steps that stay on the device.

Counterpart of ``alignn_tpu/ff/md_jit.py`` (``run_md_jit``).  The
neighbour indices are frozen for a chunk of `chunk_steps` steps; inside
the chunk the bond vectors are recomputed from the positions at every
step (:func:`~alignn_tpu_torch.nn.models.compute_cartesian_r`), so the
forces track the moving atoms exactly.  Positions, velocities, forces,
the per-step energies and the random state stay on the device, and the
host fetches them once per chunk, then rebuilds the graph.

On the card the step (positions from velocities, energy, ``autograd.grad``
on the bond vectors, force sums, the velocity update, Langevin noise) is
captured once as a CUDA graph and replayed for every step of the chunk
(:class:`~alignn_tpu_torch.ff.step_loop.StepLoop`), the counterpart of the
JAX package's ``lax.scan`` inside one ``jit``; the captured graph is
reused from chunk to chunk while the batch's launch sizes stay the same.
``cuda_graph=False`` runs the same step eagerly, as every run on the CPU
does.

With ``chunk_steps=1`` this reproduces the host loop
(:func:`alignn_tpu_torch.ff.md.run_md`) step for step.  Larger chunks trade
the frozen-topology approximation (valid while intra-chunk motion stays
small against the cutoff shell) for fewer host round trips.

Langevin noise comes from a ``torch.Generator`` seeded from `seed` (on the
run's device), not from ``jax.random``: NVE trajectories match the JAX
package's, Langevin ones only in their statistics.  Forces are summed with
``index_add``, whose atomics vary at the ulp level from run to run on the
card.

Units match :mod:`alignn_tpu_torch.ff.md` (eV / Angstrom / amu, fs input).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from alignn_tpu_torch import resolve_device
from alignn_tpu_torch.chem.atoms import Atoms, atomic_masses
from alignn_tpu_torch.ff.md import FS, KB, MDLog, maxwell_boltzmann_velocities
from alignn_tpu_torch.ff.step_loop import (StepLoop, batch_signature,
                                           with_item_capacity)
from alignn_tpu_torch.graph import dense as gdense
from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
from alignn_tpu_torch.graph.build import build_graph
from alignn_tpu_torch.nn.models import compute_cartesian_r
from alignn_tpu_torch.ops.eggc import permute_rows
from alignn_tpu_torch.ops.segment import segment_sum


def energy_and_forces(model, batch, frac: torch.Tensor):
    """(summed energy, forces [N, 3], the model's ``out`` [G]) at
    fractional coordinates `frac`: the forces are the gradient of the
    energy with respect to the bond vectors, summed into the atoms
    (in-edges minus out-edges), padded atoms 0.  The dense layout sums
    blocks (in-edges of node i are block i, its out-edges the rev of
    block i), as ``atomwise_forward`` does."""
    r = compute_cartesian_r(batch, frac_coords=frac).detach() \
        .requires_grad_(True)
    with torch.enable_grad():
        res = model(batch, r)
        energy = torch.sum(res["en_out"] * batch.graph_mask)
        (g_r,) = torch.autograd.grad(energy, r)
    pair = -g_r
    n = batch.z.shape[0]
    if batch.dense_D:
        D = batch.dense_D
        forces = (pair.reshape(n, D, 3).sum(dim=1)
                  - permute_rows(pair, batch.rev, batch.rev)
                  .reshape(n, D, 3).sum(dim=1))
    else:
        forces = (segment_sum(pair, batch.dst, n)
                  - segment_sum(pair, batch.src, n))
    return (energy.detach(), forces * batch.node_mask[:, None],
            res["out"][:, 0].detach())


class MDChunk:
    """The static state of one batch layout and its step loop.

    Holds positions, velocities, forces, masses, the inverse lattice and
    the per-step energy buffers of up to `max_steps` steps on the device;
    :meth:`run` advances them by a chunk.
    """

    def __init__(self, model, batch, dt: float, ensemble: str,
                 temperature_K: float, friction: float, max_steps: int,
                 generator: torch.Generator, cuda_graph: bool = True):
        self.model = model
        self.batch = batch
        dev, f32 = batch.z.device, batch.frac_coords.dtype
        n = batch.z.shape[0]

        def zeros(*shape, dtype=f32):
            return torch.zeros(shape, device=dev, dtype=dtype)

        self.frac, self.vel, self.forces = zeros(n, 3), zeros(n, 3), \
            zeros(n, 3)
        self.masses, self.inv_mass, self.noise_scale = zeros(n), zeros(n), \
            zeros(n)
        self.inv_lat = zeros(3, 3)
        self.epots, self.ekins = zeros(max_steps), zeros(max_steps)
        self.k = zeros(1, dtype=torch.int64)
        self.langevin = ensemble == "nvt_langevin"
        self.dt = dt
        self.c1 = math.exp(-(friction / FS) * dt)
        self.temperature_K = temperature_K
        self.generator = generator
        self.loop = StepLoop(
            self._step, batch,
            generators=[generator] if self.langevin else (),
            cuda_graph=cuda_graph)

    def _step(self):
        b = self.batch
        mask = b.node_mask[:, None]
        inv_m = self.inv_mass[:, None]
        vel = self.vel
        if self.langevin:
            noise = torch.randn(vel.shape, generator=self.generator,
                                device=vel.device, dtype=vel.dtype)
            vel = self.c1 * vel + noise * self.noise_scale[:, None] * mask
        v_half = vel + 0.5 * self.dt * self.forces * inv_m
        cart = self.frac @ b.lattice[0] + self.dt * v_half
        frac_new = cart @ self.inv_lat
        epot, forces_new, _out = energy_and_forces(self.model, b, frac_new)
        vel_new = v_half + 0.5 * self.dt * forces_new * inv_m
        ekin = 0.5 * torch.sum(self.masses[:, None] * vel_new ** 2)
        self.frac.copy_(frac_new)
        self.vel.copy_(vel_new)
        self.forces.copy_(forces_new)
        # the slot wraps, so a loop run on past `max_steps` stays in bounds
        slot = torch.remainder(self.k, self.epots.shape[0])
        self.epots.index_copy_(0, slot, epot.reshape(1))
        self.ekins.index_copy_(0, slot, ekin.reshape(1))
        self.k.add_(1)

    def run(self, batch, masses: np.ndarray, vel: np.ndarray, n_run: int):
        """Load `batch` (same signature) with the host state, run `n_run`
        steps; returns (frac [N, 3], vel [N, 3], epots [n_run],
        ekins [n_run]) as numpy, from one fetch."""
        if batch is not self.batch:
            self.loop.load_batch(batch)
        b = self.batch
        n = b.z.shape[0]
        dev, f32 = b.z.device, self.frac.dtype
        m = torch.as_tensor(masses, dtype=f32).to(dev)
        self.masses.copy_(m)
        self.inv_mass.copy_(torch.where(
            m > 0, 1.0 / torch.clamp_min(m, 1e-9), torch.zeros_like(m)))
        self.noise_scale.copy_(
            torch.sqrt(KB * self.temperature_K * self.inv_mass)
            * math.sqrt(1 - self.c1 ** 2))
        lat = b.lattice[0].detach().cpu().numpy().astype(np.float64)
        self.inv_lat.copy_(torch.as_tensor(np.linalg.inv(lat), dtype=f32))
        self.vel.copy_(torch.as_tensor(vel, dtype=f32))
        self.frac.copy_(b.frac_coords)
        self.k.zero_()
        forces0 = energy_and_forces(self.model, b, self.frac)[1]
        self.forces.copy_(forces0)
        self.loop.run(n_run)
        # one fetch for the whole chunk
        out = torch.cat([self.frac.reshape(-1), self.vel.reshape(-1),
                         self.epots[:n_run], self.ekins[:n_run]]).cpu() \
            .numpy()
        return (out[:3 * n].reshape(n, 3), out[3 * n:6 * n].reshape(n, 3),
                out[6 * n:6 * n + n_run], out[6 * n + n_run:])


BUCKET_SLACK = 1.4


def sparse_spec(g, slack: float = BUCKET_SLACK) -> BucketSpec:
    """The sparse bucket of a one-graph chunk (JAX's ``_sparse_batch``):
    each count grown by `slack` and rounded up, nodes and edges to 128,
    L-edges to 512, with the padding graph."""
    def up(x: int, quantum: int) -> int:
        return ((int(x * slack) + quantum) // quantum) * quantum

    return BucketSpec(n_nodes=up(g.num_nodes, 128),
                      n_edges=up(g.num_edges, 128),
                      n_lg_edges=up(g.num_lg_edges, 512), n_graphs=2)


def run_md_jit(model, atoms: Atoms,
               steps: int = 1000,
               timestep_fs: float = 1.0,
               ensemble: str = "nve",
               temperature_K: float = 300.0,
               friction: float = 0.02,
               initial_temperature_K: Optional[float] = None,
               cutoff: float = 5.0,
               max_neighbors: int = 12,
               neighbor_strategy: str = "radius_graph",
               chunk_steps: int = 25,
               seed: int = 0,
               atom_features: str = "cgcnn",
               bucket_slack: float = BUCKET_SLACK,
               dense: bool = False,
               device=None,
               cuda_graph: bool = True) -> Tuple[Atoms, MDLog]:
    """Run MD in on-device chunks; returns (final atoms, log).

    ensembles: nve | nvt_langevin.  The graph (and bucket) is rebuilt
    between chunks with :func:`build_graph`'s defaults (``tie_tol`` 0),
    as in JAX; topology is frozen within a chunk.  `dense=True` runs the
    dense-neighbourhood layout; a chunk whose edge set lacks the reverse
    involution runs the sparse layout (JAX's semantics).  `device` is
    ``cuda`` unless ``"cpu"`` is passed; `cuda_graph` False runs the
    step eagerly on the card.
    """
    if ensemble not in ("nve", "nvt_langevin"):
        raise ValueError(f"run_md_jit supports nve|nvt_langevin, "
                         f"got {ensemble}")
    device = resolve_device(device)
    model = model.to(device).eval()
    dt = timestep_fs * FS
    masses_np = atomic_masses()[atoms.atomic_numbers]
    t0 = initial_temperature_K if initial_temperature_K is not None \
        else temperature_K
    vel_np = maxwell_boltzmann_velocities(atoms, t0, seed)
    generator = torch.Generator(device=device).manual_seed(seed)
    log = MDLog()

    spec: Optional[BucketSpec] = None
    sp_spec: Optional[BucketSpec] = None   # the sparse detour's bucket
    chunks = {}                            # layout -> MDChunk
    dense_warned = False
    done = 0
    cur = atoms

    def sparse_batch(g):
        nonlocal sp_spec
        if sp_spec is None or g.num_nodes >= sp_spec.n_nodes or \
                g.num_edges >= sp_spec.n_edges or \
                g.num_lg_edges >= sp_spec.n_lg_edges:
            sp_spec = sparse_spec(g, bucket_slack)
        return batch_graphs([g], sp_spec, device,
                            atom_features=atom_features,
                            gather_windows=False), "sparse"

    while done < steps:
        g = build_graph(cur, neighbor_strategy=neighbor_strategy,
                        cutoff=cutoff, max_neighbors=max_neighbors)
        if dense:
            if spec is None or g.num_nodes >= spec.n_nodes or \
                    gdense.max_in_degree([g]) > spec.dense_D:
                spec = gdense.dense_spec_with_slack(
                    g, bucket_slack=bucket_slack)
            try:
                batch, layout = gdense.dense_batch_graphs(
                    [g], spec, device, atom_features=atom_features), "dense"
            except gdense.AsymmetricEdgesError:
                # thermal motion can break the reverse involution (a bond
                # within an ulp of the radius cutoff): this chunk runs the
                # sparse layout
                if not dense_warned:
                    print("[md_jit] asymmetric edge set this chunk; "
                          "using the sparse layout for it")
                    dense_warned = True
                batch, layout = sparse_batch(g)
        else:
            batch, layout = sparse_batch(g)
        batch = with_item_capacity(batch)
        n_pad = batch.z.shape[0]
        masses = np.zeros(n_pad)
        masses[: cur.num_atoms] = masses_np
        vel = np.zeros((n_pad, 3))
        vel[: cur.num_atoms] = vel_np
        n_run = min(chunk_steps, steps - done)
        chunk = chunks.get(layout)
        if chunk is None or chunk.loop.signature != batch_signature(batch):
            chunks.pop(layout, None)    # frees the old graph's memory
            chunk = chunks[layout] = MDChunk(
                model, batch, dt, ensemble, temperature_K, friction,
                chunk_steps, generator, cuda_graph=cuda_graph)
        frac_h, vel_h, epots, ekins = chunk.run(batch, masses, vel, n_run)
        n_at = cur.num_atoms
        vel_np = vel_h[:n_at]
        cur = cur.with_positions(frac_coords=frac_h[:n_at])
        # every step's energies came back: one log row per step (run_md
        # parity)
        for k in range(n_run):
            log.append(done + k + 1, (done + k + 1) * timestep_fs,
                       float(epots[k]), float(ekins[k]),
                       float(2 * ekins[k] / (3 * n_at * KB)))
        done += n_run
    return cur, log
