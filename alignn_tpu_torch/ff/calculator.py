"""Model-backed calculator: energy / forces / stress for one structure.

Counterpart of ``alignn_tpu/ff/calculator.py`` (``Calculator``):
structure -> graph (k-NN or radius, with skin reuse for radius
strategies) -> one-graph padded bucket, sparse or dense-neighbourhood
(graph/dense.py) -> :func:`atomwise_forward` (or for eALIGNN
:func:`~alignn_tpu_torch.nn.ealignn.ealignn_forward`) -> E/F/S.  Runs on
``cuda`` unless ``device="cpu"`` is passed.  :class:`iCalculator` adds a
second, property model's per-atom charges and magnetic moments and its
named properties.

``dense`` (default: the config's ``dense_neighborhoods``) asks for the
dense layout, routed as the JAX Calculator routes it: a graph with an
in-degree above 20 or an edge occupancy of its D-blocks below 0.4 runs
sparse (with a printed reason), and so does, for that call only, a graph
without the reverse-edge involution.  k-NN graphs built with
``use_canonize: false`` carry duplicated edges (in-degree 27-32 for
12-NN Si), so they run sparse.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from alignn_tpu_torch import resolve_device
from alignn_tpu_torch.chem.atoms import Atoms
from alignn_tpu_torch.graph import dense as gdense
from alignn_tpu_torch.graph.batch import BucketSpec, GraphBatch, batch_graphs
from alignn_tpu_torch.graph.build import (GraphData, build_graph,
                                          line_graph_edges, wrap_frac)
from alignn_tpu_torch.nn.ealignn import eALIGNNAtomWise, ealignn_forward
from alignn_tpu_torch.nn.models import EV_A3_TO_GPA, atomwise_forward


def full_3x3_to_voigt_6_stress(s: np.ndarray) -> np.ndarray:
    """ASE-ordering Voigt: [xx, yy, zz, yz, xz, xy]."""
    s = np.asarray(s)
    return np.array([s[0, 0], s[1, 1], s[2, 2],
                     (s[1, 2] + s[2, 1]) / 2,
                     (s[0, 2] + s[2, 0]) / 2,
                     (s[0, 1] + s[1, 0]) / 2])


def _round_up(x: int, q: int) -> int:
    return ((x + q - 1) // q) * q


class Calculator:
    """Energy/forces/stress from a trained atomwise model.

    `intensive` multiplies the per-atom energy by natoms,
    `force_multiplier`/`force_mult_natoms`/`force_mult_batchsize` scale the
    forces, `stress_wt` scales the Voigt stress (eV/A^3).
    """

    def __init__(self, path: Optional[str] = None, model=None,
                 config: Optional[Dict[str, Any]] = None,
                 intensive: bool = True, force_multiplier: float = 1.0,
                 force_mult_natoms: bool = False, stress_wt: float = 1.0,
                 bucket_slack: float = 1.3, skin: float = 0.3,
                 force_mult_batchsize: bool = False,
                 tie_tol: float = 1e-6, dense: Optional[bool] = None,
                 device=None):
        self.device = resolve_device(device)
        if model is None:
            if path is None:
                raise ValueError("pass a model directory `path` or a model")
            from alignn_tpu_torch.zoo import load_model_dir

            model, config = load_model_dir(path, self.device)
        model = model.to(self.device).eval()
        self.config = config or {}
        # reference parity: a checkpoint trained with stresswise_weight=0
        # would return all-zero stress; the reference patches the weight
        # to 0.1 (stress comes from the same gradient, no parameter moves)
        # on a model object of its own, as the reference builds one: it
        # holds the caller's parameter tensors themselves (assigned, not
        # copied), and the caller's module, cfg and hooks stay as they were
        cfg = model.cfg
        if cfg.stresswise_weight == 0 and cfg.calculate_gradient:
            own = type(model)(dataclasses.replace(cfg, stresswise_weight=0.1))
            own.to(self.device).load_state_dict(
                model.state_dict(keep_vars=True), assign=True)
            model = own.eval()
        self.model = model
        self.intensive = intensive
        self.force_multiplier = force_multiplier
        self.force_mult_natoms = force_mult_natoms
        # off by default: the reference multiplies forces by the training
        # batch size, a training artifact rather than physics
        self.force_mult_batchsize = force_mult_batchsize
        self.stress_wt = stress_wt
        self.bucket_slack = bucket_slack
        if dense is None:
            dense = bool(self.config.get("dense_neighborhoods", False))
        self.dense = bool(dense)
        self._dense_warned = False
        self._spec: Optional[BucketSpec] = None
        # the sparse bucket of a dense calculator's detours
        self._fb_spec: Optional[BucketSpec] = None
        self._results: Optional[Dict[str, Any]] = None
        # skin-radius neighbour-list reuse (radius strategies): the
        # candidate set is built with cutoff+skin and reused while no atom
        # has moved skin/2 since that build
        self.skin = float(skin)
        self._nl_graph: Optional[GraphData] = None
        self._nl_cart0 = None
        self._nl_lat0 = None
        sb = self.config.get("species_baseline") or {}
        self.species_baseline = sb.get("elements") if isinstance(
            sb, dict) else None
        self.neighbor_strategy = self.config.get(
            "neighbor_strategy", "radius_graph")
        # scale-invariant k-NN shell ties (0.0 is the training value)
        self.tie_tol = float(tie_tol)
        lgc = self.config.get("lg_cutoff")
        self.lg_cutoff = float(lgc) if lgc is not None else None
        self.cutoff = float(self.config.get("cutoff", 8.0))
        self.max_neighbors = int(self.config.get("max_neighbors", 12))
        self.use_canonize = bool(self.config.get("use_canonize", True))
        self.atom_features = self.config.get("atom_features", "cgcnn")

    # -- graph --------------------------------------------------------------

    def _build(self, atoms: Atoms, cutoff: float,
               compute_line_graph: bool = True) -> GraphData:
        return build_graph(
            atoms, neighbor_strategy=self.neighbor_strategy, cutoff=cutoff,
            max_neighbors=self.max_neighbors,
            use_canonize=self.use_canonize,
            compute_line_graph=compute_line_graph, tie_tol=self.tie_tol,
            lg_cutoff=self.lg_cutoff)

    def _filtered(self, atoms: Atoms, gc: GraphData,
                  r: np.ndarray) -> Optional[GraphData]:
        """The candidate edges within the true cutoff, or None when an atom
        is left isolated (a fresh build would then extend its cutoff)."""
        keep = np.linalg.norm(r, axis=1) <= self.cutoff
        src, dst = gc.src[keep], gc.dst[keep]
        covered = np.zeros(atoms.num_atoms, dtype=bool)
        covered[src] = True
        covered[dst] = True
        if not covered.all() or not keep.any():
            return None
        lg_src, lg_dst = line_graph_edges(src, dst, atoms.num_atoms)
        if self.lg_cutoff is not None:
            short = np.linalg.norm(r[keep], axis=1) <= self.lg_cutoff
            sel = short[lg_src] & short[lg_dst]
            lg_src, lg_dst = lg_src[sel], lg_dst[sel]
        return GraphData(
            z=gc.z, frac_coords=atoms.frac_coords.astype(np.float64),
            lattice=atoms.lattice_mat.astype(np.float64),
            volume=atoms.volume, src=src, dst=dst, r=r[keep],
            images=gc.images[keep], lg_src=lg_src, lg_dst=lg_dst)

    def graph_for(self, atoms: Atoms) -> GraphData:
        """The structure's graph, reusing the candidate set of radius
        strategies while no atom has moved skin/2."""
        # wrap into [0, 1) first, as build_graph does: the cached candidate
        # images were computed against wrapped coordinates
        frac = np.asarray(atoms.frac_coords)
        if frac.size and (frac.min() < 0.0 or frac.max() >= 1.0):
            atoms = Atoms(lattice_mat=atoms.lattice_mat,
                          frac_coords=wrap_frac(frac),
                          elements=atoms.elements)
        if not (self.skin > 0 and self.neighbor_strategy.startswith(
                "radius")):
            # k-nearest rebuilds every call: its edge set depends on the
            # distance order, not on a fixed radius
            return self._build(atoms, self.cutoff)
        cart = atoms.cart_coords
        gc = self._nl_graph
        if (gc is not None and self._nl_cart0.shape == cart.shape
                and np.array_equal(gc.z, atoms.atomic_numbers)
                and np.allclose(self._nl_lat0, atoms.lattice_mat, atol=1e-12)
                and np.linalg.norm(cart - self._nl_cart0, axis=1).max()
                < self.skin / 2):
            r = cart[gc.dst] + gc.images @ atoms.lattice_mat - cart[gc.src]
            g = self._filtered(atoms, gc, r)
            if g is not None:
                return g
        gc = self._build(atoms, self.cutoff + self.skin,
                         compute_line_graph=False)
        g = self._filtered(atoms, gc, gc.r)
        if g is None:
            self._nl_graph = None
            return self._build(atoms, self.cutoff)
        self._nl_graph = gc
        self._nl_cart0 = cart.copy()
        self._nl_lat0 = atoms.lattice_mat.copy()
        return g

    def bucket_for(self, g: GraphData) -> BucketSpec:
        """The padded sparse bucket: reused while the graph fits, grown
        (with slack) when it overflows.  A dense calculator keeps the
        bucket of its sparse detours apart from its dense one."""
        attr = "_fb_spec" if self.dense else "_spec"
        spec = getattr(self, attr)
        if (spec is None or g.num_nodes >= spec.n_nodes
                or g.num_edges >= spec.n_edges
                or g.num_lg_edges >= spec.n_lg_edges):
            s = self.bucket_slack
            spec = BucketSpec(
                n_nodes=_round_up(int(g.num_nodes * s) + 1, 128),
                n_edges=_round_up(int(g.num_edges * s) + 1, 128),
                n_lg_edges=_round_up(int(g.num_lg_edges * s) + 1, 512),
                n_graphs=2)
            setattr(self, attr, spec)
        return spec

    def _dense_bucket(self, g: GraphData, indeg: int) -> BucketSpec:
        """The dense bucket (node slack, degree headroom 2): reused while
        the graph fits, rebuilt when it has as many nodes or a larger
        in-degree."""
        spec = self._spec
        if (spec is None or not spec.dense_D or g.num_nodes >= spec.n_nodes
                or indeg > spec.dense_D):
            spec = self._spec = gdense.dense_spec_with_slack(
                g, bucket_slack=self.bucket_slack)
        return spec

    def _warn_once(self, msg: str):
        if not self._dense_warned:
            print(f"[calculator] {msg}; using sparse")
            self._dense_warned = True

    def batch_for(self, g: GraphData) -> GraphBatch:
        """The padded one-graph batch on the calculator's device, in the
        dense layout when it is asked for and suits the graph."""
        if self.dense:
            D = gdense.max_in_degree([g])
            occ = g.num_edges / max(g.num_nodes * max(D, 1), 1)
            if D > 20 or occ < 0.4:
                # N*D^2 pair rows at low occupancy cost more than they save
                self._warn_once(
                    f"dense layout skipped: in-degree {D} / occupancy "
                    f"{occ:.2f} would waste the D^2 padding (k-NN builds "
                    f"are the dense target)")
            else:
                spec = self._dense_bucket(g, D)
                try:
                    return gdense.dense_batch_graphs(
                        [g], spec, self.device,
                        atom_features=self.atom_features)
                except gdense.AsymmetricEdgesError as exc:
                    # a property of this structure: the next one may run
                    # dense again.  Other ValueErrors are broken
                    # invariants and propagate.
                    self._warn_once(f"dense layout unavailable for this "
                                    f"structure ({exc})")
        # no gather windows: an evolving structure's index spans move from
        # step to step (JAX's Calculator passes gather_windows=False too)
        return batch_graphs([g], self.bucket_for(g), self.device,
                            atom_features=self.atom_features,
                            gather_windows=False)

    # -- calculation --------------------------------------------------------

    def forward(self, batch: GraphBatch) -> Dict[str, torch.Tensor]:
        """The model's E/F/S forward on a batch."""
        if isinstance(self.model, eALIGNNAtomWise):
            return ealignn_forward(self.model, batch)
        return atomwise_forward(self.model, batch)

    def calculate(self, atoms: Atoms) -> Dict[str, Any]:
        batch = self.batch_for(self.graph_for(atoms))
        res = self.forward(batch)
        out = res["out"].detach().cpu().numpy()
        grad = res["grad"].detach().cpu().numpy()
        stress = res["stresses"].detach().cpu().numpy()
        n = atoms.num_atoms
        energy = float(out[0, 0])
        if self.intensive:
            energy *= n
        if self.species_baseline:
            energy += float(sum(self.species_baseline.get(el, 0.0)
                                for el in atoms.elements))
        forces = grad[:n] * self.force_multiplier
        if self.force_mult_natoms:
            forces = forces * n
        if self.force_mult_batchsize:
            forces = forces * int(self.config.get("batch_size", 1))
        stress_3x3 = stress[0] * self.stress_wt / EV_A3_TO_GPA
        self._results = {
            "energy": energy,
            "forces": forces,
            "stress": full_3x3_to_voigt_6_stress(stress_3x3),
            "stress_3x3": stress_3x3,
        }
        return self._results

    def get_potential_energy(self, atoms: Atoms) -> float:
        return self.calculate(atoms)["energy"]

    def get_forces(self, atoms: Atoms) -> np.ndarray:
        return self.calculate(atoms)["forces"]

    def get_stress(self, atoms: Atoms) -> np.ndarray:
        """Voigt-6 stress in eV/A^3 (ASE convention)."""
        return self.calculate(atoms)["stress"]


DEFAULT_IPROPS = [
    "cbm", "vbm", "gap", "efermi", "optb88vdw_bandgap", "mbj_bandgap",
    "spillage", "slme", "bulk_modulus_kv", "shear_modulus_gv",
    "n-Seebeck", "n-powerfact", "avg_elec_mass", "avg_hole_mass",
    "epsx", "mepsx", "max_efg", "dfpt_piezo_max_dielectric",
    "dfpt_piezo_max_dij", "exfoliation_energy", "Tc_supercon",
    "magmom_oszicar",
]


class iCalculator(Calculator):
    """Two models: a force field for energy, forces and stress, and a
    multi-head property model (``prop_path``) whose atomwise head gives
    per-atom charges (column 0) and magnetic moments (column 1) and whose
    additional head gives the properties named by `props` (default
    :data:`DEFAULT_IPROPS`).  A negative property whose name contains
    "gap" is clamped to 0.  The property model sees a graph built with its
    own strategy, cutoff, neighbour count and ``use_canonize``, in its own
    bucket (counterpart of JAX's ``iCalculator``)."""

    def __init__(self, ff_path: Optional[str] = None,
                 prop_path: Optional[str] = None, stress_wt: float = 0.05,
                 props=None, **kw):
        super().__init__(path=ff_path, stress_wt=stress_wt, **kw)
        self.props = props or list(DEFAULT_IPROPS)
        self._prop_calc = None
        if prop_path is not None:
            self._prop_calc = Calculator(path=prop_path, device=self.device)

    def calculate(self, atoms: Atoms) -> Dict[str, Any]:
        results = dict(super().calculate(atoms))
        pc = self._prop_calc
        if pc is not None:
            g = build_graph(atoms, neighbor_strategy=pc.neighbor_strategy,
                            cutoff=pc.cutoff,
                            max_neighbors=pc.max_neighbors,
                            use_canonize=pc.use_canonize)
            res = atomwise_forward(pc.model, pc.batch_for(g))
            n = atoms.num_atoms
            atomwise = res["atomwise_pred"].detach().cpu().numpy()[:n]
            if atomwise.shape[1] >= 2:
                results["charges"] = atomwise[:, 0].tolist()
                results["magmoms"] = atomwise[:, 1].tolist()
            additional = res["additional"].detach().cpu().numpy()[0]
            for name, val in zip(self.props, additional):
                v = float(val)
                if "gap" in name and v < 0:
                    v = 0.0
                results[name] = v
        self._results = results
        return results
