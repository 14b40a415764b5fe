"""Records to graphs, and the in-memory graph dataset.

Counterpart of the in-memory part of ``alignn_tpu/data/dataset.py``.  A
*record* is a plain dict in the reference's schema: ``{"jid": ...,
"atoms": {...}, "target": ... [, "atomwise_target", "atomwise_grad",
"stresses", "additional"]}``, where ``atoms`` is a jarvis-schema dict
(:meth:`~alignn_tpu_torch.chem.atoms.Atoms.from_dict`) or an
:class:`~alignn_tpu_torch.chem.atoms.Atoms`.

Not here yet: the folder reader (``load_folder_records``, which needs a
POSCAR reader), the on-disk graph cache and its lazy view, and the
process pool.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from alignn_tpu_torch.chem.atoms import Atoms
from alignn_tpu_torch.graph.build import GraphData, build_graph


def voigt_6_to_full_3x3_stress(v) -> np.ndarray:
    """Voigt 6-vector (xx, yy, zz, yz, xz, xy) -> symmetric 3x3 stress."""
    s_xx, s_yy, s_zz, s_yz, s_xz, s_xy = [float(x) for x in v]
    return np.array([[s_xx, s_xy, s_xz],
                     [s_xy, s_yy, s_yz],
                     [s_xz, s_yz, s_zz]])


def filter_records(records: Sequence[Dict[str, Any]], target: str = "target",
                   classification_threshold: Optional[float] = None,
                   target_multiplication_factor: Optional[float] = None
                   ) -> List[Dict[str, Any]]:
    """Drop records whose scalar target is None, "na" or NaN; scale and
    threshold the rest.  Vector targets pass unchanged."""
    out = []
    for rec in records:
        t = rec[target]
        if isinstance(t, (list, np.ndarray)):
            out.append(rec)
            continue
        if t is None or t == "na" or (isinstance(t, float) and math.isnan(t)):
            continue
        t = float(t)
        if target_multiplication_factor is not None:
            t = t * target_multiplication_factor
        if classification_threshold is not None:
            t = 0 if t <= classification_threshold else 1
        rec = dict(rec)
        rec[target] = t
        out.append(rec)
    return out


def _build_one(rec: Dict[str, Any], kwargs: Dict[str, Any]) -> GraphData:
    if "extra_features" in rec:
        raise NotImplementedError("extra_features are not ported yet: the "
                                  "port's model refuses them")
    atoms = rec["atoms"]
    if not isinstance(atoms, Atoms):
        atoms = Atoms.from_dict(atoms)
    g = build_graph(atoms, **kwargs)
    t = rec.get("target")
    if t is not None:
        g.target = np.atleast_1d(np.asarray(t, dtype=np.float64))
    if "atomwise_target" in rec:
        g.atomwise_target = np.asarray(
            rec["atomwise_target"], dtype=np.float64).reshape(
            atoms.num_atoms, -1)
    if "atomwise_grad" in rec:
        g.forces = np.asarray(rec["atomwise_grad"],
                              dtype=np.float64).reshape(-1, 3)
    if "stresses" in rec:
        g.stress = np.asarray(rec["stresses"], dtype=np.float64).reshape(3, 3)
    if "additional" in rec:
        g.additional = np.asarray(rec["additional"],
                                  dtype=np.float64).reshape(-1)
    return g


def records_to_graphs(records: Sequence[Dict[str, Any]],
                      neighbor_strategy: str = "k-nearest",
                      cutoff: float = 8.0, max_neighbors: int = 12,
                      use_canonize: bool = True,
                      compute_line_graph: bool = True,
                      cutoff_extra: float = 3.0,
                      lg_cutoff: Optional[float] = None) -> List[GraphData]:
    """One labelled graph per record, in record order (serial)."""
    kwargs = dict(neighbor_strategy=neighbor_strategy, cutoff=cutoff,
                  max_neighbors=max_neighbors, use_canonize=use_canonize,
                  compute_line_graph=compute_line_graph,
                  cutoff_extra=cutoff_extra, lg_cutoff=lg_cutoff)
    return [_build_one(rec, kwargs) for rec in records]


@dataclass
class GraphDataset:
    """Graphs, their ids and the target standardisation applied to them.

    ``metadata`` may hold ``counts`` (per graph: nodes, edges, L-edges and
    optionally the max in-degree), with which the loader sizes its bucket
    without reading the graphs, and ``targets``.
    """

    graphs: List[GraphData]
    ids: List[str]
    target_mean: float = 0.0
    target_std: float = 1.0
    metadata: Dict[str, Any] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.graphs)

    def targets(self) -> np.ndarray:
        if "targets" in self.metadata:
            return np.stack([np.atleast_1d(np.asarray(t, dtype=np.float64))
                             for t in self.metadata["targets"]])
        return np.stack([np.atleast_1d(g.target) for g in self.graphs])

    def scale_targets(self, mean: float, std: float) -> "GraphDataset":
        """(t - mean) / std on every target; the recorded mean and std
        compose with earlier scalings, so they always invert the total."""
        std = std if std > 0 else 1.0
        for g in self.graphs:
            if g.target is not None:    # force-only records have none
                g.target = (np.atleast_1d(g.target) - mean) / std
        if "targets" in self.metadata:
            self.metadata["targets"] = [
                ((np.atleast_1d(np.asarray(t, np.float64)) - mean)
                 / std).tolist() for t in self.metadata["targets"]]
        prev_mean = self.target_mean or 0.0
        prev_std = self.target_std or 1.0
        self.target_mean = prev_mean + mean * prev_std
        self.target_std = prev_std * std
        return self

    def standardize_from(self, other: Optional["GraphDataset"] = None
                         ) -> "GraphDataset":
        """Scale own targets by the mean and std of `other`'s (the training
        split), or of its own."""
        y = (other if other is not None else self).targets()
        return self.scale_targets(float(np.mean(y)), float(np.std(y)))

    def mad(self) -> float:
        """Mean absolute deviation of the targets."""
        y = self.targets()
        return float(np.mean(np.abs(y - np.mean(y))))
