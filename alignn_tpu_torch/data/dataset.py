"""Records to graphs: the folder reader, the graph builds and the dataset.

Counterpart of ``alignn_tpu/data/dataset.py``.  A *record* is a plain
dict in the reference's schema: ``{"jid": ..., "atoms": {...}, "target":
... [, "atomwise_target", "atomwise_grad", "stresses", "additional"]}``,
where ``atoms`` is a jarvis-schema dict
(:meth:`~alignn_tpu_torch.chem.atoms.Atoms.from_dict`) or an
:class:`~alignn_tpu_torch.chem.atoms.Atoms`.

- :func:`load_folder_records` reads ``id_prop.{csv,json,json.zip}`` and
  the structure files of a folder;
- :func:`records_to_graphs` / :func:`records_to_graphs_iter` build the
  graphs in record order, with ``num_workers > 1`` in a pool of processes
  started by ``spawn``: a worker imports this module afresh, without
  torch (it starts in a fraction of a second), and builds with numpy and
  the C++ neighbour list, never touching the parent's CUDA context;
- :class:`LazyCacheView` reads graphs from the on-disk cache
  (:mod:`alignn_tpu_torch.data.cache`) one at a time;
- :class:`GraphDataset` holds graphs, ids and the target scaling.
"""

from __future__ import annotations

import csv
import json
import math
import multiprocessing
import os
import zipfile
from collections import deque
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from alignn_tpu_torch.chem.atoms import Atoms
from alignn_tpu_torch.graph.build import GraphData, build_graph

STRUCTURE_READERS = {"poscar": Atoms.from_poscar, "cif": Atoms.from_cif,
                     "xyz": Atoms.from_xyz, "pdb": Atoms.from_pdb}


def voigt_6_to_full_3x3_stress(v) -> np.ndarray:
    """Voigt 6-vector (xx, yy, zz, yz, xz, xy) -> symmetric 3x3 stress."""
    s_xx, s_yy, s_zz, s_yz, s_xz, s_xy = [float(x) for x in v]
    return np.array([[s_xx, s_xy, s_xz],
                     [s_xy, s_yy, s_yz],
                     [s_xz, s_yz, s_zz]])


def load_folder_records(
    root_dir: str,
    target_key: str = "total_energy",
    id_key: str = "jid",
    atomwise_key: str = "forces",
    gradwise_key: str = "forces",
    stresswise_key: str = "stresses",
    additional_output_key: str = "additional_output",
    file_format: str = "poscar",
    train_atom: bool = False,
    train_grad: bool = False,
    train_stress: bool = False,
    train_additional_output: bool = False,
) -> List[Dict[str, Any]]:
    """Records from a folder's ``id_prop.json.zip``, ``id_prop.json`` or
    ``id_prop.csv`` (in that order of preference).

    A csv row is ``file, target[, target...]``: several values make a
    vector target, and the structure is read from the named file in
    `file_format`.  A json entry carries ``atoms`` and the keys named
    here; forces, stresses (a Voigt 6-vector or 3x3) and the additional
    output are wired in when asked for.
    """
    id_prop_json = os.path.join(root_dir, "id_prop.json")
    id_prop_json_zip = os.path.join(root_dir, "id_prop.json.zip")
    id_prop_csv = os.path.join(root_dir, "id_prop.csv")
    csv_mode = False
    if os.path.exists(id_prop_json_zip):
        with zipfile.ZipFile(id_prop_json_zip) as z:
            dat = json.loads(z.read("id_prop.json"))
    elif os.path.exists(id_prop_json):
        with open(id_prop_json) as f:
            dat = json.load(f)
    elif os.path.exists(id_prop_csv):
        csv_mode = True
        with open(id_prop_csv) as f:
            dat = [row for row in csv.reader(f) if row]
    else:
        raise FileNotFoundError(
            f"no id_prop.{{csv,json,json.zip}} in {root_dir}")
    if csv_mode and file_format not in STRUCTURE_READERS:
        raise NotImplementedError(
            f"File format not implemented: {file_format}")

    records: List[Dict[str, Any]] = []
    for i in dat:
        info: Dict[str, Any] = {}
        if csv_mode:
            file_name = i[0]
            tmp = [float(j) for j in i[1:]]
            info["jid"] = file_name
            info["target"] = tmp[0] if len(tmp) == 1 else tmp
            info["atoms"] = STRUCTURE_READERS[file_format](
                os.path.join(root_dir, file_name)).to_dict()
        else:
            info["target"] = i[target_key]
            info["atoms"] = i["atoms"]
            info["jid"] = i[id_key]
        if train_atom:
            info["atomwise_target"] = i[atomwise_key]
        if train_grad:
            info["atomwise_grad"] = i[gradwise_key]
        if train_stress:
            st = i[stresswise_key]
            info["stresses"] = (voigt_6_to_full_3x3_stress(st)
                                if np.asarray(st).size == 6
                                else np.asarray(st, dtype=np.float64))
        if train_additional_output:
            info["additional"] = i[additional_output_key]
        if "extra_features" in i:
            info["extra_features"] = i["extra_features"]
        records.append(info)
    return records


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
    if "extra_features" in rec:
        g.extra_features = np.asarray(rec["extra_features"],
                                      dtype=np.float64).reshape(-1)
    return g


def _build_chunk(recs: Sequence[Dict[str, Any]], kwargs: Dict[str, Any]
                 ) -> List[GraphData]:
    """One pool job: the graphs of a few records (a top-level function,
    so that ``spawn`` can send it)."""
    return [_build_one(rec, kwargs) for rec in recs]


def records_to_graphs_iter(records: Sequence[Dict[str, Any]],
                           neighbor_strategy: str = "k-nearest",
                           cutoff: float = 8.0, max_neighbors: int = 12,
                           use_canonize: bool = True,
                           compute_line_graph: bool = True,
                           cutoff_extra: float = 3.0,
                           num_workers: int = 0,
                           lg_cutoff: Optional[float] = None
                           ) -> Iterator[GraphData]:
    """One labelled graph per record, yielded in record order.

    With ``num_workers > 1`` (and more than 8 records) chunks of 16
    records go to a ``spawn`` process pool, at most 4 chunks per worker in
    flight, so memory stays bounded however far the consumer lags.
    """
    kwargs = dict(neighbor_strategy=neighbor_strategy, cutoff=cutoff,
                  max_neighbors=max_neighbors, use_canonize=use_canonize,
                  compute_line_graph=compute_line_graph,
                  cutoff_extra=cutoff_extra, lg_cutoff=lg_cutoff)
    if not (num_workers and num_workers > 1 and len(records) > 8):
        for rec in records:
            yield _build_one(rec, kwargs)
        return
    chunk, window = 16, max(num_workers * 4, 4)
    with ProcessPoolExecutor(
            max_workers=num_workers,
            mp_context=multiprocessing.get_context("spawn")) as ex:
        pending: deque = deque()
        idx, n = 0, len(records)
        while idx < n or pending:
            while idx < n and len(pending) < window:
                recs = list(records[idx:idx + chunk])
                pending.append(ex.submit(_build_chunk, recs, kwargs))
                idx += len(recs)
            yield from pending.popleft().result()


def records_to_graphs(records: Sequence[Dict[str, Any]],
                      **kwargs) -> List[GraphData]:
    """:func:`records_to_graphs_iter` as a list."""
    return list(records_to_graphs_iter(records, **kwargs))


class LazyCacheView:
    """Indexable sequence of graphs read from a
    :class:`~alignn_tpu_torch.data.cache.GraphCache` on access, with an
    optional `transform` (the target scaling) applied to each."""

    def __init__(self, cache, transform=None):
        self.cache = cache
        self.transform = transform

    def __len__(self) -> int:
        return len(self.cache)

    def __getitem__(self, i: int) -> GraphData:
        g = self.cache[int(i)]
        if self.transform is not None:
            g = self.transform(g)
        return g

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


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
        if isinstance(self.graphs, LazyCacheView):
            prev = self.graphs.transform

            def transform(g, _mean=mean, _std=std, _prev=prev):
                # composed with any earlier scaling, as the eager path
                if _prev is not None:
                    g = _prev(g)
                if g.target is not None:
                    g.target = (np.atleast_1d(g.target) - _mean) / _std
                return g

            self.graphs.transform = transform
        else:
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
