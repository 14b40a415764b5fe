"""Bucketed batch loader: graphs -> padded GraphBatch streams on a device.

Counterpart of ``BucketedLoader`` and the bucket sizing of
``alignn_tpu/data/loader.py``:

- one static :class:`~alignn_tpu_torch.graph.batch.BucketSpec` per loader,
  from a worst-case packing bound (the sum of the `batch_size` largest
  per-graph counts), or a dense bucket for the dense layout;
- shuffling from the seed ``seed + epoch``, the same permutation as JAX's
  (numpy's ``default_rng``), with `drop_last` and a host-strided slice;
- the static gather windows (``win_*``) of each batch floored so that they
  only grow over the loader's life (:meth:`BucketedLoader._floor_windows`),
  which bounds the CUDA graphs a compiled step captures for the bucket, as
  JAX's floor bounds its recompiles;
- a background thread that builds the next batches while the device runs;
  it holds :data:`alignn_tpu_torch.DEVICE_WORK_LOCK` while it builds one,
  so that it pauses while a train step's CUDA graph is captured.

Batches land on the loader's `device`, ``cuda`` unless another is asked
for (:func:`alignn_tpu_torch.resolve_device`).

Data parallelism: JAX's loader with ``num_shards=D`` stacks D consecutive
batches of one step into a ``[D, ...]`` batch for its one SPMD program.
The port runs one process a device, so the loader of rank ``shard_index``
yields that rank's shard alone: of each step's ``batch_size * D`` items
(after the epoch permutation and the host stride, as in JAX), the slice
``[shard_index * batch_size, (shard_index + 1) * batch_size)``.  Under
shards ``drop_last`` is on, as in JAX.  The static fields must be equal on
every rank: the bucket comes from the whole dataset, and each step's
windows are floored over all D shards, the others' measured from their
index arrays alone (:func:`~alignn_tpu_torch.graph.batch.batch_windows`),
so that every rank's floor moves in step without a collective.

:func:`get_train_val_loaders` turns records into the three loaders of a
training run: filter, split (``ids_train_val_test.json``), the optional
per-species baseline, the graphs (built, or read from the on-disk cache
when its fingerprint matches), the ``mad`` file and optional standard
scaling (``sc.pkl``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
import queue
import threading
import time
from types import SimpleNamespace
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from alignn_tpu_torch import DEVICE_WORK_LOCK, resolve_device
from alignn_tpu_torch.chem.atoms import dumpjson
from alignn_tpu_torch.data.baseline import (baseline_per_atom,
                                            fit_species_baseline)
from alignn_tpu_torch.data.cache import GraphCache, GraphCacheWriter
from alignn_tpu_torch.data.dataset import (GraphDataset, LazyCacheView,
                                           filter_records, records_to_graphs,
                                           records_to_graphs_iter)
from alignn_tpu_torch.data.splits import get_id_train_val_test
from alignn_tpu_torch.graph.batch import (WIN_FIELDS, BucketSpec, GraphBatch,
                                          _round_up, batch_graphs,
                                          batch_windows)
from alignn_tpu_torch.graph.build import GraphData
from alignn_tpu_torch.graph.dense import (AsymmetricEdgesError,
                                          dense_batch_graphs,
                                          dense_spec_for_graphs,
                                          dense_spec_from_counts)


def spec_from_counts(node_counts, edge_counts, lg_counts, batch_size: int,
                     node_quantum: int = 128, edge_quantum: int = 128,
                     lg_quantum: int = 512, slack: float = 1.0) -> BucketSpec:
    """A bucket that holds any `batch_size` graphs: each axis bounded by
    the sum of its `batch_size` largest per-graph counts (x slack)."""
    def bound(counts) -> int:
        top = sorted((int(c) for c in counts), reverse=True)[:batch_size]
        return int(sum(top) * slack)

    return BucketSpec(
        n_nodes=_round_up(bound(node_counts) + 1, node_quantum),
        n_edges=_round_up(bound(edge_counts) + 1, edge_quantum),
        n_lg_edges=_round_up(bound(lg_counts) + 1, lg_quantum),
        n_graphs=batch_size + 1,
    )


def worst_case_spec(graphs: Sequence[GraphData], batch_size: int,
                    node_quantum: int = 128, edge_quantum: int = 128,
                    lg_quantum: int = 512, slack: float = 1.0) -> BucketSpec:
    """:func:`spec_from_counts` over the graphs' own counts."""
    return spec_from_counts(
        [g.num_nodes for g in graphs], [g.num_edges for g in graphs],
        [g.num_lg_edges for g in graphs], batch_size,
        node_quantum=node_quantum, edge_quantum=edge_quantum,
        lg_quantum=lg_quantum, slack=slack)


class BucketedLoader:
    """Iterates padded GraphBatches over a :class:`GraphDataset`; with
    ``num_shards`` > 1, shard ``shard_index``'s batch of each step."""

    def __init__(self, dataset: GraphDataset, batch_size: int,
                 shuffle: bool = False, drop_last: bool = False,
                 spec: Optional[BucketSpec] = None,
                 atom_features: str = "cgcnn",
                 target_width: int = 1, atomwise_width: int = 0,
                 additional_width: int = 0, extra_width: int = 0,
                 num_shards: int = 1,
                 seed: int = 123, bucket_slack: float = 1.0,
                 host_id: int = 0, num_hosts: int = 1,
                 prefetch: int = 2, dense: bool = False,
                 device: Optional[torch.device | str] = None,
                 shard_index: int = 0):
        if not 0 <= shard_index < max(num_shards, 1):
            raise ValueError(f"shard_index {shard_index} is not one of "
                             f"the {num_shards} shards")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last or num_shards > 1
        self.num_shards = max(num_shards, 1)
        self.shard_index = shard_index
        self.atom_features = atom_features
        self.target_width = target_width
        self.atomwise_width = atomwise_width
        self.additional_width = additional_width
        self.extra_width = extra_width
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0
        self.device = resolve_device(device)
        # every host draws the same permutation and takes its strided slice
        self.host_id = host_id
        self.num_hosts = max(num_hosts, 1)
        # monotone floor of each static gather window (GraphBatch.win_*):
        # raising a window is always safe, it still covers the span
        self._win_floor: dict = {}
        if spec is None and len(dataset) > 0:
            counts = dataset.metadata.get("counts")
            c = np.asarray(counts) if counts is not None else None
            if dense:
                # a 4th count column (max in-degree) sizes the dense
                # bucket without reading the graphs
                if c is not None and c.ndim == 2 and c.shape[1] >= 4 \
                        and c[:, 3].max() > 0:
                    spec = dense_spec_from_counts(
                        c[:, 0], c[:, 3], batch_size, slack=bucket_slack)
                else:
                    spec = dense_spec_for_graphs(
                        dataset.graphs, batch_size, slack=bucket_slack)
            elif c is not None:
                spec = spec_from_counts(c[:, 0], c[:, 1], c[:, 2],
                                        batch_size, slack=bucket_slack)
            else:
                spec = worst_case_spec(dataset.graphs, batch_size,
                                       slack=bucket_slack)
        if dense and spec is not None and not spec.dense_D:
            raise ValueError("dense=True requires a dense BucketSpec "
                             "(graph.dense.dense_spec_for_graphs)")
        self.spec = spec
        # the graph stage's seconds and cache hits, where
        # get_train_val_loaders made this loader
        self.graph_stats: Optional[Dict[str, Any]] = None

    def __len__(self) -> int:
        n, full = len(self._order()), self.batch_size * self.num_shards
        return n // full if self.drop_last else (n + full - 1) // full

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng(
                self.seed + self.epoch).permutation(n)
        else:
            order = np.arange(n)
        if self.num_hosts > 1:
            # every host must see as many items, or collectives desync:
            # pad by cycling to a multiple of num_hosts, then stride
            pad = (-len(order)) % self.num_hosts
            if pad:
                order = np.concatenate([order, order[:pad]])
            order = order[self.host_id::self.num_hosts]
        return order

    def _make_batch(self, idxs) -> GraphBatch:
        graphs = [self.dataset.graphs[i] for i in idxs]
        kw = dict(atom_features=self.atom_features,
                  target_width=self.target_width,
                  atomwise_width=self.atomwise_width,
                  additional_width=self.additional_width,
                  extra_width=self.extra_width)
        if self.spec is not None and self.spec.dense_D:
            try:
                return dense_batch_graphs(graphs, self.spec, self.device,
                                          **kw)
            except AsymmetricEdgesError as exc:
                # training cannot switch layouts from batch to batch
                raise AsymmetricEdgesError(
                    f"{exc}: a structure in this dataset lacks the "
                    f"reverse-edge involution (common for radius graphs "
                    f"with bonds at the cutoff); train with "
                    f"dense_neighborhoods=false for this dataset") from exc
        return batch_graphs(graphs, self.spec, self.device, **kw)

    def _floor_windows(self, batches) -> dict:
        """One window set: the max across the batches, raised to the
        loader's monotone floor.  A 0 (plain gather) stays 0 for its step
        and does not lower the floor."""
        out = {}
        for name in WIN_FIELDS:
            vals = [getattr(b, name) for b in batches]
            w = 0 if any(v == 0 for v in vals) else max(vals)
            if w:
                w = max(w, self._win_floor.get(name, 0))
                self._win_floor[name] = w
            out[name] = w
        return out

    def _shard(self, order, s: int, d: int):
        """The items of shard `d` of step `s`."""
        b = self.batch_size
        start = (s * self.num_shards + d) * b
        return order[start:start + b]

    def _batch_for_step(self, order, s: int) -> GraphBatch:
        b = self._make_batch(self._shard(order, s, self.shard_index))
        shards = [b]
        if self.num_shards > 1 and not b.dense_D:
            # the other shards' windows, from their index arrays
            shards += [SimpleNamespace(**batch_windows(
                [self.dataset.graphs[i] for i in self._shard(order, s, d)],
                self.spec))
                for d in range(self.num_shards) if d != self.shard_index]
        return dataclasses.replace(b, **self._floor_windows(shards))

    def __iter__(self) -> Iterator[GraphBatch]:
        order = self._order()
        n_steps = len(self)
        if self.prefetch <= 0 or n_steps <= 1:
            for s in range(n_steps):
                yield self._batch_for_step(order, s)
            return
        # a background thread packs, pads and copies the next batches while
        # the device runs the current step
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            try:
                for s in range(n_steps):
                    if stop.is_set():
                        return
                    with DEVICE_WORK_LOCK:    # not during a capture
                        batch = self._batch_for_step(order, s)
                    q.put(("ok", batch))
                q.put(("done", None))
            except BaseException as exc:   # raised again in the consumer
                q.put(("err", exc))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                kind, payload = q.get()
                if kind == "done":
                    return
                if kind == "err":
                    raise payload
                yield payload
        finally:
            stop.set()
            # drain, so that the worker never blocks on a full queue
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.1)

    def batch_ids(self) -> List[List[str]]:
        """The ids of each batch (this shard's) in the current epoch's
        order."""
        order = self._order()
        return [[self.dataset.ids[i] for i in
                 self._shard(order, s, self.shard_index)]
                for s in range(len(self))]


_LABEL_KEYS = ("target", "atomwise_target", "atomwise_grad", "stresses",
               "additional", "extra_features")


def _label_digest(rec: Dict[str, Any]) -> str:
    """Hash of every label a cached graph carries: regenerated forces with
    unchanged ids and energies must miss the cache."""
    h = hashlib.sha256()
    for key in _LABEL_KEYS:
        v = rec.get(key)
        h.update(b"-" if v is None else np.ascontiguousarray(
            np.asarray(v, dtype=np.float64)).tobytes())
    return h.hexdigest()


def _cached_dataset(recs, ids, build_kwargs: Dict[str, Any],
                    num_workers: int, path: str
                    ) -> Tuple[GraphDataset, bool]:
    """(dataset, hit): the split's graphs from the cache at `path` when its
    fingerprint (graph arguments, ids, labels) matches, else built,
    written there one at a time, and read back lazily.  The meta file
    keeps each graph's counts (with the max in-degree, for dense buckets)
    and targets, so the loader sizes its bucket and the MAD comes without
    reading a graph."""
    fingerprint = hashlib.sha256(json.dumps(
        [build_kwargs, ids, [_label_digest(r) for r in recs]],
        sort_keys=True, default=str).encode()).hexdigest()
    meta_path = path + ".meta.json"
    meta = None
    if GraphCache.exists(path) and os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        if not (meta.get("fingerprint") == fingerprint
                and meta.get("n") == len(recs) and "counts" in meta):
            meta = None
    hit = meta is not None
    if not hit:
        counts, targets = [], []
        with GraphCacheWriter(path) as w:
            for g in records_to_graphs_iter(recs, num_workers=num_workers,
                                            **build_kwargs):
                w.put(g)
                indeg = int(np.bincount(g.dst, minlength=g.num_nodes)
                            .max()) if g.num_edges else 0
                counts.append([g.num_nodes, g.num_edges, g.num_lg_edges,
                               indeg])
                targets.append(np.atleast_1d(np.asarray(
                    g.target, dtype=np.float64)).tolist()
                    if g.target is not None else [0.0])
        meta = {"fingerprint": fingerprint, "n": len(recs),
                "counts": counts, "targets": targets}
        with open(meta_path, "w") as f:
            json.dump(meta, f)
    return GraphDataset(graphs=LazyCacheView(GraphCache(path)), ids=ids,
                        metadata={"counts": meta["counts"],
                                  "targets": meta["targets"]}), hit


def get_train_val_loaders(
    records: Sequence[dict],
    target: str = "target",
    id_tag: str = "jid",
    atom_features: str = "cgcnn",
    neighbor_strategy: str = "k-nearest",
    cutoff: float = 8.0,
    cutoff_extra: float = 3.0,
    max_neighbors: int = 12,
    use_canonize: bool = True,
    compute_line_graph: bool = True,
    batch_size: int = 64,
    split_seed: int = 123,
    train_ratio: Optional[float] = 0.8,
    val_ratio: Optional[float] = 0.1,
    test_ratio: Optional[float] = 0.1,
    n_train: Optional[int] = None,
    n_val: Optional[int] = None,
    n_test: Optional[int] = None,
    keep_data_order: bool = True,
    classification_threshold: Optional[float] = None,
    target_multiplication_factor: Optional[float] = None,
    standard_scalar_and_pca: bool = False,
    output_dir: str = ".",
    num_workers: int = 0,
    num_shards: int = 1,
    target_width: int = 1,
    atomwise_width: int = 0,
    additional_width: int = 0,
    extra_width: int = 0,
    bucket_slack: float = 1.0,
    cache_dir: Optional[str] = None,
    dense: bool = False,
    per_species_energy_baseline: bool = False,
    lg_cutoff: Optional[float] = None,
    device: Optional[torch.device | str] = None,
    shard_index: int = 0,
) -> Tuple[BucketedLoader, BucketedLoader, BucketedLoader, float]:
    """Records -> (train_loader, val_loader, test_loader, mad), as the JAX
    function: the train loader shuffles and drops its last partial batch,
    the val loader drops it only when the split holds a whole batch, the
    test loader takes batch 1.  With `num_shards` > 1 the train loader
    yields shard `shard_index` of each step (this rank's); the val and
    test loaders are unsharded, as in JAX.  The train loader's
    ``graph_stats`` holds the graph stage's seconds and whether each split
    came from the cache."""
    device = resolve_device(device)
    dat = filter_records(
        records, target=target,
        classification_threshold=classification_threshold,
        target_multiplication_factor=target_multiplication_factor)
    if target != "target":
        # the graph build reads the canonical "target" key
        dat = [{**r, "target": r[target]} for r in dat]
    id_train, id_val, id_test = get_id_train_val_test(
        total_size=len(dat), split_seed=split_seed,
        train_ratio=train_ratio, val_ratio=val_ratio, test_ratio=test_ratio,
        n_train=n_train, n_test=n_test, n_val=n_val,
        keep_data_order=keep_data_order)
    os.makedirs(output_dir, exist_ok=True)
    dumpjson({"id_train": [dat[i][id_tag] for i in id_train],
              "id_val": [dat[i][id_tag] for i in id_val],
              "id_test": [dat[i][id_tag] for i in id_test]},
             os.path.join(output_dir, "ids_train_val_test.json"))

    if per_species_energy_baseline:
        # offsets fit on the train split only; every split's targets
        # become residuals (before the cache, whose fingerprint hashes
        # the targets)
        mu = fit_species_baseline([dat[i] for i in id_train])
        dat = [{**r, "target": float(
            np.asarray(r["target"], dtype=np.float64).reshape(-1)[0]
            - baseline_per_atom(r["atoms"]["elements"], mu))} for r in dat]
        dumpjson({"per_atom": True, "elements": mu},
                 os.path.join(output_dir, "species_baseline.json"))
        print(f"[baseline] per-species reference energies (eV/atom): "
              f"{ {k: round(v, 4) for k, v in mu.items()} }")

    build_kwargs = dict(
        neighbor_strategy=neighbor_strategy, cutoff=cutoff,
        max_neighbors=max_neighbors, use_canonize=use_canonize,
        compute_line_graph=compute_line_graph, cutoff_extra=cutoff_extra,
        lg_cutoff=lg_cutoff)
    stats: Dict[str, Any] = {"graph_s": 0.0, "cached": {}}

    def make_ds(idxs, split: str) -> GraphDataset:
        recs = [dat[i] for i in idxs]
        ids = [r[id_tag] for r in recs]
        t0 = time.perf_counter()
        if cache_dir is None:
            ds = GraphDataset(graphs=records_to_graphs(
                recs, num_workers=num_workers, **build_kwargs), ids=ids)
        else:
            ds, stats["cached"][split] = _cached_dataset(
                recs, ids, build_kwargs, num_workers,
                os.path.join(cache_dir, f"graphs_{split}"))
        stats["graph_s"] += time.perf_counter() - t0
        return ds

    train_ds = make_ds(id_train, "train")
    val_ds = make_ds(id_val, "val")
    test_ds = make_ds(id_test, "test")

    mad = train_ds.mad() if len(train_ds) else 0.0
    with open(os.path.join(output_dir, "mad"), "w") as f:
        f.write(f"MAX val: {mad}\n")
        f.write(f"MAD of training set: {mad}\n")
        f.write(f"Baseline MAE: {mad}\n")

    if standard_scalar_and_pca and len(train_ds):
        y = train_ds.targets()
        mean, std = float(np.mean(y)), float(np.std(y)) or 1.0
        with open(os.path.join(output_dir, "sc.pkl"), "wb") as f:
            pickle.dump({"mean": mean, "std": std}, f)
        for ds in (train_ds, val_ds, test_ds):
            ds.scale_targets(mean, std)

    shared = dict(atom_features=atom_features, target_width=target_width,
                  atomwise_width=atomwise_width,
                  additional_width=additional_width,
                  extra_width=extra_width, seed=split_seed,
                  bucket_slack=bucket_slack, dense=dense, device=device)
    train_loader = BucketedLoader(train_ds, batch_size, shuffle=True,
                                  drop_last=True, num_shards=num_shards,
                                  shard_index=shard_index, **shared)
    # a val split smaller than one batch keeps its partial batch instead
    # of validating on nothing
    val_loader = BucketedLoader(val_ds, batch_size, shuffle=False,
                                drop_last=len(val_ds) >= batch_size,
                                **shared)
    test_loader = BucketedLoader(test_ds, 1, shuffle=False, drop_last=False,
                                 **shared)
    train_loader.graph_stats = stats
    return train_loader, val_loader, test_loader, mad
