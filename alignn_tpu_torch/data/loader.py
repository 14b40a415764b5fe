"""Bucketed batch loader: graphs -> padded GraphBatch streams on a device.

Counterpart of ``BucketedLoader`` and the bucket sizing of
``alignn_tpu/data/loader.py``:

- one static :class:`~alignn_tpu_torch.graph.batch.BucketSpec` per loader,
  from a worst-case packing bound (the sum of the `batch_size` largest
  per-graph counts), or a dense bucket for the dense layout;
- shuffling from the seed ``seed + epoch``, the same permutation as JAX's
  (numpy's ``default_rng``), with `drop_last` and a host-strided slice;
- the static gather windows (``win_*``) of each batch floored so that they
  only grow over the loader's life (:meth:`BucketedLoader._floor_windows`);
- a background thread that builds the next batches while the device runs.

Batches land on the loader's `device`, ``cuda`` unless another is asked
for (:func:`alignn_tpu_torch.resolve_device`).  Stacking ``num_shards``
batches for data parallelism waits for the DDP port.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from alignn_tpu_torch import resolve_device
from alignn_tpu_torch.data.dataset import GraphDataset
from alignn_tpu_torch.graph.batch import (WIN_FIELDS, BucketSpec, GraphBatch,
                                          _round_up, batch_graphs)
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
    """Iterates padded GraphBatches over a :class:`GraphDataset`."""

    def __init__(self, dataset: GraphDataset, batch_size: int,
                 shuffle: bool = False, drop_last: bool = False,
                 spec: Optional[BucketSpec] = None,
                 atom_features: str = "cgcnn",
                 target_width: int = 1, atomwise_width: int = 0,
                 additional_width: int = 0, num_shards: int = 1,
                 seed: int = 123, bucket_slack: float = 1.0,
                 host_id: int = 0, num_hosts: int = 1,
                 prefetch: int = 2, dense: bool = False,
                 device: Optional[torch.device | str] = None):
        if num_shards > 1:
            raise NotImplementedError(
                "num_shards > 1 stacks per-device batches for data "
                "parallelism, which waits for the DDP port")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.atom_features = atom_features
        self.target_width = target_width
        self.atomwise_width = atomwise_width
        self.additional_width = additional_width
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

    def __len__(self) -> int:
        n, b = len(self._order()), self.batch_size
        return n // b if self.drop_last else (n + b - 1) // b

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
                  additional_width=self.additional_width)
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

    def _batch_for_step(self, order, s: int) -> GraphBatch:
        b = self._make_batch(order[s * self.batch_size:
                                   (s + 1) * self.batch_size])
        return dataclasses.replace(b, **self._floor_windows([b]))

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
                    q.put(("ok", self._batch_for_step(order, s)))
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
        """The ids of each batch in the current epoch's order."""
        order, b = self._order(), self.batch_size
        return [[self.dataset.ids[i] for i in order[s * b:(s + 1) * b]]
                for s in range(len(self))]
