"""What each collective of a graph-parallel step sends, in which phase,
and what its payload depends on (counterpart of
``alignn_tpu/parallel/hlo_audit.py``).

JAX audits the compiled module's HLO.  The port has no HLO: its
counterparts of the module are the collectives that
:mod:`~alignn_tpu_torch.parallel.mesh` issues and the autograd graph of
their payloads, and the audit reads those.

- :func:`record_collectives` opens a recorder that ``ring_shift``,
  ``all_gather``, ``all_reduce_sum`` (``parallel/mesh.py``) and
  ``ring_broadcast`` (``parallel/gp_model.py``) report to.  Each call
  becomes an :class:`Event`: its kind (``shift``, ``all_gather``,
  ``all_reduce``), payload bytes and shape, phase (``forward``, or
  ``transpose`` when a collective Function's backward makes it), shift
  distance ``k``, the stage (the innermost module whose forward made it)
  and the exchange (one ring, or one halo exchange) it belongs to.  The
  wrapper keeps the payload's ``grad_fn`` from before ``.apply``, where
  the payload still has it.  With no recorder open a collective costs only
  its ``COLLECTIVE_STATS`` update and one test of a module global.
- :func:`audit_collectives` turns the events into a :class:`RingAudit`.
  A forward payload's ``scatter_deps`` are the segment-sum nodes
  (:data:`SCATTER_NODES`: ``_SortedSegmentSum``, ``_GatedAggregate``, the
  ``index_add`` and ``index_put`` backward nodes and the dense
  Functions) in the closure of its ``grad_fn`` inside its stage, the walk
  ending at the stage's inputs: the port's "transitive operand closure
  contains no scatter" (a forward ring payload that has none can be sent
  while the stage's local aggregation runs).  Order tokens
  (``mesh.ordered_collectives``) are not data and are not followed.  A
  transpose payload's ``chain_deps`` are the earlier transpose collectives
  of its own exchange that it is computed from: the chain ring's reverse
  is accumulate-and-forward (hop k carries hop k+1's arrival plus the
  local scatter-add), the gather ring's and the halo's reverse hops are
  independent.  A transpose payload has a ``grad_fn`` only where the
  backward builds a graph (``create_graph=True``, as the force loss of a
  train step does); without one the reverse structure is reported as
  unknown (None), never as chain-free.
- :func:`expected_ring_bytes` and :func:`expected_halo_bytes` are the
  analytic wire-byte models (copies of JAX's).
- :func:`audit_schedule_overlap` is the counterpart of JAX's schedule
  audit: from a ``torch.profiler`` trace of the recorded step (the
  recorder wraps each collective in a ``record_function`` range) it lists
  each collective's interval and whether a compute kernel ran inside it
  on a stream other than the collective's own copies.
- :func:`audit_gp_forward` records one E/F/S forward of the ring or halo
  model and holds it against the analytic bytes.

The recorder keeps the payloads' autograd nodes (so the graph of the
recorded step lives until the recorder is dropped).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from alignn_tpu_torch.parallel import mesh as meshlib

# autograd node names (prefixes) of the operations that sum rows into
# segments: a payload that depends on one is data-dependent on a local
# aggregation
SCATTER_NODES = (
    "_SortedSegmentSumBackward", "_GatedAggregateBackward",
    "_DenseGatedAggregateBackward", "_GatedAggregateBwdBackward",
    "_DensePairAggregateBackward", "_PairAggregateBwdBackward",
    "_PairAggregateBwd2Backward", "_FusedPairLStageBackward",
    "_FusedLStageBwdBackward", "IndexAddBackward",
    # an indexing gather's transpose (index_put with accumulate)
    "IndexPut")


@dataclass
class Event:
    """One recorded collective call."""

    index: int
    kind: str                  # "shift" | "all_gather" | "all_reduce"
    phase: str                 # "forward" | "transpose"
    payload_bytes: int
    shape: tuple
    dtype: str
    k: int                     # shift distance (0 for reductions)
    axis_size: int
    stage: str
    exchange: int
    payload: object = None     # the payload's grad_fn before .apply
    out: object = None         # the output's grad_fn (the call's node)
    boundary: frozenset = frozenset()   # ids of the stage's input nodes
    keep: tuple = ()           # the boundary nodes, alive while recorded

    @property
    def hops(self) -> int:
        """Links a shift crosses on a bidirectional ring of the axis."""
        if self.kind != "shift" or not self.axis_size:
            return 1
        k = self.k % self.axis_size
        return min(k, self.axis_size - k)


class Recorder:
    """The open recorder (``mesh.RECORDER``): the events, the stack of
    module forwards (stages) and of exchanges, and the phase."""

    def __init__(self, names: Optional[Dict[int, str]] = None):
        self.events: List[Event] = []
        self._names = names or {}
        self._stages: list = []        # (name, boundary ids, nodes)
        self._exchanges: list = []
        self._scopes: list = []        # labels of backward scopes
        self._active = None
        self._ids = itertools.count()

    # -- stages (module forward hooks) --------------------------------
    def _pre(self, module, args):
        nodes = tuple(a.grad_fn for a in args
                      if isinstance(a, torch.Tensor)
                      and a.grad_fn is not None)
        name = self._names.get(id(module), type(module).__name__)
        self._stages.append((name, frozenset(id(n) for n in nodes), nodes))

    def _post(self, module, args, out):
        self._stages.pop()

    # -- labels --------------------------------------------------------
    @contextlib.contextmanager
    def exchange(self):
        self._exchanges.append(next(self._ids))
        try:
            yield
        finally:
            self._exchanges.pop()

    @contextlib.contextmanager
    def transposing(self, label):
        self._scopes.append(label)
        try:
            yield
        finally:
            self._scopes.pop()

    def label(self):
        """(stage, exchange) of the collective being made."""
        return self._active

    def _label_now(self):
        if self._scopes:
            label = self._scopes[-1]
            if label is not None:
                return label
            return ("", next(self._ids))
        stage = self._stages[-1][0] if self._stages else ""
        ex = self._exchanges[-1] if self._exchanges else next(self._ids)
        return (stage, ex)

    # -- the calls -----------------------------------------------------
    def collective(self, kind: str, x: torch.Tensor, k: int, nbytes: int,
                   fn, repeat: int = 1, axis_size: int = 0):
        phase = "transpose" if self._scopes else "forward"
        label = self._label_now()
        boundary, keep = frozenset(), ()
        if phase == "forward" and self._stages:
            _, boundary, keep = self._stages[-1]
        payload = x.grad_fn
        before, self._active = self._active, label
        try:
            with torch.profiler.record_function(f"collective:{kind}:"
                                                f"{phase}"):
                out = fn()
        finally:
            self._active = before
        for _ in range(repeat):
            self.events.append(Event(
                index=len(self.events), kind=kind, phase=phase,
                payload_bytes=int(nbytes), shape=tuple(x.shape),
                dtype=str(x.dtype).replace("torch.", ""), k=int(k),
                axis_size=int(axis_size), stage=label[0],
                exchange=label[1], payload=payload, out=out.grad_fn,
                boundary=boundary, keep=keep))
        return out


@contextlib.contextmanager
def record_collectives(model: Optional[torch.nn.Module] = None):
    """Record every collective of ``parallel/mesh.py`` made inside; yields
    the :class:`Recorder`.  `model` names the stages by their module path
    in it (else by class).  One recorder at a time."""
    if meshlib.RECORDER is not None:
        raise RuntimeError("a collective recorder is already open")
    names = {}
    if model is not None:
        names = {id(m): (n or type(m).__name__)
                 for n, m in model.named_modules()}
    rec = Recorder(names)
    from torch.nn.modules import module as modlib

    hooks = [modlib.register_module_forward_pre_hook(rec._pre),
             modlib.register_module_forward_hook(rec._post)]
    meshlib.RECORDER = rec
    try:
        yield rec
    finally:
        meshlib.RECORDER = None
        for h in hooks:
            h.remove()


@dataclass
class CollectiveInfo:
    """One audited collective (JAX's CollectiveInfo where the fields mean
    the same)."""

    name: str
    kind: str
    payload_bytes: int
    op_name: str                        # stage/kind
    scatter_deps: frozenset = frozenset()
    phase: str = "forward"
    k: int = 0
    hops: int = 1
    exchange: int = 0
    chain_deps: Optional[frozenset] = frozenset()

    @property
    def stage(self) -> str:
        return self.op_name.rsplit("/", 1)[0]

    @property
    def scatter_free(self) -> bool:
        return not self.scatter_deps

    @property
    def overlap_capable(self) -> Optional[bool]:
        """Forward: no segment sum of its own stage feeds the payload.
        Transpose: no earlier hop of its own exchange does (None where the
        backward built no graph to read)."""
        if self.phase == "forward":
            return not self.scatter_deps
        return None if self.chain_deps is None else not self.chain_deps


@dataclass
class RingAudit:
    collectives: List[CollectiveInfo] = field(default_factory=list)

    def shifts(self, phase: Optional[str] = None) -> List[CollectiveInfo]:
        return [c for c in self.collectives if c.kind == "shift"
                and (phase is None or c.phase == phase)]

    def shift_bytes(self, phase: Optional[str] = None) -> int:
        return sum(c.payload_bytes for c in self.shifts(phase))

    def of_kind(self, kind: str, phase: Optional[str] = None):
        return [c for c in self.collectives if c.kind == kind
                and (phase is None or c.phase == phase)]

    def exchanges(self) -> List[Dict]:
        """One row an exchange of shifts: stage, phase, shifts, bytes, and
        its overlap verdicts."""
        rows: Dict[tuple, Dict] = {}
        for c in self.shifts():
            r = rows.setdefault((c.exchange, c.phase), {
                "stage": c.stage, "phase": c.phase, "shifts": 0,
                "bytes": 0, "overlap_capable": True,
                "chain_links": 0 if c.phase == "transpose" else None})
            r["shifts"] += 1
            r["bytes"] += c.payload_bytes
            cap = c.overlap_capable
            if cap is None:
                r["overlap_capable"] = r["chain_links"] = None
            elif r["overlap_capable"] is not None:
                r["overlap_capable"] = r["overlap_capable"] and cap
                if c.phase == "transpose" and c.chain_deps:
                    r["chain_links"] += 1
        return list(rows.values())

    def summary(self) -> Dict:
        fwd, bwd = self.shifts("forward"), self.shifts("transpose")
        known = all(c.chain_deps is not None for c in bwd)
        out = {
            "shifts_forward": len(fwd),
            "shifts_transpose": len(bwd),
            "shift_bytes_forward": sum(c.payload_bytes for c in fwd),
            "shift_bytes_transpose": sum(c.payload_bytes for c in bwd),
            "link_bytes_forward": sum(c.payload_bytes * c.hops
                                      for c in fwd),
            "link_bytes_transpose": sum(c.payload_bytes * c.hops
                                        for c in bwd),
            # None (no evidence), never a vacuous True, without shifts
            "forward_overlap_capable": (
                all(c.overlap_capable for c in fwd) if fwd else None),
            "forward_serial_bytes": sum(c.payload_bytes for c in fwd
                                        if not c.overlap_capable),
            "transpose_chain_links": (
                sum(1 for c in bwd if c.chain_deps) if known and bwd
                else None),
        }
        for kind in ("all_reduce", "all_gather"):
            for phase in ("forward", "transpose"):
                cs = self.of_kind(kind, phase)
                out[f"{kind}s_{phase}"] = len(cs)
                out[f"{kind}_bytes_{phase}"] = sum(c.payload_bytes
                                                   for c in cs)
        return out


def _is_scatter(node) -> bool:
    return type(node).__name__.startswith(SCATTER_NODES)


def _inputs(node, collective_nodes):
    """The nodes `node` reads; a collective's order token is not data."""
    nxt = node.next_functions
    if id(node) in collective_nodes:
        nxt = nxt[:1]
    return [n for n, _ in nxt if n is not None]


# The walks below key nodes by id().  The Python object of an autograd
# node lives only while referenced, and a freed one's id can be reused by
# another node's, so every node a walk has seen is kept (`alive`) until
# the audit is done.


def _stage_scatters(ev: Event, collective_nodes, labels, alive) -> frozenset:
    """Segment-sum nodes in the closure of the payload inside its stage."""
    found, seen = set(), set()
    stack = [ev.payload] if ev.payload is not None else []
    while stack:
        node = stack.pop()
        if id(node) in seen or id(node) in ev.boundary:
            continue
        seen.add(id(node))
        alive[id(node)] = node
        if _is_scatter(node):
            found.add(labels.setdefault(
                id(node), f"{type(node).__name__}:{len(labels)}"))
        stack.extend(_inputs(node, collective_nodes))
    return frozenset(found)


def _reach(roots, collective_nodes, alive) -> Dict[int, frozenset]:
    """id(node) -> the recorded calls (by index) in its transitive
    closure, for every node under `roots`.  Iterative post-order: a
    grad-of-grad graph is thousands of nodes deep."""
    memo: Dict[int, frozenset] = {}
    for root in roots:
        stack = [(root, False)]
        while stack:
            node, expanded = stack.pop()
            if id(node) in memo:
                continue
            alive[id(node)] = node
            ins = _inputs(node, collective_nodes)
            if not expanded:
                stack.append((node, True))
                stack.extend((n, False) for n in ins if id(n) not in memo)
                continue
            acc = set(collective_nodes.get(id(node), ()))
            for n in ins:
                acc |= memo.get(id(n), frozenset())
            memo[id(node)] = frozenset(acc)
    return memo


def audit_collectives(events) -> RingAudit:
    """The audit of a :class:`Recorder`'s events (or a list of them)."""
    events = list(getattr(events, "events", events))
    collective_nodes: Dict[int, list] = {}
    for ev in events:
        if ev.out is not None:
            collective_nodes.setdefault(id(ev.out), []).append(ev.index)
    labels: Dict[int, str] = {}
    alive: Dict[int, object] = {}
    roots = [ev.payload for ev in events
             if ev.phase == "transpose" and ev.payload is not None]
    reach = _reach(roots, collective_nodes, alive)
    audit = RingAudit()
    for ev in events:
        scatters, chain = frozenset(), frozenset()
        if ev.phase == "forward":
            scatters = _stage_scatters(ev, collective_nodes, labels, alive)
        elif ev.payload is None:
            chain = None
        else:
            chain = frozenset(
                j for j in reach.get(id(ev.payload), ())
                if j != ev.index and events[j].phase == "transpose"
                and events[j].exchange == ev.exchange)
        audit.collectives.append(CollectiveInfo(
            name=f"{ev.kind}.{ev.index}", kind=ev.kind,
            payload_bytes=ev.payload_bytes,
            op_name=f"{ev.stage}/{ev.kind}", scatter_deps=scatters,
            phase=ev.phase, k=ev.k, hops=ev.hops, exchange=ev.exchange,
            chain_deps=chain))
    return audit


# ---------------------------------------------------------------------------
# the analytic wire-byte models (copies of alignn_tpu/parallel/hlo_audit.py)
# ---------------------------------------------------------------------------


def expected_ring_bytes(n_devices: int, e_pad: int, features: int,
                        dtype_bytes: int = 4, r_dtype_bytes: int = 4,
                        alignn_layers: int = 1,
                        with_gradient: bool = True) -> Dict[str, int]:
    """The analytic wire-byte model the ring audit is checked against.

    Per rank, per direction of the ring:
    - each L-stage: (D-1) shifts of the [E/D, 2F] gate/update buffer;
    - the cosine ring (once): (D-1) shifts of the [E/D, 3] r shard;
    - the reverse rings mirror the forward ones exactly (the transpose of
      a shift is the shift back).
    """
    d = n_devices
    shard = e_pad // d
    l_stage = (d - 1) * shard * 2 * features * dtype_bytes
    cosines = (d - 1) * shard * 3 * r_dtype_bytes
    fwd = alignn_layers * l_stage + cosines
    return {
        "per_l_stage": l_stage,
        "cosine_ring": cosines,
        "forward_total": fwd,
        "total": fwd * (2 if with_gradient else 1),
    }


def expected_halo_bytes(node_steps, edge_steps, features: int,
                        dtype_bytes: int = 4, r_dtype_bytes: int = 4,
                        alignn_layers: int = 1, gcn_layers: int = 0,
                        with_gradient: bool = True):
    """Analytic wire-byte model of the dense halo mode
    (``parallel/dense_gp.py``), the dense counterpart of
    :func:`expected_ring_bytes`.

    Per rank, per direction: every node-stage EGGC exchanges the
    [sum(node_steps), 2F] gate/update halo once; every L-stage exchanges
    the [sum(edge_steps), F] edge halo twice (dst_gate out, h_jt back);
    the force assembly exchanges the [sum(edge_steps), 3] pair-force halo
    once.  Transposes mirror the forward (a shift transposes to a shift;
    the halo hops are independent, no accumulate-and-forward chain).
    """
    node_rows = int(sum(node_steps))
    edge_rows = int(sum(edge_steps))
    node_x = node_rows * 2 * features * dtype_bytes
    l_stage = 2 * edge_rows * features * dtype_bytes
    fwd = alignn_layers * (node_x + l_stage) + gcn_layers * node_x
    forces = edge_rows * 3 * r_dtype_bytes if with_gradient else 0
    # the first node stage's table is a function of atom features only,
    # so dE/dr carries no cotangent for it: that exchange has no transpose
    first_stage = node_x if (alignn_layers or gcn_layers) else 0
    transpose = fwd - first_stage
    return {
        "node_exchange": node_x,
        "per_l_stage": l_stage,
        "forces_exchange": forces,
        # the force halo runs after the gradient: forward phase
        "forward_total": fwd + forces,
        "transpose_total": transpose,
        "total": fwd + forces + transpose,
    }


# ---------------------------------------------------------------------------
# the schedule: collectives' intervals in a profiler trace
# ---------------------------------------------------------------------------


def trace_of(prof) -> Dict:
    """The Chrome trace of a finished ``torch.profiler.profile``."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


def _spans(trace: Dict):
    events = trace.get("traceEvents", trace) if isinstance(trace, dict) \
        else trace
    for e in events:
        if e.get("ph") == "X" and "dur" in e:
            yield e, str(e.get("cat", "")).lower()


def audit_schedule_overlap(trace: Dict) -> List[Dict]:
    """Each recorded collective's interval in a profiler trace, with the
    device work inside it: its own copies (``gpu_memcpy``) and NCCL
    kernels, and the compute kernels, by stream.  ``overlapped`` is true
    where a compute kernel ran inside the interval on a stream other than
    the collective's own."""
    ranges, device = [], []
    for e, cat in _spans(trace):
        if cat == "user_annotation" and \
                str(e.get("name", "")).startswith("collective:"):
            ranges.append(e)
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((e, cat))
    rows = []
    for r in sorted(ranges, key=lambda e: e["ts"]):
        t0, t1 = float(r["ts"]), float(r["ts"]) + float(r["dur"])
        own, compute = set(), []
        for e, cat in device:
            if float(e["ts"]) < t1 and float(e["ts"]) + float(e["dur"]) \
                    > t0:
                stream = e.get("args", {}).get("stream")
                if cat != "kernel" or \
                        str(e.get("name", "")).startswith("nccl"):
                    own.add(stream)
                else:
                    compute.append(stream)
        other = [s for s in compute if s not in own]
        _, kind, phase = r["name"].split(":", 2)
        rows.append({"kind": kind, "phase": phase, "start_us": t0,
                     "dur_us": t1 - t0, "own_device_ops": len(own),
                     "compute_kernels_inside": len(compute),
                     "other_stream_kernels": len(other),
                     "overlapped": bool(other)})
    return rows


def schedule_finding(windows: List[Dict]) -> Dict:
    """The audit's one-line finding over :func:`audit_schedule_overlap`'s
    rows."""
    by_phase = {}
    for w in windows:
        p = by_phase.setdefault(w["phase"], {"collectives": 0,
                                             "overlapped": 0,
                                             "host_us": 0.0})
        p["collectives"] += 1
        p["overlapped"] += int(w["overlapped"])
        p["host_us"] += w["dur_us"]
    return {"collectives": len(windows),
            "overlapped": sum(int(w["overlapped"]) for w in windows),
            "by_phase": by_phase}


# ---------------------------------------------------------------------------
# one recorded E/F/S forward of a graph-parallel model
# ---------------------------------------------------------------------------


def audit_gp_forward(model, mesh, batch, layout: str = "ring") -> Dict:
    """One E/F/S forward of `model`'s parameters over the mesh's graph
    axis, ring (``ALIGNN_TPU_GP_RING`` picks chain or gather) or dense
    halo, recorded with the force gradient's graph built
    (``create_graph=True``: the same collectives, and a reverse structure
    to read) under ``torch.profiler``.  Returns the outputs, the
    :class:`RingAudit`, its summary, the analytic bytes of this batch,
    dtype and axis size and whether the audited shift bytes equal them per
    phase, and the schedule rows of :func:`audit_schedule_overlap`."""
    from alignn_tpu_torch.parallel import dense_gp, graph_parallel
    from alignn_tpu_torch.parallel.gp_batch import ring_steps
    from alignn_tpu_torch.parallel.gp_model import GPALIGNNAtomWise

    axis = mesh.axis("graph")
    dev = batch.r.device
    cfg = model.cfg
    dtype_bytes = next(model.parameters()).element_size()
    r_bytes = batch.r.element_size()
    if layout == "dense":
        gp = dense_gp.DenseGPALIGNNAtomWise.sharing(model, axis)
        idx = dense_gp.make_dense_gp_index(batch, axis.size)
        local = dense_gp.shard_dense_batch(batch, axis)
        row = dense_gp.dense_index_row(idx, axis.index, dev)

        def run():
            return dense_gp.dense_gp_device_outputs(
                gp, cfg, local, row, axis.size, create_graph=True)

        expected = expected_halo_bytes(
            idx.node_halo.steps, idx.edge_halo.steps, cfg.hidden_features,
            dtype_bytes=dtype_bytes, r_dtype_bytes=r_bytes,
            alignn_layers=cfg.alignn_layers, gcn_layers=cfg.gcn_layers)
        want = (expected["forward_total"], expected["transpose_total"])
        halo_steps = (list(idx.node_halo.steps), list(idx.edge_halo.steps))
    else:
        gp = GPALIGNNAtomWise.sharing(model, axis)
        ring = graph_parallel.make_ring_index(batch, axis.size)
        local = graph_parallel.shard_batch(batch, axis)
        steps = ring_steps(ring, axis.index, local.src.shape[0], dev)

        def run():
            return graph_parallel.gp_device_outputs(
                gp, cfg, local, steps, axis.size, create_graph=True)

        expected = expected_ring_bytes(
            axis.size, int(batch.src.shape[0]), cfg.hidden_features,
            dtype_bytes=dtype_bytes, r_dtype_bytes=r_bytes,
            alignn_layers=cfg.alignn_layers)
        want = (expected["forward_total"], expected["forward_total"])
        halo_steps = None
    gp.eval()
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with record_collectives(gp) as rec, \
            meshlib.ordered_collectives(dev), \
            torch.profiler.profile(activities=acts) as prof:
        out, forces, stress, _res = run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    audit = audit_collectives(rec)
    summary = audit.summary()
    got = (summary["shift_bytes_forward"], summary["shift_bytes_transpose"])
    result = {
        "outputs": (out.detach(), forces.detach(), stress.detach()),
        "audit": audit, "summary": summary, "expected": expected,
        "bytes_match": got == want, "layout": layout,
        "ring": os.environ.get("ALIGNN_TPU_GP_RING", "chain")
        if layout != "dense" else "halo",
        "devices": axis.size, "dtype_bytes": dtype_bytes,
        "e_pad": int(batch.src.shape[0]), "halo_steps": halo_steps,
        "exchanges": audit.exchanges()}
    result["schedule"] = audit_schedule_overlap(trace_of(prof))
    result["schedule_finding"] = schedule_finding(result["schedule"])
    return result


def summary_json(result: Dict) -> Dict:
    """The JSON-able part of an :func:`audit_gp_forward` result."""
    return {k: v for k, v in result.items()
            if k not in ("outputs", "audit", "schedule")}

