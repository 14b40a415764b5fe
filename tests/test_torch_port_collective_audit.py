"""alignn_tpu_torch/parallel/collective_audit.py and link_projection.py
against alignn_tpu's HLO audit and tools/ici_projection.py, on the CPU.

Four gloo ranks (``tests/torch_port_audit_worker.py``, one spawn for the
module) record one E/F/S forward (force gradient with its graph) of the
ring in chain and gather mode and of the dense halo, on one rattled
64-atom rocksalt cell (1+1 layers, width 16): over two ranks (each row of
a 2 x 2 mesh) and over one axis of four.  Pinned:

- over two ranks, the shift bytes of each phase and the shift counts
  equal JAX's ``audit_collectives`` permute totals of its 2-device module
  on the same batch, and ``expected_ring_bytes``/``expected_halo_bytes``,
  to the byte; over four, the analytic models;
- every forward ring payload has no segment sum of its own stage in its
  closure (overlap-capable, ``tests/test_ring_overlap.py``); a payload
  built through ``sorted_segment_sum`` is flagged;
- the chain ring's reverse is accumulate-and-forward (D-2 links a ring
  over four ranks), the gather ring's reverse is chain-free
  (``tests/test_ring_gather.py``), and the halo's reverse hops are
  independent (``tests/test_dense_gp.py``);
- recording changes no result; the schedule audit of the CPU trace finds
  no device work, and on a synthetic trace tells another stream's kernel
  from the collective's own copies;
- ``link_projection.analytic_bytes`` and ``project`` equal
  ``tools/ici_projection.py``'s on a grid of inputs, and the rows from an
  anchor carry the projection label and the anchor card.

JAX compiles three small GP modules (about 15 s).
"""

import json
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_port_audit_worker.py")
sys.path.insert(0, HERE)

from test_torch_port_dp import _free_port, _run_ranks  # noqa: E402
from torch_port_threads import _two_threads  # noqa: E402,F401

MODES = ("chain", "gather", "halo")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("audit"))
    port = _free_port()
    _run_ranks(lambda r: [WORKER, str(r), "4", str(port), out], world=4,
               timeout=300)
    with open(os.path.join(out, "audit.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def jax_audit():
    """JAX's HLO audit summary of its 2-device GP module (chain, gather,
    dense halo) on the same batch, and the halo steps."""
    import jax
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from alignn_tpu.config import model_config_from_dict as jcfg
    from alignn_tpu.graph.batch import BucketSpec as JSpec
    from alignn_tpu.graph.batch import batch_graphs as jbatch
    from alignn_tpu.graph.build import GraphData as JGraph
    from alignn_tpu.graph.dense import dense_batch_graphs as jdense
    from alignn_tpu.nn.models import ALIGNNAtomWise
    from alignn_tpu.parallel import dense_gp as jdgp
    from alignn_tpu.parallel.gp_batch import make_ring_index
    from alignn_tpu.parallel.gp_model import GPALIGNNAtomWise
    from alignn_tpu.parallel.graph_parallel import (batch_specs,
                                                    gp_device_outputs,
                                                    ring_specs)
    from alignn_tpu.parallel.hlo_audit import audit_collectives
    from alignn_tpu.parallel.mesh import make_mesh
    from torch_port_audit_worker import MODEL, audit_graph, batches

    _s, _d, spec, dspec = batches()
    jg = JGraph(**vars(audit_graph()))
    b = jbatch([jg], JSpec(spec.n_nodes, spec.n_edges, spec.n_lg_edges,
                           spec.n_graphs))
    db = jdense([jg], JSpec(dspec.n_nodes, dspec.n_edges,
                            dspec.n_lg_edges, dspec.n_graphs,
                            dspec.dense_D))
    cfg = jcfg(MODEL)
    variables = jax.jit(lambda x: ALIGNNAtomWise(cfg=cfg).init(
        jax.random.PRNGKey(0), x, x.r, train=False))(b)
    d = 2
    mesh = make_mesh(d, axis_names=("graph",))
    out = {}
    before = os.environ.get("ALIGNN_TPU_GP_RING")
    try:
        for mode in ("chain", "gather"):
            os.environ["ALIGNN_TPU_GP_RING"] = mode
            ring = make_ring_index(b, d)
            gpm = GPALIGNNAtomWise(cfg=cfg, axis_name="graph")

            def per_device(bb, rg):
                o, f, s, _ = gp_device_outputs(gpm, cfg, variables, bb, rg,
                                               d)
                return o, f, s

            text = jax.jit(shard_map(
                per_device, mesh=mesh,
                in_specs=(batch_specs(b), ring_specs(ring)),
                out_specs=(P(), P(), P()), check_rep=False)
            ).lower(b, ring).compile().as_text()
            out[mode] = audit_collectives(text).summary()
    finally:
        if before is None:
            os.environ.pop("ALIGNN_TPU_GP_RING", None)
        else:
            os.environ["ALIGNN_TPU_GP_RING"] = before
    idx = jdgp.make_dense_gp_index(db, d)
    gpd = jdgp.DenseGPALIGNNAtomWise(cfg=cfg)

    def per_device_dense(bb, ix):
        ix = jdgp._squeeze_index(ix)
        o, f, s, _ = jdgp.dense_gp_device_outputs(gpd, cfg, variables, bb,
                                                  ix, d)
        return o, f, s

    text = jax.jit(shard_map(
        per_device_dense, mesh=mesh,
        in_specs=(jdgp.dense_batch_specs(db), jdgp.index_specs(idx)),
        out_specs=(P(), P(), P()), check_rep=False)
    ).lower(db, idx).compile().as_text()
    out["halo"] = audit_collectives(text).summary()
    out["halo_steps"] = (idx.node_halo.steps, idx.edge_halo.steps)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_two_rank_bytes_match_jax_hlo_audit(port, jax_audit, mode):
    got, want = port["d2"][mode]["summary"], jax_audit[mode]
    assert got["shift_bytes_forward"] == want["permute_bytes_forward"]
    assert got["shift_bytes_transpose"] == want["permute_bytes_transpose"]
    assert got["shifts_forward"] == want["permutes_forward"]
    assert got["shifts_transpose"] == want["permutes_transpose"]
    assert got["shift_bytes_forward"] > 0 and got["shift_bytes_transpose"] > 0


@pytest.mark.parametrize("devices", ["d2", "d4"])
@pytest.mark.parametrize("mode", MODES)
def test_bytes_match_analytic_models(port, mode, devices):
    from alignn_tpu_torch.parallel.collective_audit import (
        expected_halo_bytes, expected_ring_bytes)
    from torch_port_audit_worker import MODEL

    run = port[devices][mode]
    d = int(devices[1])
    f, layers = MODEL["hidden_features"], MODEL["alignn_layers"]
    got = run["summary"]
    if mode == "halo":
        assert len(run["halo_steps"][0]) == d - 1
        want = expected_halo_bytes(*run["halo_steps"], f,
                                   alignn_layers=layers,
                                   gcn_layers=MODEL["gcn_layers"])
        assert got["shift_bytes_forward"] == want["forward_total"]
        assert got["shift_bytes_transpose"] == want["transpose_total"]
    else:
        want = expected_ring_bytes(d, run["e_pad"], f, alignn_layers=layers)
        assert got["shift_bytes_forward"] == want["forward_total"]
        assert got["shift_bytes_transpose"] == want["forward_total"]
    assert run["expected"] == want
    assert run["bytes_match"] is True


def test_two_rank_halo_steps_equal_jax(port, jax_audit):
    from alignn_tpu_torch.parallel.collective_audit import \
        expected_halo_bytes

    node, edge = jax_audit["halo_steps"]
    assert [list(node), list(edge)] == port["d2"]["halo"]["halo_steps"]
    want = expected_halo_bytes(node, edge, 16, alignn_layers=1,
                               gcn_layers=1)
    assert port["d2"]["halo"]["expected"] == want
    assert sum(node) > 0 and sum(edge) > 0


@pytest.mark.parametrize("devices", ["d2", "d4"])
@pytest.mark.parametrize("mode", ["chain", "gather"])
def test_forward_rings_overlap_capable(port, mode, devices):
    """No forward ring payload depends on a segment sum of its own stage:
    the shift can run while the stage's local aggregation does."""
    run = port[devices][mode]
    fwd = [e for e in run["events"]
           if e["kind"] == "shift" and e["phase"] == "forward"]
    d, layers = int(devices[1]), 1
    assert len(fwd) == (d - 1) * (layers + 1)
    assert all(e["scatter_deps"] == [] for e in fwd), fwd
    assert run["summary"]["forward_overlap_capable"] is True
    assert run["summary"]["forward_serial_bytes"] == 0


def test_reverse_ring_structure_pinned(port):
    """The chain reverse is accumulate-and-forward: over four ranks each
    ring's reverse (the L-stage's and the cosines') has D-2 hops that
    carry the previous hop's arrival; over two ranks there is one hop a
    ring and no link."""
    for devices, links in (("d2", 0), ("d4", 2)):
        rows = [r for r in port[devices]["chain"]["exchanges"]
                if r["phase"] == "transpose"]
        assert len(rows) == 2
        assert {r["stage"] for r in rows} == {
            "GPALIGNNAtomWise", "trunk.alignn_layers_0.edge_update"}
        assert all(r["chain_links"] == links for r in rows), rows
    assert port["d4"]["chain"]["summary"]["transpose_chain_links"] == 4


def test_gather_reverse_is_chain_free(port):
    for devices in ("d2", "d4"):
        s = port[devices]["gather"]["summary"]
        assert s["shifts_transpose"] > 0
        assert s["transpose_chain_links"] == 0
    # each shift by k rides min(k, D - k) links: 1, 2, 1 over four ranks
    s = port["d4"]["gather"]["summary"]
    assert s["link_bytes_transpose"] * 3 == s["shift_bytes_transpose"] * 4


def test_single_exchange_reverse_has_no_shift_chain(port):
    """The halo's reverse hops are independent; forward, the node and
    dst_gate exchanges are overlap-capable, while the h_jt exchange (the
    L-stage aggregation's own result) and the pair-force exchange are
    data-dependent on aggregations."""
    run = port["d4"]["halo"]
    assert run["summary"]["transpose_chain_links"] == 0
    fwd = [r for r in run["exchanges"] if r["phase"] == "forward"]
    flagged = [r for r in fwd if not r["overlap_capable"]]
    assert len(fwd) == 5 and len(flagged) == 2
    assert {r["stage"] for r in flagged} == {
        "trunk.alignn_layers_0.edge_update", ""}
    e = run["expected"]
    assert run["summary"]["forward_serial_bytes"] == \
        e["per_l_stage"] // 2 + e["forces_exchange"]


def test_segment_sum_payload_flagged(port):
    neg = port["negative"]
    assert neg["capable"] == [False, True]
    assert len(neg["flagged"][0]) == 1 and \
        neg["flagged"][0][0].startswith("_SortedSegmentSumBackward")
    assert neg["flagged"][1] == []


@pytest.mark.parametrize("mode", MODES)
def test_recording_changes_no_result(port, mode):
    for devices in ("d2", "d4"):
        run = port[devices][mode]
        for got, want in zip(run["recorded"], run["unrecorded"]):
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)


def test_schedule_audit_on_the_cpu_trace(port):
    for mode in MODES:
        f = port["d2"][mode]["schedule_finding"]
        assert f["collectives"] > 0 and f["overlapped"] == 0
        assert set(f["by_phase"]) == {"forward", "transpose"}


def test_schedule_audit_tells_streams_apart():
    from alignn_tpu_torch.parallel.collective_audit import (
        audit_schedule_overlap, schedule_finding)

    def x(cat, name, ts, dur, stream=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if stream is not None:
            e["args"] = {"stream": stream}
        return e

    trace = {"traceEvents": [
        x("user_annotation", "collective:shift:forward", 100, 50),
        x("gpu_memcpy", "Memcpy DtoH", 105, 5, 7),
        x("kernel", "segment_kernel", 110, 20, 7),      # its own stream
        x("user_annotation", "collective:all_reduce:transpose", 200, 50),
        x("kernel", "ncclDevKernel_AllReduce", 205, 30, 20),
        x("kernel", "gated_kernel", 210, 10, 7),        # another stream
        x("kernel", "late_kernel", 300, 10, 7),         # outside both
    ]}
    rows = audit_schedule_overlap(trace)
    assert [(r["kind"], r["phase"], r["overlapped"]) for r in rows] == [
        ("shift", "forward", False), ("all_reduce", "transpose", True)]
    assert rows[0]["compute_kernels_inside"] == 1
    assert schedule_finding(rows)["overlapped"] == 1


def _ici():
    sys.path.insert(0, REPO)
    from tools import ici_projection

    return ici_projection


@pytest.mark.parametrize("ring", ["chain", "gather"])
def test_projection_equals_ici_projection(ring):
    from alignn_tpu_torch.parallel import link_projection as lp

    ici = _ici()
    for d in (2, 3, 4, 8, 16):
        for e_pad, n_nodes, n_graphs, hidden, al, gl, buf in (
                (12288, 512, 1, 256, 4, 4, 4), (6144, 512, 64, 64, 2, 1, 2),
                (768, 64, 1, 16, 1, 1, 4)):
            want = ici.analytic_bytes(d, e_pad, n_nodes, n_graphs, hidden,
                                      al, gl, buf_bytes=buf, ring=ring)
            got = lp.analytic_bytes(d, e_pad, n_nodes, n_graphs, hidden,
                                    al, gl, buf_bytes=buf, ring=ring)
            assert got == want
            for t1, bw, frac, overlap in ((0.05, 450.0, 0.2, True),
                                          (0.05, 64.0, 0.2, False),
                                          (0.31, 450.0, 0.35, True),
                                          (0.002, 64.0, 0.1, True)):
                assert lp.project(d, t1, got, bw, frac, overlap) == \
                    ici.project(d, t1, want, bw, frac, overlap)


def test_projection_rows_from_an_anchor(port):
    from alignn_tpu_torch.parallel import link_projection as lp

    run = port["d2"]
    anchor = {
        "card": "a card, 1.00 W", "hidden": 16, "alignn_layers": 1,
        "gcn_layers": 1, "buf_bytes": 4,
        "counts": {"e_pad": run["chain"]["e_pad"], "n_nodes": 128,
                   "dense_n_nodes": 64, "n_graphs": 1},
        "anchors": {"sparse": {"t1_ms": 40.0, "fwd_ms": 8.0},
                    "dense": {"t1_ms": 30.0, "fwd_ms": 6.0}},
        "audit_devices": 2,
        "audit": {m: run[m]["summary"] for m in MODES},
        "halo_steps": {"4": [[64], [176]], "8": [[96], [264]]}}
    rows = lp.projection_rows(anchor)
    assert {r["what"] for r in rows} == {lp.LABEL}
    assert {r["anchor_card"] for r in rows} == {"a card, 1.00 W"}
    assert len(rows) == 3 * 3 * len(lp.LINKS) * 2
    d2 = [r for r in rows if r["devices"] == 2]
    assert {r["bytes"] for r in d2} == {"audited"}
    assert {r["bytes"] for r in rows if r["devices"] != 2} == {"analytic"}
    for r in rows:
        assert 0 < r["efficiency"] <= 1
        assert r["t_step_ms"] >= r["t_comp_ms"]
    # without overlap nothing hides; the audited ring bytes are the
    # analytic model's
    chain = lp.audited_wire(run["chain"]["summary"], 2, "chain")
    want = lp.analytic_bytes(2, run["chain"]["e_pad"], 128, 1, 16, 1, 1,
                             4, "chain")
    assert chain["ring_fwd"] == want["ring_fwd"]
    assert chain["ring_bwd"] == want["ring_bwd"]
