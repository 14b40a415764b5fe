"""Projected scaling of the graph-parallel step over GPU links
(counterpart of ``tools/ici_projection.py``).

The card's host has one GPU, so multi-GPU scaling is projected, not
measured: a one-card anchor (the one-process step's device time, measured
on the card by the caller) plus the wire bytes of the graph-parallel step
(audited by :mod:`~alignn_tpu_torch.parallel.collective_audit` where the
axis size was run, from the analytic models elsewhere) over a published
link bandwidth.  Every figure it prints is a projection from a published
bandwidth, not a measurement.

Model (per train step, the ring on one axis of D GPUs), as JAX's:

  T_comp(D) = T1 / D            the edge space splits into equal shards
  ring bytes                    (D-1) * E/D * 2F * dtype per L-stage and
                                the [E/D, 3] cosine ring, mirrored by the
                                reverse (collective_audit pins both)
  psum bytes                    2 (D-1)/D * payload (ring all-reduce) of
                                the node-stage [N, 2F] f32 sums (forward
                                and reverse) and the force and stress sums

Exposure, from the audited dependency structure:
  - forward ring shifts depend on no segment sum of their stage, so they
    can hide under the forward L-stage compute: exposed
    max(0, t_wire - fwd_frac * T_comp);
  - the chain reverse is accumulate-and-forward: fully exposed;
  - the ``gather`` reverse's hops are independent: windowed as the
    forward, its link bytes scaled by sum_k min(k, D-k) / (D-1) (a shift
    by k rides min(k, D-k) links of a bidirectional ring);
  - the dense halo (``ring="halo"``): its hops are independent both
    ways, but the forward exchanges that the audit finds data-dependent
    on their own stage's aggregation (h_jt back, and the pair-force
    halo) are exposed in full (``fwd_serial``);
  - all-reduces: exposed in full.

Links (``LINKS``): NVLink 4 on an H100 SXM5, 450 GB/s a direction
(NVIDIA's H100 data sheet: 900 GB/s bidirectional), and PCIe Gen5 x16,
about 64 GB/s a direction.

    python -m alignn_tpu_torch.parallel.link_projection ANCHOR.json

prints one JSON row per (D in 2, 4, 8; chain, gather, halo; link;
overlap) from an anchor file that ``chip_smoke.py`` writes
(``build/gp/link_anchor.json``).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional, Sequence

from alignn_tpu_torch.parallel.collective_audit import (expected_halo_bytes,
                                                        expected_ring_bytes)

GB = 1e9
LABEL = "projection from a published link bandwidth, not a measurement"
LINKS = {
    "nvlink4_h100_sxm5": {
        "gb_per_s": 450.0,
        "source": "NVIDIA H100 data sheet: NVLink 4, 900 GB/s "
                  "bidirectional a GPU"},
    "pcie5_x16": {
        "gb_per_s": 64.0,
        "source": "PCI Express 5.0 x16: about 64 GB/s a direction"},
}
DEVICES = (2, 4, 8)


def analytic_bytes(d, e_pad, n_nodes, n_graphs, hidden, alignn_layers,
                   gcn_layers, buf_bytes=4, ring="chain"):
    """Per-rank wire bytes per train step (forward and reverse) of the
    ring mode.

    `buf_bytes`: the ring payload's dtype (the port's graph-parallel model
    computes in f32: 4).  ``ring="gather"``: reverse payload bytes are
    unchanged (D-1 shifts of the same buffer), but a shift by k rides
    min(k, D-k) links, so reverse link bytes scale by
    sum_k min(k, D-k) / (D-1)."""
    ring_fwd = expected_ring_bytes(
        d, e_pad, hidden, dtype_bytes=buf_bytes,
        alignn_layers=alignn_layers)["forward_total"]
    ring_bwd = ring_fwd                                # transpose mirrors
    if ring == "gather":
        hop_factor = sum(min(k, d - k) for k in range(1, d)) / (d - 1)
        ring_bwd = ring_fwd * hop_factor
    # node-stage sums: packed [N, 2F] (num + den) f32 a node update,
    # forward and reverse, and the force and stress sums
    n_psums = 2 * (alignn_layers + gcn_layers)
    psum_payload = n_psums * n_nodes * 2 * hidden * 4 \
        + n_nodes * 3 * 4 + n_graphs * 9 * 4
    ar = 2 * (d - 1) / d * psum_payload                # ring all-reduce
    return {"ring_fwd": ring_fwd, "ring_bwd": ring_bwd, "all_reduce": ar,
            "total": ring_fwd + ring_bwd + ar, "ring": ring}


def halo_wire(d, node_steps, edge_steps, n_nodes, n_graphs, hidden,
              alignn_layers, gcn_layers, buf_bytes=4):
    """Per-rank wire bytes per train step of the dense halo mode: the
    halo model's forward and reverse, its serial part (each L-stage's
    h_jt exchange and the pair-force exchange), the stress all-reduce and
    the force all-gather."""
    h = expected_halo_bytes(node_steps, edge_steps, hidden,
                            dtype_bytes=buf_bytes, r_dtype_bytes=4,
                            alignn_layers=alignn_layers,
                            gcn_layers=gcn_layers)
    serial = alignn_layers * h["per_l_stage"] // 2 + h["forces_exchange"]
    ar = 2 * (d - 1) / d * n_graphs * 9 * 4 + (d - 1) / d * n_nodes * 3 * 4
    return {"ring_fwd": h["forward_total"], "ring_bwd": h["transpose_total"],
            "fwd_serial": serial, "all_reduce": ar,
            "total": h["forward_total"] + h["transpose_total"] + ar,
            "ring": "halo"}


def audited_wire(summary: Dict, d: int, ring: str) -> Dict:
    """The wire of one audited step (:meth:`RingAudit.summary`): shift
    bytes by phase (the reverse in link bytes), the serial forward bytes,
    and the all-reduce and all-gather payloads at ring cost."""
    ar = 2 * (d - 1) / d * (summary["all_reduce_bytes_forward"]
                            + summary["all_reduce_bytes_transpose"]) \
        + (d - 1) / d * (summary["all_gather_bytes_forward"]
                         + summary["all_gather_bytes_transpose"])
    fwd, bwd = summary["link_bytes_forward"], summary["link_bytes_transpose"]
    return {"ring_fwd": fwd, "ring_bwd": bwd,
            "fwd_serial": summary["forward_serial_bytes"],
            "all_reduce": ar, "total": fwd + bwd + ar, "ring": ring}


def project(d, t1_s, wire, bw_gbps, fwd_frac, overlap=True):
    """The projected step of D ranks from the one-rank step `t1_s`, the
    `wire` bytes and a link of `bw_gbps` GB/s a direction; `fwd_frac` is
    the forward's share of the one-rank step, measured beside t1."""
    t_comp = t1_s / d
    bw = bw_gbps * GB
    t_fwd = wire["ring_fwd"] / bw
    t_bwd = wire["ring_bwd"] / bw
    t_ar = wire["all_reduce"] / bw
    t_serial = wire.get("fwd_serial", 0) / bw
    if overlap:
        window = fwd_frac * t_comp          # forward L-stage compute
        if wire.get("ring") in ("gather", "halo"):
            # independent reverse hops: hidden under the reverse compute,
            # charged the same conservative window
            exposed = (max(0.0, t_fwd - t_serial - window) + t_serial
                       + max(0.0, t_bwd - window) + t_ar)
        else:
            # chain reverse: accumulate-and-forward, fully exposed
            exposed = max(0.0, t_fwd - window) + t_bwd + t_ar
    else:
        exposed = t_fwd + t_bwd + t_ar
    t_step = t_comp + exposed
    return {"t_comp_ms": t_comp * 1e3, "t_wire_ms":
            (t_fwd + t_bwd + t_ar) * 1e3, "exposed_ms": exposed * 1e3,
            "t_step_ms": t_step * 1e3,
            "efficiency": t_comp / t_step}


def projection_rows(anchor: Dict, devices: Sequence[int] = DEVICES,
                    links: Optional[Dict] = None) -> list:
    """One row per (D, ring mode, link, overlap) from an anchor dict (see
    the module docstring; ``chip_smoke.py`` writes it).  The ring rows
    take the sparse anchor, the halo rows the dense one; at the audited
    axis size the bytes are the audit's."""
    links = links or LINKS
    c = anchor["counts"]
    rows = []
    for d in devices:
        for ring in ("chain", "gather", "halo"):
            layout = "dense" if ring == "halo" else "sparse"
            a = anchor["anchors"].get(layout)
            if a is None:
                continue
            audited = anchor.get("audit", {}).get(ring)
            if audited is not None and anchor["audit_devices"] == d:
                wire, source = audited_wire(audited, d, ring), "audited"
            elif ring == "halo":
                steps = anchor.get("halo_steps", {}).get(str(d))
                if steps is None:
                    continue
                wire = halo_wire(d, steps[0], steps[1], c["dense_n_nodes"],
                                 c["n_graphs"], anchor["hidden"],
                                 anchor["alignn_layers"],
                                 anchor["gcn_layers"], anchor["buf_bytes"])
                source = "analytic"
            else:
                wire = analytic_bytes(d, c["e_pad"], c["n_nodes"],
                                      c["n_graphs"], anchor["hidden"],
                                      anchor["alignn_layers"],
                                      anchor["gcn_layers"],
                                      anchor["buf_bytes"], ring)
                source = "analytic"
            for name, link in links.items():
                for overlap in (True, False):
                    r = project(d, a["t1_ms"] / 1e3, wire, link["gb_per_s"],
                                a["fwd_ms"] / a["t1_ms"], overlap)
                    rows.append({"what": LABEL, "devices": d, "ring": ring,
                                 "link": name, "gb_per_s": link["gb_per_s"],
                                 "overlap": overlap, "bytes": source,
                                 "wire_mb_per_rank": wire["total"] / 1e6,
                                 **r, "anchor_card": anchor["card"]})
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("anchor", help="anchor json (chip_smoke.py writes "
                                  "build/gp/link_anchor.json)")
    args = p.parse_args(argv)
    with open(args.anchor) as f:
        anchor = json.load(f)
    print(json.dumps({"what": LABEL, "anchor_card": anchor["card"],
                      "anchors": anchor["anchors"],
                      "counts": anchor["counts"],
                      "links": LINKS}))
    for row in projection_rows(anchor):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
