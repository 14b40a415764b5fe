"""One gloo rank of the collective audit of alignn_tpu_torch's graph
parallelism.

    python tests/torch_port_audit_worker.py RANK WORLD PORT OUTDIR [DEVICE]

Four ranks.  As a ("data", "graph") mesh of shape (2, 2), each data row
records one E/F/S forward (``create_graph=True``) of the ring in chain and
in gather mode and of the dense halo, on the 64-atom cell of
:func:`audit_graph` over its two graph ranks
(``collective_audit.audit_gp_forward``).  As one graph axis of four ranks
it records the same three, and the negative case: a shift whose payload
is a sorted segment sum of the stage's input.  Rank 0 writes the audits'
summaries, per-exchange rows and the per-call events to
``OUTDIR/audit.json``.  DEVICE (``cpu`` by default) is where the model
and the batches live; the ranks join under gloo either way (four ranks on
one card, as ``chip_smoke.py`` runs them).  Imports no jax.
"""

import dataclasses
import json
import os
import sys

import numpy as np

MODEL = {"name": "alignn_atomwise", "alignn_layers": 1, "gcn_layers": 1,
         "hidden_features": 16, "embedding_features": 8,
         "graphwise_weight": 1.0, "gradwise_weight": 1.0,
         "stresswise_weight": 0.1}


def audit_graph():
    """A rattled 2x2x2 rocksalt supercell (64 atoms, k-NN 12, cutoff 8):
    one crystal over the ranks, so the dense halo is not empty."""
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.graph.build import build_graph

    rng = np.random.default_rng(0)
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5],
                     [0, 0.5, 0.5], [0.5, 0, 0], [0, 0.5, 0],
                     [0, 0, 0.5], [0.5, 0.5, 0.5]])
    elems = ["Na", "Cl", "K", "Br", "Mg", "O", "Ca", "S"]
    atoms = Atoms(lattice_mat=np.eye(3) * 4.2, frac_coords=base,
                  elements=elems).make_supercell((2, 2, 2))
    atoms = Atoms(lattice_mat=atoms.lattice_mat,
                  frac_coords=atoms.frac_coords
                  + 0.02 * rng.standard_normal(atoms.frac_coords.shape),
                  elements=atoms.elements)
    g = build_graph(atoms, cutoff=8.0, max_neighbors=12)
    g.target = np.array([0.3])
    g.forces = rng.standard_normal((atoms.num_atoms, 3)) * 0.1
    g.stress = np.eye(3) * 0.01
    return g


def batches(device="cpu"):
    """(sparse batch, dense batch, their BucketSpecs) of audit_graph."""
    import torch

    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.graph.dense import (dense_batch_graphs,
                                              dense_spec_for_batch)

    g = audit_graph()
    spec = BucketSpec.tight_for_batch([g])
    dspec = dense_spec_for_batch([g], node_quantum=16)
    dev = torch.device(device)
    return (batch_graphs([g], spec, dev), dense_batch_graphs([g], dspec, dev),
            spec, dspec)


def _events(rec_or_audit):
    return [{"kind": c.kind, "phase": c.phase, "bytes": c.payload_bytes,
             "k": c.k, "stage": c.stage, "exchange": c.exchange,
             "scatter_deps": sorted(c.scatter_deps),
             "chain_deps": None if c.chain_deps is None
             else len(c.chain_deps)}
            for c in rec_or_audit.collectives]


def record_all(model, mesh, sparse, dense) -> dict:
    from alignn_tpu_torch.parallel.collective_audit import audit_gp_forward
    from alignn_tpu_torch.parallel.dense_gp import make_dense_gp_forward
    from alignn_tpu_torch.parallel.graph_parallel import make_gp_forward

    out = {}
    for name, layout, mode in (("chain", "ring", "chain"),
                               ("gather", "ring", "gather"),
                               ("halo", "dense", None)):
        if mode is not None:
            os.environ["ALIGNN_TPU_GP_RING"] = mode
        batch = dense if layout == "dense" else sparse
        r = audit_gp_forward(model, mesh, batch, layout=layout)
        plain = (make_dense_gp_forward if layout == "dense"
                 else make_gp_forward)(model, mesh)(batch)
        os.environ.pop("ALIGNN_TPU_GP_RING", None)
        out[name] = {"summary": r["summary"], "expected": r["expected"],
                     "bytes_match": r["bytes_match"],
                     "e_pad": r["e_pad"], "halo_steps": r["halo_steps"],
                     "exchanges": r["exchanges"],
                     "schedule_finding": r["schedule_finding"],
                     "events": _events(r["audit"]),
                     "recorded": [t.cpu().numpy().tolist()
                                  for t in r["outputs"]],
                     "unrecorded": [t.cpu().numpy().tolist()
                                    for t in plain]}
    return out


def negative_case(axis) -> dict:
    """A stage whose shifted payload is a sorted segment sum of its input
    (flagged), beside one whose payload is a linear map of it (not)."""
    import torch

    from alignn_tpu_torch.ops.eggc import Segments, sorted_segment_sum
    from alignn_tpu_torch.parallel.collective_audit import (
        audit_collectives, record_collectives)
    from alignn_tpu_torch.parallel.mesh import ring_shift

    class Stage(torch.nn.Module):
        def __init__(self, aggregate: bool):
            super().__init__()
            self.lin = torch.nn.Linear(4, 4)
            self.aggregate = aggregate

        def forward(self, x):
            if self.aggregate:
                seg = Segments.from_sorted(
                    torch.tensor([0, 0, 1, 2, 2, 2]), 3)
                x = sorted_segment_sum(x, seg)
            return ring_shift(self.lin(x), axis, 1)

    torch.manual_seed(0)
    x = torch.randn(6, 4, requires_grad=True)
    pre = torch.nn.Linear(4, 4)(x)
    with record_collectives() as rec:
        Stage(True)(pre)
        Stage(False)(pre)
    a = audit_collectives(rec)
    return {"flagged": [sorted(c.scatter_deps) for c in a.shifts()],
            "capable": [c.overlap_capable for c in a.shifts()]}


def main(rank: int, world: int, port: int, outdir: str,
         device: str = "cpu") -> None:
    import torch
    import torch.distributed as dist

    from alignn_tpu_torch.config import model_config_from_dict
    from alignn_tpu_torch.nn.models import ALIGNNAtomWise, init_parameters
    from alignn_tpu_torch.parallel import mesh as meshlib

    torch.set_num_threads(1)
    meshlib.initialize_distributed(f"localhost:{port}", world, rank,
                                   device=device, backend="gloo")
    mesh = meshlib.make_mesh(world, ("data", "graph"), (2, 2))
    row_mesh = dataclasses.replace(mesh, axis_names=("graph",), shape=(2,),
                                   axes={"graph": mesh.axis("graph")})
    line = meshlib.make_mesh(world, ("graph",), (world,))
    model = init_parameters(ALIGNNAtomWise(model_config_from_dict(MODEL)),
                            torch.Generator().manual_seed(0)).to(device)
    sparse, dense, _s, _d = batches(device)
    try:
        result = {"d2": record_all(model, row_mesh, sparse, dense),
                  "d4": record_all(model, line, sparse, dense),
                  "negative": negative_case(line.axis("graph"))}
        if rank == 0:
            with open(os.path.join(outdir, "audit.json"), "w") as f:
                json.dump(result, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         *sys.argv[5:6])
