"""alignn_tpu_torch.nn: a small ALIGNNAtomWise against alignn_tpu's.

Random JAX init carried across by ``nn/convert.py``; the JAX side runs
``atomwise_forward`` with the Pallas kernels forced on (interpret mode on
the CPU).  hidden 128 so K1's Pallas path runs.  Same graph arrays on
both sides.
"""

import numpy as np
import pytest
import torch
from torch_port_threads import _two_threads  # noqa: E402,F401

DIAMOND = np.array([[0, 0, 0], [0.25, 0.25, 0.25], [0, 0.5, 0.5],
                    [0.25, 0.75, 0.75], [0.5, 0, 0.5], [0.75, 0.25, 0.75],
                    [0.5, 0.5, 0], [0.75, 0.75, 0.25]])
CFG = dict(name="alignn_atomwise", alignn_layers=2, gcn_layers=2,
           hidden_features=128, embedding_features=32,
           stresswise_weight=0.1, use_cutoff_function=True,
           inner_cutoff=3.0, use_penalty=True)


def _graphs():
    """Rattled diamond Si and a rattled compressed Si cell (its shortest
    bond < 1 A, so the short-bond penalty is live)."""
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.graph.build import build_graph

    rng = np.random.default_rng(11)
    out = []
    for a, n in ((5.43, 8), (2.2, 2)):
        frac = DIAMOND[:n] + rng.normal(0.0, 0.01, (n, 3))
        out.append(build_graph(
            Atoms(lattice_mat=np.eye(3) * a, frac_coords=frac,
                  elements=["Si"] * n),
            use_canonize=False, tie_tol=1e-6))
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    import os

    import jax

    from alignn_tpu.graph.batch import BucketSpec as JSpec
    from alignn_tpu.graph.batch import batch_graphs as jbatch
    from alignn_tpu.graph.build import GraphData as JGraph
    from alignn_tpu.nn.models import ALIGNNAtomWise as JModel
    from alignn_tpu.nn.models import ALIGNNAtomWiseConfig as JConfig
    from alignn_tpu.nn.models import atomwise_forward as jforward
    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.nn.convert import state_dict_from_flax
    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig,
                                            atomwise_forward)

    graphs = _graphs()
    spec = BucketSpec.tight_for_batch(graphs)
    jb = jbatch([JGraph(**vars(g)) for g in graphs],
                JSpec(n_nodes=spec.n_nodes, n_edges=spec.n_edges,
                      n_lg_edges=spec.n_lg_edges, n_graphs=spec.n_graphs),
                gather_windows=False)
    jmodel = JModel(cfg=JConfig(**CFG))
    variables = jmodel.init(jax.random.PRNGKey(0), jb, jb.r, train=False)
    old = os.environ.get("ALIGNN_TPU_FORCE_PALLAS")
    os.environ["ALIGNN_TPU_FORCE_PALLAS"] = "1"  # read at trace time
    try:
        jres = jax.jit(lambda b: jforward(jmodel, variables, b,
                                          train=False))(jb)
        jres = jax.device_get(jres)
    finally:
        if old is None:
            del os.environ["ALIGNN_TPU_FORCE_PALLAS"]
        else:
            os.environ["ALIGNN_TPU_FORCE_PALLAS"] = old

    model = ALIGNNAtomWise(ALIGNNAtomWiseConfig(**CFG))
    model.load_state_dict(state_dict_from_flax(variables["params"]))
    tb = batch_graphs(graphs, spec, torch.device("cpu"))
    tres = atomwise_forward(model.eval(), tb)
    return jres, tres, tb


def test_state_dict_carries_every_parameter():
    import jax

    from alignn_tpu_torch.nn.convert import state_dict_from_flax
    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig)

    model = ALIGNNAtomWise(ALIGNNAtomWiseConfig(**CFG))
    rng = np.random.default_rng(0)
    params = {}
    for name, p in model.state_dict().items():
        parts = name.split(".")
        leaf = {"weight": "kernel" if p.dim() == 2 else "scale",
                "bias": "bias"}[parts[-1]]
        node = params
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        shape = tuple(p.shape[::-1]) if leaf == "kernel" else tuple(p.shape)
        node[leaf] = rng.standard_normal(shape).astype(np.float16)
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    model.load_state_dict(sd)   # strict: every name and shape maps
    w = model.trunk.gcn_layers_1.src_gate.weight
    np.testing.assert_array_equal(
        w.detach().numpy(),
        params["trunk"]["gcn_layers_1"]["src_gate"]["kernel"].T
        .astype(np.float32))
    assert w.dtype == torch.float32


def test_energy_matches_jax(both):
    jres, tres, tb = both
    mask = tb.graph_mask.numpy() > 0
    np.testing.assert_allclose(tres["out"].detach().numpy()[mask],
                               jres["out"][mask], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tres["en_out"].detach().numpy()[mask],
                               jres["en_out"][mask], rtol=1e-5, atol=1e-6)


def test_penalty_is_live(both):
    _jres, tres, tb = both
    bl = tres["bondlength"].detach().numpy()[tb.edge_mask.numpy() > 0]
    assert bl.min() < 1.0


def test_forces_match_jax(both):
    jres, tres, tb = both
    mask = tb.node_mask.numpy() > 0
    f = tres["grad"].detach().numpy()
    np.testing.assert_allclose(f[mask], jres["grad"][mask], rtol=0,
                               atol=1e-5)
    assert np.abs(f[mask]).max() > 1e-3   # a non-trivial comparison


def test_stress_matches_jax(both):
    jres, tres, tb = both
    mask = tb.graph_mask.numpy() > 0
    s = tres["stresses"].detach().numpy()[mask]
    np.testing.assert_allclose(s, jres["stresses"][mask], rtol=1e-5,
                               atol=1e-4)
    assert np.abs(s).max() > 1e-3
