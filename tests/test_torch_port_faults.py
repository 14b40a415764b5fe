"""Two repaired faults of the port, on the CPU with a 1+1/16 model.

- ``Calculator(model=m)`` patches ``stresswise_weight`` 0 -> 0.1 on a
  model object of its own (sharing m's parameters), as the JAX Calculator
  does; the caller's ``m.cfg``, and so the loss of a later
  ``make_train_step(m)``, stay as they were.
- With ``link="log"`` the output bias starts at log(0.7), as JAX's
  ``_link_init_bias`` sets it, after construction and after
  ``init_parameters``.
"""

import numpy as np
import pytest
import torch
from torch_port_threads import _two_threads  # noqa: E402,F401

SMALL = dict(alignn_layers=1, gcn_layers=1, hidden_features=16,
             embedding_features=8)
CPU = torch.device("cpu")


def _model(**kw):
    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig,
                                            init_parameters)

    model = ALIGNNAtomWise(ALIGNNAtomWiseConfig(**SMALL, **kw))
    return init_parameters(model, torch.Generator().manual_seed(0))


def _strained_si():
    from alignn_tpu_torch.chem.atoms import Atoms

    frac = np.array([[0, 0, 0], [0.25, 0.25, 0.25], [0, 0.5, 0.5],
                     [0.25, 0.75, 0.75], [0.5, 0, 0.5], [0.75, 0.25, 0.75],
                     [0.5, 0.5, 0], [0.75, 0.75, 0.25]])
    lat = np.diag([5.43 * 1.03, 5.43, 5.43 * 0.98])
    return Atoms(lattice_mat=lat, frac_coords=frac, elements=["Si"] * 8)


def test_calculator_leaves_the_callers_cfg():
    from alignn_tpu_torch.ff.calculator import Calculator
    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.graph.build import rocksalt_graphs
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    m = _model()
    assert m.cfg.stresswise_weight == 0.0
    calc = Calculator(model=m, config={"neighbor_strategy": "k-nearest"},
                      device="cpu")
    assert m.cfg.stresswise_weight == 0.0
    assert calc.model.cfg.stresswise_weight == 0.1
    # the Calculator's model shares the caller's parameters, not its module
    assert calc.model.fc.weight is m.fc.weight
    assert calc.model is not m and calc.model.fc is not m.fc
    m.train()
    assert not calc.model.training and not calc.model.fc.training
    m.eval()
    res = calc.calculate(_strained_si())
    assert np.all(np.isfinite(res["stress"]))
    assert np.abs(res["stress"]).max() > 0.0

    graphs = rocksalt_graphs(2, seed=0)
    batch = batch_graphs(graphs, BucketSpec.tight_for_batch(graphs), CPU)
    state = create_train_state(m, batch, build_optimizer("adamw", 1e-3,
                                                         1e-5))
    _state, losses = make_train_step(m)(state, batch)
    assert float(losses["loss4"]) == 0.0        # no stress loss
    assert float(losses["loss3"]) > 0.0         # the force loss runs


@pytest.mark.parametrize("classification", [False, True])
def test_log_link_bias_starts_at_log_0_7(classification):
    from alignn_tpu_torch.nn.models import init_parameters

    m = _model(link="log", classification=classification)
    want = float(np.log(0.7))
    got = m.fc.bias.detach().numpy()
    if classification:   # JAX's classification head takes no link init
        assert not np.allclose(got, want)
        return
    np.testing.assert_array_equal(got, np.float32(want))
    init_parameters(m, torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(m.fc.bias.detach().numpy(),
                                  np.float32(want))
    ident = _model(link="identity")
    assert not np.allclose(ident.fc.bias.detach().numpy(), want)


def test_log_link_bias_matches_jax_init():
    import jax

    from alignn_tpu.graph.batch import BucketSpec as JSpec
    from alignn_tpu.graph.batch import batch_graphs as jbatch
    from alignn_tpu.graph.build import GraphData as JGraph
    from alignn_tpu.nn.models import ALIGNNAtomWise as JModel
    from alignn_tpu.nn.models import ALIGNNAtomWiseConfig as JConfig
    from alignn_tpu_torch.graph.build import rocksalt_graphs
    from alignn_tpu_torch.nn.convert import state_dict_from_flax

    graphs = [JGraph(**vars(g)) for g in rocksalt_graphs(1, seed=0)]
    jb = jbatch(graphs, JSpec.tight_for_batch(graphs), gather_windows=False)
    cfg = dict(SMALL, link="log")
    variables = JModel(cfg=JConfig(**cfg)).init(jax.random.PRNGKey(0), jb,
                                                jb.r, train=False)
    carried = state_dict_from_flax(variables["params"])["fc.bias"]
    np.testing.assert_array_equal(
        _model(link="log").fc.bias.detach().numpy(), carried.numpy())
