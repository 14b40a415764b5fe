"""alignn_tpu_torch's graph parallelism against alignn_tpu's one-device model,
on the CPU.

Four gloo ranks (``tests/torch_port_gp_worker.py``, one spawn for the
module) form a ("data", "graph") mesh of shape (2, 2); data row d holds
micro-batch d (two rattled rocksalt cells, sparse and dense).  From the
same carried JAX weights:

- the two-rank ring forward (chain and gather) and dense-halo forward of
  each row equal JAX's single-device E/F/S of that row's batch within 1e-4
  eV/atom, 5e-4 eV/A and 1e-5 eV/A^3;
- the two-rank ring (both modes) and dense-halo train steps, and the 2 x 2
  data x ring and data x dense steps, give JAX's single-device gradients
  (the 2 x 2 steps the mean of the two rows') within 1e-3 x max|grad| +
  1e-7, and losses within 1e-4 relative;
- ``ring_broadcast`` equals the chain of shifts in value, gradient and
  gradient of gradient, and ``all_gather``'s gradient is the reduce-scatter
  of its cotangent;
- ``cli.train``'s folder training on the 2 x 2 mesh (sparse and dense
  configs, ``train_for_folder(devices=4)`` inside the ranks' group)
  trains, rank 0 writes the artifacts;
- the GP models' parameter trees are ALIGNNAtomWise's (a converted JAX
  tree loads strictly).

1+1 layers, width 32; JAX's reference is one value-and-gradient compile
a layout.
"""

import json
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_port_gp_worker.py")
sys.path.insert(0, HERE)

from test_torch_port_dp import _free_port, _jax_graphs, _run_ranks  # noqa
from torch_port_threads import _two_threads  # noqa: E402,F401

E_TOL, F_TOL, S_TOL = 1e-4, 5e-4, 1e-5 * 160.21766208   # stress in GPa


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's {(layout, row): (res, losses, grads by torch name)}, the four
    ranks' npz, the folder runs' listings)."""
    import jax

    from alignn_tpu.config import model_config_from_dict as jcfg
    from alignn_tpu.graph.batch import BucketSpec as JSpec
    from alignn_tpu.graph.batch import batch_graphs as jbatch
    from alignn_tpu.graph.dense import dense_batch_graphs as jdense
    from alignn_tpu.nn.models import ALIGNNAtomWise as JModel
    from alignn_tpu.train.checkpoint import checkpoint_meta, save_params
    from alignn_tpu.train.state import _forward_and_loss

    from alignn_tpu_torch.nn.convert import state_dict_from_flax
    from torch_port_gp_worker import MODEL, micro_batches

    out = str(tmp_path_factory.mktemp("gp"))
    _s, _d, rows, (spec, dspec) = micro_batches()
    jspec = JSpec(spec.n_nodes, spec.n_edges, spec.n_lg_edges, spec.n_graphs)
    jdspec = JSpec(dspec.n_nodes, dspec.n_edges, dspec.n_lg_edges,
                   dspec.n_graphs, dspec.dense_D)
    model = JModel(cfg=jcfg(MODEL))
    batches = {("sparse", d): jbatch(_jax_graphs(r), jspec)
               for d, r in enumerate(rows)}
    batches.update({("dense", d): jdense(_jax_graphs(r), jdspec)
                    for d, r in enumerate(rows)})
    params = jax.jit(lambda b: model.init(jax.random.PRNGKey(3), b, b.r,
                                          train=False))(
        batches["sparse", 0])["params"]
    save_params(os.path.join(out, "init.mpk"), params, {},
                meta=checkpoint_meta())

    def loss(p, b):
        total, (losses, res, _bs) = _forward_and_loss(
            model, p, {}, b, "l1", False, train=True)
        return total, (losses, res)

    grad = jax.jit(jax.value_and_grad(loss, has_aux=True))
    ref = {}
    for key, b in batches.items():
        (_t, (losses, res)), g = grad(params, b)
        ref[key] = ({k: np.asarray(v) for k, v in res.items()},
                    {k: float(v) for k, v in losses.items()},
                    {k: v.numpy() for k, v in state_dict_from_flax(
                        jax.device_get(g)).items()})
    from test_torch_port_trainer import write_config, write_folder
    from test_torch_port_trainer_ff import FF_MODEL

    write_folder(os.path.join(out, "folder"), 12, seed=2, kind="json")
    for layout, extra in (("sparse", {}),
                          ("dense", {"dense_neighborhoods": True,
                                     "use_canonize": True})):
        write_config(os.path.join(out, f"config_{layout}.json"),
                     model=FF_MODEL, epochs=1, batch_size=2, n_train=8,
                     n_val=2, n_test=2,
                     mesh_shape={"data": 2, "graph": 2}, use_cache=False,
                     **extra)
    port = _free_port()
    _run_ranks(lambda r: [WORKER, str(r), "4", str(port), out], world=4)
    ranks = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
             for r in range(4)]
    folders = []
    for r in range(4):
        with open(os.path.join(out, f"folder_rank{r}.json")) as f:
            folders.append(json.load(f))
    return ref, ranks, folders


def _forward_close(rank, prefix, ref, n_atoms):
    res = ref[0]
    got_e = rank[f"{prefix}/out"][:, 0] / np.maximum(n_atoms, 1)
    want_e = res["out"][:, 0] / np.maximum(n_atoms, 1)
    np.testing.assert_allclose(got_e, want_e, atol=E_TOL, rtol=0)
    np.testing.assert_allclose(rank[f"{prefix}/forces"], res["grad"],
                               atol=F_TOL, rtol=0)
    np.testing.assert_allclose(rank[f"{prefix}/stress"], res["stresses"],
                               atol=S_TOL, rtol=0)


def _grads_close(rank, prefix, grads):
    keys = sorted(k[len(prefix) + 3:] for k in rank
                  if k.startswith(prefix + "/g/"))
    assert keys == sorted(grads)
    for k in keys:
        got, want = rank[f"{prefix}/g/{k}"], grads[k]
        tol = 1e-3 * np.abs(want).max() + 1e-7
        np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=k)


def _losses_close(rank, prefix, losses):
    keys = [str(k) for k in rank["loss_keys"]]
    np.testing.assert_allclose(rank[f"{prefix}/losses"],
                               [losses[k] for k in keys], rtol=1e-4,
                               atol=1e-7)


@pytest.mark.parametrize("prefix,layout", [("ring_chain", "sparse"),
                                           ("ring_gather", "sparse"),
                                           ("dense", "dense")])
def test_forward_matches_jax_single_device(runs, prefix, layout):
    """Every rank of row d returns JAX's one-device E/F/S of batch d."""
    from torch_port_gp_worker import micro_batches

    ref, ranks, _f = runs
    batches = micro_batches()[0 if layout == "sparse" else 1]
    for r, rank in enumerate(ranks):
        _forward_close(rank, prefix, ref[layout, r // 2],
                       batches[r // 2].n_nodes.numpy())


@pytest.mark.parametrize("prefix,layout", [("ring_chain_step", "sparse"),
                                           ("ring_gather_step", "sparse"),
                                           ("dense_step", "dense")])
def test_graph_step_matches_jax_single_device(runs, prefix, layout):
    """The two-rank graph-axis step's losses and gradients are JAX's
    one-device step's on the row's batch."""
    ref, ranks, _f = runs
    for r, rank in enumerate(ranks):
        _res, losses, grads = ref[layout, r // 2]
        _losses_close(rank, prefix, losses)
        _grads_close(rank, prefix, grads)


@pytest.mark.parametrize("prefix,layout", [("dp_ring_step", "sparse"),
                                           ("dp_dense_step", "dense")])
def test_2x2_step_matches_averaged_single_device(runs, prefix, layout):
    """The data x graph step averages the two rows' one-device JAX
    gradients and losses; all four ranks hold the same."""
    ref, ranks, _f = runs
    (_r0, l0, g0), (_r1, l1, g1) = ref[layout, 0], ref[layout, 1]
    losses = {k: (l0[k] + l1[k]) / 2 for k in l0}
    grads = {k: (g0[k] + g1[k]) / 2 for k in g0}
    for rank in ranks:
        _losses_close(rank, prefix, losses)
        _grads_close(rank, prefix, grads)
    for k in ranks[0]:
        if k.startswith(prefix + "/"):
            for rank in ranks[1:]:
                np.testing.assert_array_equal(rank[k], ranks[0][k], k)


def test_ring_broadcast_grad_of_grad_matches_chain(runs):
    """ring_broadcast (gather mode's custom backward: one shift -k a row)
    equals the chain of neighbour shifts in value, gradient and gradient
    of gradient; row k on rank c is rank (c - k)'s input."""
    _ref, ranks, _f = runs
    for r, rank in enumerate(ranks):
        for k in ("y", "g", "gg"):
            np.testing.assert_allclose(rank[f"broadcast/{k}"],
                                       rank[f"chain/{k}"], rtol=1e-12,
                                       atol=1e-12, err_msg=k)
        row = r // 2
        for k in range(2):
            src = ranks[2 * row + (r % 2 - k) % 2]
            np.testing.assert_array_equal(rank["broadcast/y"][k],
                                          src["inputs/x"])


def test_all_gather_transposes_to_reduce_scatter(runs):
    """all_gather stacks the row's inputs in axis order; its gradient of
    sum(w * y) on rank c is the sum over the row of the ranks' w slots
    for c."""
    _ref, ranks, _f = runs
    for r, rank in enumerate(ranks):
        row = [ranks[2 * (r // 2)], ranks[2 * (r // 2) + 1]]
        np.testing.assert_array_equal(
            rank["all_gather/y"],
            np.concatenate([q["inputs/x"] for q in row]))
        c = r % 2
        want = sum(q["inputs/w"][c] for q in row)
        np.testing.assert_allclose(rank["all_gather/g"], want, rtol=1e-12)


def test_edges_per_second_scaling(runs):
    """edges_per_second_scaling on the first 1 and 2 ranks: a rate for
    each mesh size on the ranks that ran it, none on the others."""
    _ref, ranks, _f = runs
    assert np.all(ranks[0]["edges_per_second"] > 0)
    assert ranks[1]["edges_per_second"][0] == 0 < \
        ranks[1]["edges_per_second"][1]
    for rank in ranks[2:]:
        assert not np.any(rank["edges_per_second"])


@pytest.mark.parametrize("layout", ["sparse", "dense"])
def test_folder_training_on_2x2_mesh(runs, layout):
    """``train_for_folder(devices=4)`` with ``mesh_shape {"data": 2,
    "graph": 2}`` trains an FF config on the four ranks (ring step for
    the sparse loader, halo step for the dense one): finite epoch losses,
    the same on every rank; rank 0 alone writes the artifacts."""
    _ref, _ranks, folders = runs
    for r, runs_of_rank in enumerate(folders):
        got = runs_of_rank[layout]
        assert got["step"] == ("dense" if layout == "dense" else "ring")
        assert np.all(np.isfinite(got["step_losses"]))
        assert got["step_losses"] == folders[0][layout]["step_losses"]
        if r == 0:
            for name in ("config.json", "history_train.json",
                         "best_model.mpk", "Test_results.json"):
                assert name in got["files"], name
        else:
            assert got["files"] == []


def test_gp_models_carry_the_jax_tree():
    """The GP models' parameter trees are ALIGNNAtomWise's: a JAX tree
    converted by nn/convert loads into each, strictly, and ``sharing``
    binds a model's own parameters."""
    import jax

    from alignn_tpu.config import model_config_from_dict as jcfg
    from alignn_tpu.graph.batch import BucketSpec as JSpec
    from alignn_tpu.graph.batch import batch_graphs as jbatch
    from alignn_tpu.nn.models import ALIGNNAtomWise as JModel

    from alignn_tpu_torch.config import model_config_from_dict
    from alignn_tpu_torch.nn.convert import state_dict_from_flax
    from alignn_tpu_torch.nn.models import ALIGNNAtomWise
    from alignn_tpu_torch.parallel.dense_gp import DenseGPALIGNNAtomWise
    from alignn_tpu_torch.parallel.gp_model import GPALIGNNAtomWise
    from torch_port_gp_worker import MODEL, micro_batches

    rows, (spec, _d) = micro_batches()[2:]
    jb = jbatch(_jax_graphs(rows[0]), JSpec(spec.n_nodes, spec.n_edges,
                                            spec.n_lg_edges, spec.n_graphs))
    jm = JModel(cfg=jcfg(MODEL))
    params = jax.eval_shape(lambda b: jm.init(jax.random.PRNGKey(0), b,
                                              b.r, train=False), jb)
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                    params["params"])
    sd = state_dict_from_flax(params)
    cfg = model_config_from_dict(MODEL)
    base = ALIGNNAtomWise(cfg)
    base.load_state_dict(sd)
    for cls in (GPALIGNNAtomWise, DenseGPALIGNNAtomWise):
        m = cls(cfg)
        m.load_state_dict(sd)
        assert sorted(m.state_dict()) == sorted(sd)
        shared = cls.sharing(base, None)
        for (na, a), (nb, b) in zip(shared.named_parameters(),
                                    base.named_parameters()):
            assert na == nb and a is b


def test_ordered_collectives_fix_the_backward_order(monkeypatch):
    """The outer backward of a force loss meets its collectives in an
    order that, without ``ordered_collectives``, follows how much autograd
    work the inner backward's thread did before (ranks that did different
    work would wait in different collectives: a hang on the card, where
    that thread is the device's worker); with it, always the reverse of
    the order they were made.  The inner backward runs on a helper
    thread, as on the card; ``dist.all_reduce`` is replaced by a log."""
    import concurrent.futures
    import contextlib

    import torch

    from alignn_tpu_torch.parallel import mesh as meshlib

    log = []
    monkeypatch.setattr(meshlib.dist, "all_reduce",
                        lambda t, group=None: log.append(group))

    def advance(n):   # autograd work that makes nodes on the helper
        for _ in range(n):
            x = torch.randn(2, requires_grad=True)
            (g,) = torch.autograd.grad((x * x).sum(), x, create_graph=True)
            g.sum().backward()

    def outer_order(work, ordered):
        # fresh threads, whose sequence numbers start from 0: the caller
        # runs the forward and the outer backward, the helper the inner
        # backward after `work` rounds of its own
        caller = concurrent.futures.ThreadPoolExecutor(1)
        helper = concurrent.futures.ThreadPoolExecutor(1)

        def run():
            with meshlib.ordered_collectives("cpu") if ordered else \
                    contextlib.nullcontext():
                r = torch.randn(5, requires_grad=True)
                w = torch.randn(5, requires_grad=True)
                a = meshlib.all_reduce_sum(torch.sin(r * w), "A")
                b = meshlib.all_reduce_sum(torch.cos(r) * w, "B")
                energy = (a * a).sum() + (b ** 3).sum()
                (g,) = helper.submit(torch.autograd.grad, energy, r,
                                     create_graph=True).result()
                log.clear()
                ((g * g).sum() + energy).backward()
            return list(log)

        try:
            helper.submit(advance, work).result()
            return caller.submit(run).result()
        finally:
            caller.shutdown()
            helper.shutdown()

    assert outer_order(0, False) != outer_order(5000, False)
    assert outer_order(0, True) == outer_order(5000, True) == \
        ["A", "B", "B", "A"]
