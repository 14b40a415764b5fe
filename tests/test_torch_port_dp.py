"""alignn_tpu_torch's data-parallel training against alignn_tpu's, on the CPU.

(a) the sharded loader: each rank's ``batch_ids()`` and shard arrays equal
shard d of JAX's stacked ``[D, ...]`` batch, windows floored over all D
shards, over 2 epochs, for ``num_shards`` 1 and 2, ``num_hosts`` 1 and 2,
with and without shuffle; (b) the port's ``make_dp_train_step`` as two
gloo ranks (``tests/torch_port_dp_worker.py``, in subprocesses) against
JAX's ``make_dp_train_step`` on a 2-device CPU mesh, from the same
weights, on the same shards, for 2 steps: the BatchNorm property model
(the statistics and their gradient cross the ranks) and a small E/F/S
step; losses, parameters and running statistics within atol 2e-5, rtol
1e-4 (``tests/test_multiprocess.py``'s limits), the two ranks' parameters
bit-identical, and ``train_model_dp``'s rank 1 writing nothing; (c) a
world-size-1 step equals the single-rank step bit for bit; (d)
``cli.train --devices 2 --device cpu`` against JAX's
``train_for_folder(devices=2)``, and ``--profile`` under shards; (e) the
mesh's and the trainer's refusals (graph-axis parallelism itself is
``tests/test_torch_port_gp.py``'s).  1+1 layers, width 32, 16 rattled rocksalt cells.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
from torch_port_threads import _two_threads  # noqa: E402,F401

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_port_dp_worker.py")
ATOL, RTOL = 2e-5, 1e-4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run_ranks(args_of_rank, world: int = 2, timeout: int = 300):
    """The processes `args_of_rank(rank)`, all at once, each bounded by a
    hard timeout; their outputs."""
    procs = [subprocess.Popen([sys.executable, *args_of_rank(r)],
                              env=_env(), cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out[-3000:]}"
    return outs


def _jax_graphs(graphs):
    from alignn_tpu.graph.build import GraphData as JGraph

    return [JGraph(**vars(g)) for g in graphs]


# ---------------------------------------------------------------------------
# (a) the sharded loader
# ---------------------------------------------------------------------------

LOADER_FIELDS = ("z", "atom_features", "node_mask", "node_graph", "src",
                 "dst", "r", "edge_mask", "lg_src", "lg_dst", "lg_mask",
                 "target", "forces", "graph_mask", "n_nodes")
WINDOWS = ("win_src", "win_dst", "win_src_sorted", "win_lg_src",
           "win_lg_dst", "win_lg_src_sorted")


@pytest.mark.parametrize("num_shards", [1, 2])
@pytest.mark.parametrize("num_hosts", [1, 2])
@pytest.mark.parametrize("shuffle", [False, True])
def test_sharded_loader_matches_jax(num_shards, num_hosts, shuffle):
    """Every rank's loader (one a shard of each host) yields shard d of
    JAX's stacked batch, field for field and window for window, and its
    ``batch_ids()`` are shard d's slice of JAX's, over two epochs; under
    shards the last partial step is dropped, as in JAX."""
    import jax

    from alignn_tpu.data.dataset import GraphDataset as JDataset
    from alignn_tpu.data.loader import BucketedLoader as JLoader
    from alignn_tpu_torch.data.dataset import GraphDataset
    from alignn_tpu_torch.data.loader import BucketedLoader
    from alignn_tpu_torch.graph.build import rocksalt_graphs

    graphs = rocksalt_graphs(15, seed=4, rattle=0.05)
    ids = [f"c{i}" for i in range(len(graphs))]
    jgraphs = _jax_graphs(graphs)
    for host in range(num_hosts):
        kw = dict(shuffle=shuffle, num_shards=num_shards, host_id=host,
                  num_hosts=num_hosts, prefetch=0)
        ref = JLoader(JDataset(jgraphs, ids), 2, **kw)
        ports = [BucketedLoader(GraphDataset(graphs, ids), 2, device="cpu",
                                shard_index=d, **kw)
                 for d in range(num_shards)]
        for epoch in (0, 1):
            ref.set_epoch(epoch)
            jbatches = list(ref)
            jids = ref.batch_ids()
            assert len(jbatches) == len(jids) > 0
            for d, port in enumerate(ports):
                port.set_epoch(epoch)
                assert port.drop_last == ref.drop_last
                assert len(port) == len(ref)
                assert port.batch_ids() == [b[d * 2:(d + 1) * 2]
                                            for b in jids]
                for tb, jb in zip(port, jbatches):
                    if num_shards > 1:
                        jb = jax.tree_util.tree_map(lambda x: x[d], jb)
                    for f in LOADER_FIELDS:
                        np.testing.assert_array_equal(
                            getattr(tb, f).numpy(), np.asarray(getattr(jb, f)),
                            err_msg=f)
                    assert [getattr(tb, w) for w in WINDOWS] == \
                        [getattr(jb, w) for w in WINDOWS]


# ---------------------------------------------------------------------------
# (b) two gloo ranks against JAX's 2-device step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """{case: (JAX's losses per step, its final params and batch_stats as
    flat {"p/..."/"s/...": array}, the two ranks' npz)}, and the ranks'
    trainer listings."""
    import jax

    from alignn_tpu.config import model_config_from_dict as jcfg
    from alignn_tpu.data.dataset import GraphDataset as JDataset
    from alignn_tpu.data.loader import BucketedLoader as JLoader
    from alignn_tpu.parallel.dp import make_dp_train_step as jdp_step
    from alignn_tpu.parallel.mesh import make_mesh as jmesh
    from alignn_tpu.train.checkpoint import checkpoint_meta, save_params
    from alignn_tpu.train.optim import build_optimizer as jopt
    from alignn_tpu.train.state import create_train_state as jstate
    from alignn_tpu.train.trainer import build_model as jbuild

    sys.path.insert(0, HERE)
    from torch_port_dp_worker import BATCH, CASES, WD, dataset

    out = str(tmp_path_factory.mktemp("dp"))
    graphs, ids = dataset()
    jgraphs = _jax_graphs(graphs)
    jax_runs = {}
    for case, (cfg, opt, lr) in CASES.items():
        model = jbuild(jcfg(cfg), axis_name="data")
        loader = JLoader(JDataset(jgraphs, ids), BATCH, shuffle=True,
                         num_shards=2, prefetch=0)
        batches = list(loader)
        state = jstate(model, jax.tree_util.tree_map(lambda x: x[0],
                                                     batches[0]),
                       jopt(opt, lr, WD), seed=0)
        save_params(os.path.join(out, f"{case}.mpk"), state.params,
                    state.batch_stats, meta=checkpoint_meta())
        step = jdp_step(model, jmesh(2), criterion="l1", donate=False)
        losses = []
        for b in batches:
            state, lo = step(state, b)
            losses.append({k: float(v) for k, v in lo.items()})
        flat = {}
        for prefix, tree in (("p/", state.params),
                             ("s/", state.batch_stats)):
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                flat[prefix + "/".join(k.key for k in path)] = \
                    np.asarray(leaf)
        jax_runs[case] = (losses, flat, loader.batch_ids())
    port = _free_port()
    _run_ranks(lambda r: [WORKER, str(r), "2", str(port), out])
    ranks = {case: [dict(np.load(os.path.join(out, f"{case}_rank{r}.npz")))
                    for r in (0, 1)] for case in CASES}
    listings = []
    for r in (0, 1):
        with open(os.path.join(out, f"run_rank{r}.json")) as f:
            listings.append(json.load(f))
    return jax_runs, ranks, listings


@pytest.mark.parametrize("case", ["property", "efs"])
def test_dp_step_matches_jax(dp_runs, case):
    """Losses of both steps, the final parameters and the BatchNorm
    running statistics against JAX's 2-device step; the ranks' shards
    are JAX's, and their parameters and statistics equal bit for bit."""
    jax_runs, ranks, _l = dp_runs
    jlosses, jflat, jids = jax_runs[case]
    r0, r1 = ranks[case]
    assert len(jlosses) == len(r0["losses"]) == 2
    keys = [str(k) for k in r0["loss_keys"]]
    for row, ref in zip(r0["losses"], jlosses):
        np.testing.assert_allclose(row, [ref[k] for k in keys], rtol=RTOL,
                                   atol=ATOL)
    for d, r in enumerate((r0, r1)):
        assert r["ids"].tolist() == [b[d * 4:(d + 1) * 4] for b in jids]
    state_keys = [k for k in r0 if k.startswith(("p/", "s/"))]
    assert sorted(state_keys) == sorted(jflat)
    assert any(k.startswith("s/") for k in state_keys) == \
        (case == "property")
    for k in state_keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        np.testing.assert_allclose(r0[k], jflat[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    np.testing.assert_array_equal(r0["losses"], r1["losses"])


def test_dp_trainer_rank0_writes(dp_runs):
    """``train_model_dp``: rank 0 writes the artifacts, rank 1 nothing;
    both saw the same averaged step losses."""
    _j, _r, (rank0, rank1) = dp_runs
    assert rank1["files"] == []
    for name in ("config.json", "history_train.json", "history_val.json",
                 "best_model.mpk", "last_model.mpk", "restart.mpk",
                 "Test_results.json", "Val_results.json",
                 "Train_results.json"):
        assert name in rank0["files"], name
    assert "prediction_results_train_set.csv" not in rank0["files"]
    assert rank0["step_losses"] == rank1["step_losses"]


# ---------------------------------------------------------------------------
# (c) world size 1
# ---------------------------------------------------------------------------


def test_world_size_one_equals_single_rank():
    """At world size 1 (gloo) the data-parallel step, BatchNorm
    collectives included, gives the single-rank step's losses and
    parameters bit for bit, for the property model and the E/F/S step."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from torch_port_dp_worker import BATCH, CASES, WD, dataset

    from alignn_tpu_torch.config import model_config_from_dict
    from alignn_tpu_torch.data.dataset import GraphDataset
    from alignn_tpu_torch.data.loader import BucketedLoader
    from alignn_tpu_torch.nn.models import init_parameters
    from alignn_tpu_torch.parallel.dp import make_dp_train_step
    from alignn_tpu_torch.parallel.mesh import (initialize_distributed,
                                                make_mesh)
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import (create_train_state,
                                              make_train_step)
    from alignn_tpu_torch.train.trainer import build_model

    graphs, ids = dataset()
    initialize_distributed(f"localhost:{_free_port()}", 1, 0, device="cpu")
    try:
        mesh = make_mesh(1)
        for case, (cfg, opt, lr) in CASES.items():
            runs = []
            for group in (None, mesh.group):
                model = init_parameters(
                    build_model(model_config_from_dict(cfg), group=group),
                    torch.Generator().manual_seed(0))
                loader = BucketedLoader(GraphDataset(graphs[:8], ids[:8]),
                                        BATCH, shuffle=True, prefetch=0,
                                        device="cpu")
                step = make_train_step(model) if group is None else \
                    make_dp_train_step(model, mesh)
                state, losses = None, []
                for batch in loader:
                    state = state or create_train_state(
                        model, batch, build_optimizer(opt, lr, WD))
                    state, out = step(state, batch)
                    losses.append(torch.stack(list(out.values())))
                runs.append((torch.stack(losses), model.state_dict()))
            (la, sa), (lb, sb) = runs
            assert torch.equal(la, lb), case
            for k in sa:
                assert torch.equal(sa[k], sb[k]), (case, k)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# (d) cli.train --devices 2
# ---------------------------------------------------------------------------


def test_cli_train_devices_2_matches_jax(tmp_path):
    """``cli.train --devices 2 --device cpu`` spawns two gloo ranks and
    trains; the run directory holds the artifacts and no rank's scratch;
    its history matches JAX's ``train_for_folder(devices=2)`` from the
    same starting ``.mpk`` within the trainer test's limits (epoch 1
    1e-4, epoch 2 1e-3 relative), the test predictions within 1e-4."""
    import jax

    from alignn_tpu.chem.atoms import Atoms as JAtoms
    from alignn_tpu.cli.train import train_for_folder as jtrain
    from alignn_tpu.graph.batch import BucketSpec as JSpec
    from alignn_tpu.graph.batch import batch_graphs as jbatch
    from alignn_tpu.graph.build import build_graph as jbuild
    from alignn_tpu.nn.models import ALIGNN as JModel
    from alignn_tpu.nn.models import ALIGNNConfig as JConfig
    from alignn_tpu.train.checkpoint import checkpoint_meta, save_params

    from test_torch_port_trainer import SMALL_MODEL, write_config, \
        write_folder

    root = write_folder(tmp_path / "data", 16, seed=5)
    config = write_config(tmp_path / "config.json")
    g = jbuild(JAtoms.from_poscar(os.path.join(root, "POSCAR-0.vasp")))
    jm = JModel(cfg=JConfig(**{k: v for k, v in SMALL_MODEL.items()
                               if k != "name"}))
    v = jax.jit(lambda k, b: jm.init(k, b, train=False))(
        jax.random.PRNGKey(7), jbatch([g], JSpec.tight_for_batch([g])))
    init = str(tmp_path / "init.mpk")
    save_params(init, v["params"], v["batch_stats"], meta=checkpoint_meta())
    out = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    jtrain(root_dir=root, config_name=config, output_dir=out["jax"],
           restart_model_path=init, devices=2)
    res = subprocess.run(
        [sys.executable, "-m", "alignn_tpu_torch.cli.train", "--root_dir",
         root, "--config_name", config, "--output_dir", out["port"],
         "--restart_model_path", init, "--devices", "2", "--device", "cpu"],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, timeout=300)
    log = res.stdout.decode(errors="replace")
    assert res.returncode == 0, log[-3000:]
    assert "Test MAE:" in log
    files = set(os.listdir(out["port"]))
    assert {"config.json", "history_train.json", "best_model.mpk",
            "last_model.mpk", "Test_results.json", "mad",
            "ids_train_val_test.json"} <= files
    assert not any(f.startswith("rank") for f in files)

    def load(o, name):
        with open(os.path.join(o, name)) as f:
            return json.load(f)

    for name in ("history_train.json", "history_val.json"):
        got, ref = load(out["port"], name), load(out["jax"], name)
        assert len(got) == len(ref) == 2
        for row_g, row_r, rtol in zip(got, ref, (1e-4, 1e-3)):
            np.testing.assert_allclose(row_g, row_r, rtol=rtol, atol=1e-7)
    got, ref = load(out["port"], "Test_results.json"), \
        load(out["jax"], "Test_results.json")
    assert [r["id"] for r in got] == [r["id"] for r in ref]
    np.testing.assert_allclose([r["predictions"] for r in got],
                               [r["predictions"] for r in ref], atol=1e-4)


def test_cli_profile_under_shards(tmp_path):
    """``--profile`` with ``--devices 2`` starts no rank: it profiles
    shard 0's single-device step in this process, as JAX does."""
    import torch.distributed as dist

    from alignn_tpu_torch.cli import train

    from test_torch_port_trainer import write_config, write_folder

    root = write_folder(tmp_path / "data", 16, seed=6)
    config = write_config(tmp_path / "config.json", epochs=1)
    out = train.main(["--root_dir", root, "--config_name", config,
                      "--output_dir", str(tmp_path / "out"), "--devices",
                      "2", "--profile", str(tmp_path / "prof"), "--device",
                      "cpu"])
    assert out["step_time_s"] > 0
    assert os.path.exists(tmp_path / "prof" / "trace.json")
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# (e) refusals
# ---------------------------------------------------------------------------


def test_mesh_and_trainer_refusals(tmp_path):
    """An identity without an address raises as in JAX; a mesh before the
    group, or one whose size or shape does not lay out the ranks, raises;
    a shard index outside the shards raises; on a graph axis a property
    model raises JAX's ValueError and an edge count the axis does not
    divide raises (``check_divisible``); on CUDA more ranks than GPUs
    raise (NCCL refuses two ranks on one device)."""
    import torch
    import torch.distributed as dist

    from alignn_tpu_torch.cli.train import train_for_folder
    from alignn_tpu_torch.config import TrainingConfig
    from alignn_tpu_torch.data.dataset import GraphDataset
    from alignn_tpu_torch.data.loader import BucketedLoader
    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.graph.build import rocksalt_graphs
    from alignn_tpu_torch.parallel.dp import train_model_dp
    from alignn_tpu_torch.parallel.graph_parallel import check_divisible
    from alignn_tpu_torch.parallel.mesh import (initialize_distributed,
                                                make_mesh)

    with pytest.raises(ValueError, match="coordinator_address"):
        initialize_distributed(num_processes=2, process_id=0, device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        make_mesh()
    with pytest.raises(ValueError, match="shard_index"):
        BucketedLoader(GraphDataset([], []), 4, num_shards=2,
                       shard_index=2, device="cpu")
    prop = TrainingConfig.from_dict({
        "mesh_shape": {"data": 1, "graph": 2}, "output_dir": str(tmp_path),
        "model": {"name": "alignn"}})
    empty = BucketedLoader(GraphDataset([], []), 4, device="cpu")
    with pytest.raises(ValueError, match="requires an atomwise model"):
        train_model_dp(prop, empty, empty)
    cfg = TrainingConfig.from_dict({"output_dir": str(tmp_path)})
    graphs = rocksalt_graphs(1)
    batch = batch_graphs(graphs, BucketSpec.tight_for_batch(graphs),
                         torch.device("cpu"))
    check_divisible(batch, 2)
    with pytest.raises(ValueError, match="must divide the mesh size 3"):
        check_divisible(batch, 3)
    config = tmp_path / "config.json"
    config.write_text(json.dumps({"mesh_shape": {"data": 2, "graph": 2}}))
    if torch.cuda.device_count() < 4:
        with pytest.raises(ValueError, match="NCCL refuses two ranks"):
            train_for_folder(root_dir=str(tmp_path), config_name=str(config),
                             devices=4, device="cuda")
    initialize_distributed(f"localhost:{_free_port()}", 1, 0, device="cpu")
    try:
        with pytest.raises(ValueError, match="each rank holds one device"):
            make_mesh(2)
        with pytest.raises(ValueError, match="does not lay out"):
            make_mesh(1, axis_names=("data", "graph"), shape=(2, 2))
        cfg.mesh_shape = {"data": 1}
        with pytest.raises(ValueError, match="num_shards=2"):
            train_model_dp(cfg, BucketedLoader(
                GraphDataset([], []), 4, num_shards=2, device="cpu"), empty)
    finally:
        dist.destroy_process_group()
