"""Entry ``train``: training from scratch through the program's
``train.trainer.train_model``, as ``cli.train`` runs it.

Set-up draws the data set from the seed, builds the loaders with
``data.loader.get_train_val_loaders`` (the graph stage), draws fresh
weights on the device from the seed and hands them, as a model, to one
``train_model`` call.  That call's first ``warm_epochs`` epochs are
set-up too: each bucket's train and eval steps run eagerly twice and are
then captured as CUDA graphs.  The window opens when the trainer starts
epoch ``warm_epochs`` and holds whole epochs, each with its validation
pass; at the end of each validation pass the run ends where the window
would end nearest ``--seconds``, through the trainer's own early
stopping (``n_early_stopping`` 0 from then on).

Check, twice, against the reference, which follows AdamW on the same
structures: each step's loss, the first gradient as AdamW holds it after
one step, and the parameters' change over three steps.
- The start: the trainer's first three steps (set-up, eager sightings on
  the side stream) from the seed's weights.
- The window: its first three steps, replays of the captured graphs fed
  through ``StepLoop.load_batch``.  Their start is the program's own
  state, copied on the device when the window's first step begins
  (parameters and AdamW moments); the first gradient is worked out from
  the first moment before and after the first window step.
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from harness import taps as htaps
from harness.cell import (Cell, Check, Outcome, leaf_gaps, memory_peak,
                          tf32_products)
from harness.trace import Tracer
from reference import graph as rgraph
from reference import model as rmodel
from reference import train as rtrain

BETA1 = 0.9


def records_of(structures: list) -> list:
    recs = []
    for k, s in enumerate(structures):
        rec = {"jid": f"s{k:05d}", "target": s["target"],
               "atoms": {"lattice_mat": s["lattice"].tolist(),
                         "coords": s["frac"].tolist(),
                         "elements": s["elements"], "cartesian": False}}
        if "forces" in s:
            rec["atomwise_grad"] = s["forces"].tolist()
            rec["stresses"] = s["stress"].tolist()
        recs.append(rec)
    return recs


def run(cell: Cell) -> Outcome:
    from alignn_tpu_torch.config import TrainingConfig
    from alignn_tpu_torch.data.loader import get_train_val_loaders
    from alignn_tpu_torch.train import trainer
    from alignn_tpu_torch.ff.step_loop import StepLoop
    from alignn_tpu_torch.train.state import make_train_step

    t = cell.traffic
    ds = t["dataset"]
    prop = cell.model_cfg["name"] == "alignn"
    structures = importlib.import_module(
        f"traffic.{t['generator']}").training_set(ds, cell.seed)
    records = records_of(structures)
    warm = t["warm_epochs"]
    config = TrainingConfig.from_dict({
        **cell.config["training"], "model": cell.model_cfg,
        "dataset": "user_data", "target": "target",
        "epochs": warm + t["max_window_epochs"],
        "n_train": ds["n_train"], "n_val": ds["n_val"], "n_test": 0,
        "keep_data_order": True, "output_dir": cell.work_dir,
        "write_checkpoint": False, "write_predictions": False,
        "store_outputs": False, "progress": False, "num_workers": 0,
        "use_cache": False, "n_early_stopping": None})
    m = config.model
    tr_loader, va_loader, _te, _mad = get_train_val_loaders(
        records, id_tag="jid", atom_features=config.atom_features,
        neighbor_strategy=config.neighbor_strategy, cutoff=config.cutoff,
        cutoff_extra=config.cutoff_extra,
        max_neighbors=config.max_neighbors,
        use_canonize=config.use_canonize,
        compute_line_graph=config.compute_line_graph,
        batch_size=config.batch_size, split_seed=config.random_seed,
        n_train=config.n_train, n_val=config.n_val, n_test=0,
        keep_data_order=True, output_dir=cell.work_dir, num_workers=0,
        target_width=getattr(m, "output_features", 1),
        bucket_slack=config.bucket_slack, device=cell.device)
    out = Outcome()
    out.counters["graph_stage_s"] = tr_loader.graph_stats["graph_s"]
    gen = torch.Generator(device=cell.device).manual_seed(cell.seed)
    params0 = rmodel.init_params(cell.model_cfg, prop, gen, cell.device)
    model = trainer.build_model(m)
    from harness.weights import load_into

    load_into(model, params0)
    out.counters["trainer_start_s"] = time.perf_counter() - cell.t_process
    tracer = out.tracer = Tracer(cell.traced)
    taps = htaps.Taps()
    st = {"t0": None, "t_end": None, "epochs": 0, "first_ids": None,
          "window_ids": None, "profiled_ids": None, "start": {},
          "window": {}, "replays": 0, "replayed": 0}
    spe = len(tr_loader)

    def on_epoch(epoch: int):
        if epoch == 0:
            st["first_ids"] = tr_loader.batch_ids()[:3]
        if epoch == warm:
            st["window_ids"] = tr_loader.batch_ids()[:3]
            if cell.device == "cuda":
                torch.cuda.synchronize()
            st["t0"] = time.perf_counter()
            st["captures0"] = StepLoop.captures
            out.counters["setup_s"] = st["t0"] - cell.t_process
            tracer.spans.clear()
            if cell.traced:
                st["profiled_ids"] = (tr_loader.batch_ids(),
                                      va_loader.batch_ids())
                tracer.start()

    def on_val_end():
        if st["t0"] is None:
            return
        st["t_end"] = time.perf_counter()
        st["captures"] = StepLoop.captures - st["captures0"]
        st["epochs"] += 1
        if st["epochs"] == 1:
            tracer.stop()
        elapsed = st["t_end"] - st["t0"]
        if elapsed + 0.5 * elapsed / st["epochs"] >= cell.seconds:
            config.n_early_stopping = 0

    def factory(model_, criterion, classification):
        step = make_train_step(model_, criterion=criterion,
                               classification=classification)
        named = list(model_.named_parameters())

        def copies(what, opt):
            # on the device, in stream order: no wait for the device
            with torch.no_grad():
                if what == "params":
                    return {n: p.detach().clone() for n, p in named}
                return {n: opt.state[p][what].clone()
                        if what in opt.state[p] else torch.zeros_like(p)
                        for n, p in named}

        def wrapped(state, batch):
            opt = state.optimizer
            k = state.step
            if st["t0"] is None:
                rec, w = st["start"], k
            else:
                rec = st["window"]
                w = k - rec.setdefault("step0", k)
            if w == 0:
                rec.update(params=copies("params", opt),
                           exp_avg0=copies("exp_avg", opt),
                           exp_avg_sq0=copies("exp_avg_sq", opt))
            replays = st["replays"]
            with tracer.span("step_call"):
                result = step(state, batch)
            if w == 0:
                rec["exp_avg1"] = copies("exp_avg", opt)
            elif w == 2:
                rec["params3"] = copies("params", opt)
            if rec is st["window"] and w < 3 and st["replays"] > replays:
                st["replayed"] += 1
            return result
        return wrapped

    def eval_tap(original):
        def make(*a, **kw):
            step = original(*a, **kw)

            def wrapped(state, batch):
                with tracer.span("validation"):
                    return step(state, batch)
            return wrapped
        return make

    def fetch_tap(original):
        def wrapped(losses):
            with tracer.span("loss_fetch"):
                return original(losses)
        return wrapped

    def replay_tap(original):
        def wrapped(self, *a, **kw):
            st["replays"] += 1
            return original(self, *a, **kw)
        return wrapped

    taps.patch(trainer, "make_eval_step", eval_tap)
    taps.patch(trainer, "_losses_to_host", fetch_tap)
    if cell.device == "cuda":
        taps.patch(torch.cuda.CUDAGraph, "replay", replay_tap)
    if cell.traced:
        htaps.record_kernel_launches(taps, tracer)
    tracer.warm_up()
    # the loader's gather windows only grow, and a grown window is a new
    # batch signature and a new CUDA graph: meet the first window epochs'
    # batches now, so that the epoch the profiler reads, and as a rule the
    # whole window, captures nothing
    for epoch in range(warm, warm + t["prewarm_epochs"]):
        tr_loader.set_epoch(epoch)
        for _batch in tr_loader:
            pass
    train_view = htaps.LoaderTap(tr_loader, tracer, "batch_wait",
                                 on_epoch=on_epoch)
    val_view = htaps.LoaderTap(va_loader, tracer, "validation",
                               on_pass_end=on_val_end)
    try:
        summary = trainer.train_model(config, train_view, val_view,
                                      model=model,
                                      train_step_factory=factory)
    finally:
        taps.close()
        tracer.stop()
    out.memory_peak_bytes = memory_peak(cell)
    window_s = st["t_end"] - st["t0"]
    n_struct = st["epochs"] * spe * config.batch_size
    metric = t["end_to_end"]
    out.end_to_end[metric] = n_struct / window_s
    out.end_to_end["setup_s"] = out.counters["setup_s"]
    out.attempted = st["epochs"] * spe
    out.failed = 0
    out.counters.update(window_s=window_s, steps=st["epochs"] * spe,
                        window_epochs=st["epochs"],
                        window_captures=st["captures"],
                        window_checked_replays=st["replayed"],
                        batch_wait_s=tracer.spans.get("batch_wait", 0.0))
    out.counters["window_epoch_s"] = summary["epoch_s"][warm:]
    if cell.traced:
        _traced_counters(cell, out, tr_loader, va_loader, st, prop)
    by_id = {r["jid"]: s for r, s in zip(records, structures)}
    lr = {e: rtrain.epoch_lr(cell.config["training"]["scheduler"],
                             cell.config["training"]["learning_rate"],
                             config.epochs, e, spe) for e in (0, warm)}
    out.cases = {
        "": Case.of(st["start"], [[by_id[i] for i in ids]
                                  for ids in st["first_ids"]],
                    summary["step_losses"][0][:3], 0, lr[0],
                    params0=params0),
        "window_": Case.of(st["window"], [[by_id[i] for i in ids]
                                          for ids in st["window_ids"]],
                           summary["step_losses"][warm][:3], warm * spe,
                           lr[warm])}
    state = summary.pop("state")
    del state, summary, model, train_view, val_view
    if cell.device == "cuda":
        torch.cuda.empty_cache()
    out.checks = [c for prefix, case in out.cases.items()
                  for c in check(cell, case, prefix, prop)]
    return out


class Case:
    """Three steps of the program to follow: the state they start from
    (parameters and AdamW moments, or a fresh optimizer), their
    structures and learning rate, and what the program made of them (its
    losses, its first gradient, its change over the three steps; numpy,
    by name)."""

    def __init__(self, params0, moments, steps_taken, batches, lr, losses,
                 grads, change):
        self.params0, self.moments = params0, moments
        self.steps_taken, self.batches, self.lr = steps_taken, batches, lr
        self.losses, self.grads, self.change = losses, grads, change

    @classmethod
    def of(cls, rec, batches, losses, steps_taken, lr, params0=None):
        """From the copies a run made (`rec`); `params0`: the seed's
        weights, for steps that start with a fresh optimizer."""
        def host(d):
            return {k: v.detach().cpu().double().numpy()
                    for k, v in d.items()}
        fresh = params0 is not None
        params0 = params0 if fresh else rec["params"]
        m0, m1 = host(rec["exp_avg0"]), host(rec["exp_avg1"])
        p0, p3 = host(params0), host(rec["params3"])
        moments = None if fresh else {
            k: (rec["exp_avg0"][k], rec["exp_avg_sq0"][k]) for k in p0}
        return cls(params0=params0, moments=moments,
                   steps_taken=steps_taken, batches=batches, lr=lr,
                   losses=losses,
                   grads={k: (m1[k] - BETA1 * m0[k]) / (1 - BETA1)
                          for k in p0},
                   change={k: p3[k] - p0[k] for k in p0})


def _traced_counters(cell, out, tr_loader, va_loader, st, prop):
    """Model FLOPs of the profiled epoch: its train steps and its
    validation pass, on the real graphs' counts."""
    from harness.flops import StepFlops

    cfg = cell.model_cfg
    train_f = StepFlops(cfg, "train_property" if prop else "train_forces")
    eval_f = StepFlops(cfg, "forward" if prop else "forces")
    counts = {}
    for loader in (tr_loader, va_loader):
        for gid, g in zip(loader.dataset.ids, loader.dataset.graphs):
            counts[gid] = (g.num_nodes, g.num_edges, g.num_lg_edges)
    train_ids, val_ids = st["profiled_ids"]

    def total(fn, batches):
        f = 0.0
        for ids in batches:
            n, e, l = (sum(counts[i][k] for i in ids) for k in range(3))
            f += fn(n, e, l, len(ids))
        return f

    out.counters.update(
        profiled_flops=total(train_f, train_ids) + total(eval_f, val_ids),
        profiled_s=out.tracer.window_s,
        profiled_steps=len(train_ids))


def reference_graphs(cell: Cell, structures: list) -> list:
    tr = cell.config["training"]
    table = rmodel.elements()
    out = []
    for s in structures:
        z = [table[e]["z"] for e in s["elements"]]
        g = rgraph.build(z, s["frac"], s["lattice"], tr["cutoff"],
                         tr["max_neighbors"], tr["use_canonize"])
        g.target = s["target"]
        if "forces" in s:
            g.forces = s["forces"]
        out.append(g)
    return out


def follow(cell: Cell, case: Case, prop: bool, tf32: bool = False,
           half_batch: bool = False) -> dict:
    """The reference's three steps of `case`; `tf32` computes them with
    TF32 products (the control), `half_batch` leaves out half of each
    batch (a fault)."""
    tr = cell.config["training"]
    graphs = [reference_graphs(cell, b[:len(b) // 2] if half_batch else b)
              for b in case.batches]
    with tf32_products(cell.device, tf32):
        return rtrain.follow(case.params0, cell.model_cfg, tr, graphs, prop,
                             case.lr, cell.device, moments=case.moments,
                             steps_taken=case.steps_taken)


def check(cell: Cell, case: Case, prefix: str, prop: bool) -> list:
    return compare(cell, follow(cell, case, prop), case.losses, case.grads,
                   case.change, prefix)


def compare(cell, ref: dict, losses, grads, change, prefix: str = ""
            ) -> list:
    """The numbers compared, named with `prefix`, beside their limits."""
    counted = rtrain.counted_leaves(ref["grads"])
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                       ref["losses"]))
    grad = leaf_gaps(grads, ref["grads"], counted, f"{prefix}first grad")
    step = leaf_gaps(change, ref["change"], counted,
                     f"{prefix}change over 3 steps")
    # the change over three steps by its median leaf: the worst leaf's is
    # the noise of one small leaf (PERF.md section 2)
    values = {"loss_gap_rel": float(loss_gap),
              "first_grad_gap": max(grad.values()),
              "step3_change_gap_median_leaf":
                  float(np.median(list(step.values())))}
    return [Check(prefix + k, v, cell.limits[prefix + k])
            for k, v in values.items()]
