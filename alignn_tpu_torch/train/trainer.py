"""The training loop: epochs, validation, checkpoints, artifacts.

Counterpart of ``alignn_tpu/train/trainer.py``, with the same artifacts
in ``config.output_dir``:

- ``config.json``; per epoch ``history_{train,val}.json`` (loss and
  loss1..loss5), ``current_model.mpk`` and ``restart.mpk`` (the whole
  state, for ``resume``), ``best_model.mpk`` on a new best validation
  loss; ``last_model.mpk`` at the end;
- ``Val_results.json`` and ``Train_results.json`` (per structure, with
  forces and stresses for the force field), the test pass at batch 1 with
  ``Test_results.json``, the MAE or ROC AUC, and
  ``prediction_results_{test,train}_set.csv``;
- early stopping on the validation loss (``n_early_stopping``); on
  resume the best loss and the patience come back from the history;
- ``learning_curve.png`` (:mod:`~alignn_tpu_torch.train.plots`) once the
  epochs are done, where matplotlib is installed.

Data-parallel training (:func:`~alignn_tpu_torch.parallel.dp.
train_model_dp`) runs this loop on every rank with JAX's two hooks:
``train_step_factory`` makes the data-parallel step and
``model_axis_name`` is the process group the BatchNorm statistics reduce
over.  The train loader yields each rank its own shard; the other loaders
are unsharded.  Rank 0 (shard 0) alone validates, writes the artifacts and
runs the result and test passes; it tells the other ranks when early
stopping ends the run.  The train-set prediction dump is skipped under
shards, as in JAX.

The ``.mpk`` weight files are the JAX package's layout, so alignn_tpu
loads them.  The learning rate of each epoch is ``epoch_lr``'s, written
into the optimizer on the host.  Every train and eval step (the epochs,
validation, the result and test passes) is a compiled step
(``train/state.py``): a CUDA graph per bucket on the card.  Each step's
losses come to the host in one copy, and the result passes copy each
batch's outputs in one.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from alignn_tpu_torch.chem.atoms import dumpjson
from alignn_tpu_torch.config import TrainingConfig
from alignn_tpu_torch.data.loader import BucketedLoader
from alignn_tpu_torch.nn.convert import flax_from_module, state_dict_from_flax
from alignn_tpu_torch.nn.ealignn import eALIGNNAtomWise
from alignn_tpu_torch.nn.models import (ALIGNN, ALIGNNAtomWise,
                                        init_parameters)
from alignn_tpu_torch.train.checkpoint import (check_feature_table,
                                               checkpoint_meta,
                                               load_params_with_meta,
                                               load_train_state, save_params,
                                               save_train_state)
from alignn_tpu_torch.train.optim import build_optimizer, epoch_lr
from alignn_tpu_torch.train.state import (create_train_state, make_eval_step,
                                          make_train_step)

LOSS_KEYS = ("loss", "loss1", "loss2", "loss3", "loss4", "loss5")


# TrainingConfig.dtype -> the model's compute dtype, as JAX maps it (a
# float64 run computes in f32); None is f32, the parameters' own dtype,
# which is what JAX's float32 computes for f32 inputs, and which leaves a
# model converted to float64 (a CPU reference) in float64.  An unknown
# name raises KeyError, as in JAX.
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16,
                  "float16": torch.float16, "float64": None}


def build_model(model_cfg, dtype: Optional[torch.dtype] = None,
                group=None) -> torch.nn.Module:
    """The model of a config union member, with compute dtype `dtype`
    (None: f32, the serving models) and the process group its BatchNorm
    statistics reduce over (JAX's ``axis_name``; None: none)."""
    name = getattr(model_cfg, "name", "alignn_atomwise")
    if name == "alignn":
        return ALIGNN(model_cfg, dtype=dtype, group=group)
    if name == "alignn_atomwise":
        return ALIGNNAtomWise(model_cfg, dtype=dtype, group=group)
    if name == "ealignn_atomwise":
        return eALIGNNAtomWise(model_cfg, dtype=dtype, group=group)
    raise ValueError(f"unknown model name: {name}")


def to_host(**tensors: torch.Tensor) -> Dict[str, np.ndarray]:
    """Copy several tensors to the host in one transfer: flattened into
    one f64 vector (exact for f32 values and for indices below 2^53),
    split and reshaped there."""
    names = list(tensors)
    flat = torch.cat([tensors[n].detach().reshape(-1).to(torch.float64)
                      for n in names]).cpu().numpy()
    out, off = {}, 0
    for n in names:
        t = tensors[n]
        out[n] = flat[off:off + t.numel()].reshape(tuple(t.shape))
        off += t.numel()
    return out


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Area under the ROC curve by the rank formula (Mann-Whitney U, ties
    at half weight): the value ``sklearn.metrics.roc_auc_score`` gives."""
    labels = np.asarray(labels) > 0.5
    scores = np.asarray(scores, dtype=np.float64)
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores))
    sorted_scores = scores[order]
    i = 0
    while i < len(scores):   # average rank over each run of ties
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == \
                sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    n_pos, n_neg = int(labels.sum()), int((~labels).sum())
    if n_pos == 0 or n_neg == 0:
        raise ValueError("ROC AUC needs both classes among the targets")
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def _restore_history(output_dir: str, start_epoch: int):
    """The interrupted run's history rows up to `start_epoch`."""
    hists = {}
    for name in ("history_train.json", "history_val.json"):
        path = os.path.join(output_dir, name)
        rows: List = []
        if os.path.exists(path):
            try:
                with open(path) as f:
                    rows = json.load(f)[:start_epoch]
            except (json.JSONDecodeError, OSError):
                rows = []   # a kill mid-dump: start the record afresh
        hists[name] = rows
    return hists["history_train.json"], hists["history_val.json"]


def _best_and_patience(history_val: List) -> tuple:
    """(best loss, epochs since it) from the validation history; all-zero
    rows (epochs run without a validation set) do not count."""
    losses = [row[0] for row in history_val
              if isinstance(row, (list, tuple)) and row
              and any(v != 0.0 for v in row)]
    if not losses:
        return np.inf, 0
    return float(min(losses)), len(losses) - 1 - int(np.argmin(losses))


def train_model(config: TrainingConfig, train_loader: BucketedLoader,
                val_loader: BucketedLoader,
                test_loader: Optional[BucketedLoader] = None,
                model: Optional[torch.nn.Module] = None,
                restart_state_path: Optional[str] = None,
                restart_params_path: Optional[str] = None,
                train_step_factory: Optional[Callable] = None,
                model_axis_name=None) -> Dict[str, Any]:
    """Run the training campaign on the loaders' device; returns a summary
    (best validation loss, epochs run, seconds per epoch, each step's
    loss, the test metric and the final ``state``).

    A fresh model draws its weights from ``random_seed`` through a CPU
    generator, so the card and the CPU start from the same weights (and
    every data-parallel rank from the same), and computes in
    ``config.dtype`` (:data:`COMPUTE_DTYPES`); a model passed in keeps its
    own.  The parameters, gradients, optimizer state and losses stay f32.
    `train_step_factory` ``(model, criterion, classification) -> step``
    replaces :func:`make_train_step`; `model_axis_name` is the process
    group a fresh model's BatchNorm reduces over.
    """
    t0 = time.time()
    output_dir = config.output_dir
    os.makedirs(output_dir, exist_ok=True)
    dtype = COMPUTE_DTYPES[config.dtype]   # an unknown name raises first
    sharded = train_loader.num_shards > 1
    # several ranks may hold one shard (a data x graph mesh): rank 0 writes
    ranks = _world_size()
    is_main = train_loader.shard_index == 0 and (ranks == 1 or
                                                 _rank() == 0)
    if is_main:
        config.dump(os.path.join(output_dir, "config.json"))

    classification = config.classification_threshold is not None or \
        getattr(config.model, "classification", False)
    is_atomwise = getattr(config.model, "name", "") in (
        "alignn_atomwise", "ealignn_atomwise")
    if model is None:
        model = init_parameters(
            build_model(config.model, dtype=dtype, group=model_axis_name),
            torch.Generator().manual_seed(config.random_seed or 123))
    sample = next(iter(val_loader if len(val_loader) else train_loader))
    state = create_train_state(
        model, sample, build_optimizer(config.optimizer,
                                       config.learning_rate,
                                       config.weight_decay, model=model))
    del sample

    ckpt_meta = checkpoint_meta(config.atom_features)
    sb_path = os.path.join(output_dir, "species_baseline.json")
    if os.path.exists(sb_path):
        # the per-species offsets the loader subtracted travel with the
        # weights
        with open(sb_path) as f:
            ckpt_meta["species_baseline"] = json.load(f)

    start_epoch = 0
    if restart_state_path and os.path.exists(restart_state_path):
        state, start_epoch, extra = load_train_state(
            restart_state_path, state, with_extra=True)
        check_feature_table(extra.get("meta"), config.atom_features,
                            restart_state_path)
        print(f"restored full train state from {restart_state_path} "
              f"(epoch {start_epoch})")
    elif restart_params_path and os.path.exists(restart_params_path):
        params, stats, meta = load_params_with_meta(restart_params_path)
        check_feature_table(meta, config.atom_features, restart_params_path)
        sd = model.state_dict()
        sd.update(state_dict_from_flax(params, batch_stats=stats))
        model.load_state_dict(sd)
        print(f"restored weights from {restart_params_path}")

    def save_weights(name: str):
        save_params(os.path.join(output_dir, name), *flax_from_module(model),
                    meta=ckpt_meta)

    if train_step_factory is not None:
        train_step = train_step_factory(model, config.criterion,
                                        classification)
    else:
        train_step = make_train_step(model, criterion=config.criterion,
                                     classification=classification)
    eval_step = make_eval_step(model, criterion=config.criterion,
                               classification=classification)
    spec = train_loader.spec
    edges_per_batch = (spec.n_edges + spec.n_lg_edges) if spec else 0

    history_train, history_val = _restore_history(output_dir, start_epoch) \
        if start_epoch > 0 else ([], [])
    best_loss, no_improve = _best_and_patience(history_val) \
        if len(val_loader) else (np.inf, 0)
    epoch_s: List[float] = []
    step_losses: List[List[float]] = []
    for epoch in range(start_epoch, config.epochs):
        train_loader.set_epoch(epoch)
        lr = epoch_lr(config.scheduler, config.learning_rate, config.epochs,
                      epoch, steps_per_epoch=max(len(train_loader), 1))
        state.set_lr(lr)

        ep_start = time.time()
        train_acc = []
        for batch in train_loader:
            state, losses = train_step(state, batch)
            train_acc.append(_losses_to_host(losses))
        ep_time = time.time() - ep_start
        epoch_s.append(ep_time)
        step_losses.append([m["loss"] for m in train_acc])
        edges_s = edges_per_batch * len(train_acc) / max(ep_time, 1e-9)

        if not is_main:   # rank 0 validates and writes
            if config.n_early_stopping is not None and \
                    _from_rank0(False, model_axis_name, model):
                break
            continue
        val_acc = [_losses_to_host(eval_step(state, batch)[0])
                   for batch in val_loader]
        train_metrics, val_metrics = _mean(train_acc), _mean(val_acc)
        history_train.append([train_metrics.get(k, 0.0) for k in LOSS_KEYS])
        history_val.append([val_metrics.get(k, 0.0) for k in LOSS_KEYS])
        dumpjson(history_train, os.path.join(output_dir,
                                             "history_train.json"))
        dumpjson(history_val, os.path.join(output_dir, "history_val.json"))
        if config.progress:
            print(f"epoch {epoch + 1}/{config.epochs} lr {lr:.3e} "
                  f"train {train_metrics.get('loss', 0.0):.6f} "
                  f"val {val_metrics.get('loss', 0.0):.6f} "
                  f"time {ep_time:.2f}s edges/s {edges_s:.3e}", flush=True)

        if config.write_checkpoint:
            save_weights("current_model.mpk")
            save_train_state(os.path.join(output_dir, "restart.mpk"), state,
                             epoch + 1, extra={"meta": ckpt_meta})
        # no validation set: neither the best nor the patience moves
        if "loss" in val_metrics:
            if val_metrics["loss"] < best_loss:
                best_loss, no_improve = val_metrics["loss"], 0
                if config.write_checkpoint:
                    save_weights("best_model.mpk")
            else:
                no_improve += 1
        if config.n_early_stopping is not None:
            stop = no_improve >= config.n_early_stopping
            if ranks > 1:
                _from_rank0(stop, model_axis_name, model)
            if stop:
                print(f"early stopping at epoch {epoch + 1}")
                break

    summary: Dict[str, Any] = {
        "best_val_loss": float(best_loss), "epochs_run": len(epoch_s),
        "epoch_s": epoch_s, "steps_per_epoch": len(train_loader),
        "step_losses": step_losses, "edges_per_batch": edges_per_batch}
    if not is_main:
        summary["train_time_s"] = time.time() - t0
        summary["state"] = state
        return summary
    results = _Results(config, is_atomwise, eval_step, state)
    if config.store_outputs and len(val_loader):
        dumpjson(results.per_sample(val_loader),
                 os.path.join(output_dir, "Val_results.json"))
    if config.store_outputs and len(train_loader):
        # in a fixed order, with the partial batch
        dump_loader = BucketedLoader(
            train_loader.dataset, train_loader.batch_size, shuffle=False,
            drop_last=False, spec=spec,
            atom_features=train_loader.atom_features,
            target_width=train_loader.target_width,
            atomwise_width=train_loader.atomwise_width,
            additional_width=train_loader.additional_width,
            extra_width=train_loader.extra_width,
            device=train_loader.device)
        dumpjson(results.per_sample(dump_loader),
                 os.path.join(output_dir, "Train_results.json"))
    try:
        from alignn_tpu_torch.train.plots import plot_learning_curve

        plot_learning_curve(output_dir, key="loss", plot_train=True)
    except Exception as exc:  # no matplotlib must not fail a training run
        print("learning-curve plot skipped:", exc)
    if test_loader is not None and len(test_loader):
        summary.update(_test_pass(config, classification, results,
                                  test_loader))
    if config.write_predictions and len(train_loader) and \
            not classification and not sharded:
        _train_predictions(output_dir, eval_step, state, train_loader)
    if config.write_checkpoint:
        save_weights("last_model.mpk")
    summary["train_time_s"] = time.time() - t0
    summary["state"] = state
    return summary


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _from_rank0(flag: bool, group, model: torch.nn.Module) -> bool:
    """Rank 0's `flag` on every rank of `group` (the default group for
    None): whether early stopping ends the run."""
    import torch.distributed as dist

    t = torch.tensor([float(flag)], device=next(model.parameters()).device)
    dist.broadcast(t, 0, group=group)
    return bool(t.item())


def _losses_to_host(losses: Dict[str, torch.Tensor]) -> Dict[str, float]:
    host = to_host(all=torch.stack(list(losses.values())))["all"]
    return {k: float(v) for k, v in zip(losses, host)}


def _mean(acc: List[Dict[str, float]]) -> Dict[str, float]:
    if not acc:
        return {}
    return {k: float(np.mean([m[k] for m in acc])) for k in acc[0]}


class _Results:
    """Per-structure predictions over a loader (one host copy a batch)."""

    def __init__(self, config, is_atomwise: bool, eval_step, state):
        self.eval_step, self.state = eval_step, state
        self.is_atomwise = is_atomwise
        m = config.model
        self.want_grad = is_atomwise and m.calculate_gradient
        self.want_stress = is_atomwise and m.stresswise_weight != 0

    def batch_rows(self, batch, ids) -> List[Dict[str, Any]]:
        _losses, res = self.eval_step(self.state, batch)
        t = dict(out=res["out"], gm=batch.graph_mask, tg=batch.target)
        if self.is_atomwise:
            t.update(nm=batch.node_mask, ng=batch.node_graph)
        if self.want_grad:
            t.update(grad=res["grad"], tgrad=batch.forces)
        if self.want_stress:
            t.update(stress=res["stresses"], tstress=batch.stress)
        h = to_host(**t)
        rows = []
        for gi in range(h["out"].shape[0]):
            if h["gm"][gi] < 0.5 or gi >= len(ids):
                continue
            info = {"id": ids[gi],
                    "target": np.atleast_1d(h["tg"][gi]).tolist(),
                    "predictions": np.atleast_1d(h["out"][gi]).tolist()}
            if self.is_atomwise:
                sel = (h["nm"] > 0.5) & (h["ng"] == gi)
                if self.want_grad:
                    info["target_grad"] = h["tgrad"][sel].tolist()
                    info["pred_grad"] = h["grad"][sel].tolist()
                if self.want_stress:
                    info["target_stress"] = h["tstress"][gi].tolist()
                    info["pred_stress"] = h["stress"][gi].tolist()
            rows.append(info)
        return rows

    def per_sample(self, loader: BucketedLoader) -> List[Dict[str, Any]]:
        ids = loader.batch_ids()
        rows = []
        for bi, batch in enumerate(loader):
            rows.extend(self.batch_rows(batch, ids[bi]))
        return rows


def _test_pass(config, classification: bool, results: _Results,
               test_loader: BucketedLoader) -> Dict[str, Any]:
    """Batch-1 predictions over the test set: ``Test_results.json``, the
    MAE (in the unscaled target's units) or ROC AUC, and
    ``prediction_results_test_set.csv``."""
    rows = results.per_sample(test_loader)
    dumpjson(rows, os.path.join(config.output_dir, "Test_results.json"))
    out: Dict[str, Any] = {}
    if not rows:
        return out
    p = np.stack([np.asarray(r["predictions"]) for r in rows])
    t = np.stack([np.asarray(r["target"]) for r in rows])
    if classification:
        prob = np.exp(p[:, 1]) if p.shape[1] > 1 else p[:, 0]
        out["test_rocauc"] = roc_auc(t[:, 0], prob)
        print("Test ROC AUC:", out["test_rocauc"])
    else:
        sf = getattr(test_loader.dataset, "target_std", 1.0) or 1.0
        out["test_mae"] = float(np.mean(np.abs(p[:, :t.shape[1]] - t))) * sf
        print("Test MAE:", out["test_mae"])
    if config.write_predictions:
        with open(os.path.join(config.output_dir,
                               "prediction_results_test_set.csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow(["id", "target", "prediction"])
            for r in rows:
                w.writerow([r["id"], *(v[0] if len(v) == 1 else v for v in
                                       (r["target"], r["predictions"]))])
    return out


def _train_predictions(output_dir: str, eval_step, state,
                       train_loader: BucketedLoader):
    """``prediction_results_train_set.csv`` over the epoch-0 order (whole
    batches, as the JAX trainer writes it)."""
    train_loader.set_epoch(0)
    ids = train_loader.batch_ids()
    rows = []
    for bi, batch in enumerate(train_loader):
        _losses, res = eval_step(state, batch)
        h = to_host(out=res["out"], gm=batch.graph_mask, tg=batch.target)
        for gi in range(h["out"].shape[0]):
            if h["gm"][gi] < 0.5 or gi >= len(ids[bi]):
                continue
            rows.append([ids[bi][gi], float(np.atleast_1d(h["tg"][gi])[0]),
                         float(np.atleast_1d(h["out"][gi])[0])])
    if rows:
        with open(os.path.join(output_dir,
                               "prediction_results_train_set.csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow(["id", "target", "prediction"])
            w.writerows(rows)
