"""Training and force-field plots (matplotlib, written to files).

Counterpart of ``alignn_tpu/train/plots.py``: :func:`plot_learning_curve`
(the reference's ``alignn/utils.py:24-47``), which the trainer calls once
a run ends, and :func:`plot_ff_training` (``alignn/ff/ff.py:620-759``:
loss-history curves and energy/force parity scatters).  Every figure is
saved through the Agg backend, so no display is needed.  matplotlib is
imported when a plot is drawn, not with the module: a host without it
can import the trainer, which then skips the plot.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _history_column(history, key: str):
    """Both history formats: list-of-rows (this trainer's and the
    reference FF trainer's) and dict-of-lists (the older reference
    property trainer's)."""
    if isinstance(history, dict):
        return history.get(key, history.get("loss", []))
    cols = {"loss": 0, "mae": 0, "loss1": 1, "loss2": 2, "loss3": 3,
            "loss4": 4, "loss5": 5, "energy": 1, "forces": 2}
    idx = cols.get(key, 0)
    return [row[idx] if isinstance(row, (list, tuple)) and len(row) > idx
            else (row if np.isscalar(row) else 0.0) for row in history]


def plot_learning_curve(results_dir: str, key: str = "loss",
                        plot_train: bool = False,
                        save: Optional[str] = "learning_curve.png"):
    """Validation (and optionally training) loss curves against the
    epoch, saved as `save` in `results_dir`; returns the (train, val)
    histories read from its ``history_{train,val}.json``."""
    plt = _pyplot()
    with open(os.path.join(results_dir, "history_val.json")) as f:
        val = json.load(f)
    p = plt.plot(_history_column(val, key), label=os.path.basename(
        os.path.abspath(results_dir)))
    train = None
    if plot_train:
        with open(os.path.join(results_dir, "history_train.json")) as f:
            train = json.load(f)
        plt.plot(_history_column(train, key), alpha=0.5,
                 c=p[0].get_color())
    plt.xlabel("epochs")
    plt.ylabel(key)
    if save:
        plt.savefig(os.path.join(results_dir, save), dpi=120,
                    bbox_inches="tight")
        plt.close()
    return train, val


def _parity_panel(ax, results, target_key, pred_key, title, unit):
    xx, yy = [], []
    for rec in results:
        t = np.asarray(rec.get(target_key, []), dtype=np.float64).ravel()
        p = np.asarray(rec.get(pred_key, []), dtype=np.float64).ravel()
        n = min(t.size, p.size)
        xx.extend(t[:n].tolist())
        yy.extend(p[:n].tolist())
    xx, yy = np.asarray(xx), np.asarray(yy)
    ax.set_title(title)
    if xx.size:
        ax.plot(xx, yy, ".", ms=3)
        lo, hi = min(xx.min(), yy.min()), max(xx.max(), yy.max())
        ax.plot([lo, hi], [lo, hi], "k--", lw=0.8)
        mae = float(np.mean(np.abs(xx - yy)))
        ax.text(0.04, 0.92, f"MAE {mae:.4f} {unit}",
                transform=ax.transAxes, fontsize=9)
    ax.set_xlabel(f"target ({unit})")
    ax.set_ylabel(f"predicted ({unit})")
    return xx, yy


def plot_ff_training(out_dir: str, results: str = "Val_results.json",
                     save_prefix: str = ""):
    """Energy (a) and force (b) loss histories -> ``history.png``; parity
    scatters from the per-structure results json -> ``parity.png``."""
    plt = _pyplot()
    hist_path = os.path.join(out_dir, "history_val.json")
    if os.path.exists(hist_path):
        with open(hist_path) as f:
            hist = json.load(f)
        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        axes[0].plot(_history_column(hist, "loss1"))
        axes[0].set_title("(a) Energy")
        axes[0].set_xlabel("Epochs")
        axes[0].set_ylabel("eV")
        axes[1].plot(_history_column(hist, "loss2"))
        axes[1].set_title("(b) Forces")
        axes[1].set_xlabel("Epochs")
        axes[1].set_ylabel("eV/A")
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, save_prefix + "history.png"),
                    dpi=120)
        plt.close(fig)

    res_path = os.path.join(out_dir, results)
    if os.path.exists(res_path):
        with open(res_path) as f:
            data = json.load(f)
        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        _parity_panel(axes[0], data, "target", "predictions",
                      "Energy", "eV")
        _parity_panel(axes[1], data, "target_grad", "pred_grad",
                      "Forces", "eV/A")
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, save_prefix + "parity.png"),
                    dpi=120)
        plt.close(fig)
