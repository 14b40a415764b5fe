#!/usr/bin/env python
"""Train ALIGNN-FF on the mlearn element datasets (counterpart of
``alignn_tpu/scripts/train_mlearn.py``).

The reference ships the mlearn force-field benchmark data (Si/Ni/Cu/Ge/
Li/Mo and the combined ``all/``) with per-element TrainingConfigs under
``examples/sample_data_ff/mlearn_data/``.  This script runs those configs
through ``cli.train`` and collects per-element energy and force MAEs
into one json:

    python -m alignn_tpu_torch.scripts.train_mlearn --elements Si,Cu \
        --output_dir mlearn_out [--override epochs=5 hidden_features=64]

The data root is ``--data_root``; its default, :data:`MLEARN_ROOT`, is the
reference checkout's mlearn folder under ``$ALIGNN_REFERENCE_ROOT``
(``reference`` in the working directory when unset).
"""

import argparse
import json
import os

MLEARN_ROOT = os.path.join(os.environ.get("ALIGNN_REFERENCE_ROOT",
                                          "reference"),
                           "alignn", "examples", "sample_data_ff",
                           "mlearn_data")
ELEMENTS = ["Si", "Ni", "Cu", "Ge", "Li", "Mo", "all"]


def prepare_all(output_dir: str, data_root: str = MLEARN_ROOT) -> str:
    """Synthesize the combined ``all`` dataset folder.

    The reference's ``all/prepare_mlearn.py`` downloads the same six
    per-element mlearn payloads that are bundled per element and
    concatenates them (its config_example.json splits 1402/164/164 = 1730
    rows, the sum of the six sets), so this concatenates the bundled
    id_prop.json files with element-prefixed jids ("Si-1" style, as the
    reference)."""
    dst = os.path.join(output_dir, "all_data")
    os.makedirs(dst, exist_ok=True)
    rows = []
    for el in ELEMENTS[:-1]:
        with open(os.path.join(data_root, el, "id_prop.json")) as f:
            for r in json.load(f):
                r = dict(r)
                r["jid"] = f"{el}-{r['jid']}"
                rows.append(r)
    with open(os.path.join(dst, "id_prop.json"), "w") as f:
        json.dump(rows, f)
    with open(os.path.join(data_root, "all", "config_example.json")) as f:
        cfg = json.load(f)
    cfg["output_dir"] = "./"
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(cfg, f)
    return dst


def route_overrides(cfg: dict, overrides: dict) -> dict:
    """`cfg` with each override placed on the model dict when the model
    config's dataclass has that field (or the json's model dict has the
    key), else at the top level: a new model field lands on the model
    instead of tripping TrainingConfig's strict top-level keys."""
    import dataclasses

    from alignn_tpu_torch.config import model_config_from_dict

    model_fields = {f.name for f in dataclasses.fields(
        type(model_config_from_dict(cfg.get("model", {}))))}
    for k, v in overrides.items():
        if k in cfg.get("model", {}) or k in model_fields:
            cfg.setdefault("model", {})[k] = v
        else:
            cfg[k] = v
    return cfg


def harvest(out: str) -> dict:
    """Test energy and force MAEs from ``out/Test_results.json``, each
    pooled over all structures' components before the one mean (the
    reference's MAE over concatenated arrays; a mean of per-structure
    means would weight an 8-atom and a 108-atom cell alike)."""
    import numpy as np

    metrics = {}
    res_path = os.path.join(out, "Test_results.json")
    if not os.path.exists(res_path):
        return metrics
    with open(res_path) as f:
        rows = json.load(f)
    e_err, f_err = [], []
    for r in rows:
        t, p = np.asarray(r["target"]), np.asarray(r["predictions"])
        e_err.append(np.abs(t - p).ravel())
        if r.get("target_grad") is not None and \
                r.get("pred_grad") is not None:
            f_err.append(np.abs(np.asarray(r["target_grad"])
                                - np.asarray(r["pred_grad"])).ravel())
    if e_err:
        metrics["test_energy_mae"] = float(np.mean(np.concatenate(e_err)))
    if f_err:
        metrics["test_force_mae"] = float(np.mean(np.concatenate(f_err)))
    return metrics


def train_one(element: str, output_dir: str, data_root: str = MLEARN_ROOT,
              overrides=None, resume=None, device=None):
    from alignn_tpu_torch.cli.train import main as train_main

    if element == "all":
        src = prepare_all(output_dir, data_root)
    else:
        src = os.path.join(data_root, element)
    cfg_path = os.path.join(src, "config.json")
    if overrides:
        with open(cfg_path) as f:
            cfg = route_overrides(json.load(f), overrides)
        os.makedirs(output_dir, exist_ok=True)
        cfg_path = os.path.join(output_dir, f"config_{element}.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
    out = os.path.join(output_dir, element)
    args = ["--root_dir", src, "--config_name", cfg_path,
            "--output_dir", out, "--target_key", "total_energy"]
    if resume:
        # epoch-granular restart: a killed run relaunched with
        # --resume auto continues where it stopped
        args += ["--resume", resume]
    if device:
        args += ["--device", device]
    train_main(args)
    return {"element": element, "output_dir": out, **harvest(out)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--elements", default="Si",
                   help=f"comma list from {ELEMENTS}")
    p.add_argument("--data_root", default=MLEARN_ROOT)
    p.add_argument("--output_dir", default="mlearn_out")
    p.add_argument("--override", nargs="*", default=[],
                   help="key=value config overrides (ints/floats "
                        "auto-cast), e.g. epochs=5 hidden_features=64")
    p.add_argument("--resume", default=None,
                   help='"auto" resumes each element from its '
                        "<output_dir>/<el>/restart.mpk when present")
    p.add_argument("--device", default=None,
                   help="torch device to train on (default cuda)")
    args = p.parse_args(argv)

    overrides = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v

    results = []
    for el in args.elements.split(","):
        m = train_one(el, args.output_dir, args.data_root,
                      overrides or None, resume=args.resume,
                      device=args.device)
        results.append(m)
        print(json.dumps(m))
    summary = os.path.join(args.output_dir, "mlearn_summary.json")
    with open(summary, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({"summary": summary, "n": len(results)}))
    return results


if __name__ == "__main__":
    main()
