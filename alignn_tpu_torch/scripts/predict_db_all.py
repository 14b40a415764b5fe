#!/usr/bin/env python
"""Zoo-model predictions across all cached databases (form/gap props)
(counterpart of ``alignn_tpu/scripts/predict_db_all.py``).

Iterates the (dataset -> properties) registry, and for every
formation-energy-like or band-gap-like property runs the corresponding
model over the whole database, writing ``{dataset}_{prop}predictions.csv``
rows of ``id,target,prediction,difference`` and printing an MAE per pair.
The models default to the zoo names, which need a download (not ported);
pass local training output directories instead.
"""

import argparse
import json
import os

# dataset -> (id_tag, [properties]): the reference's dataset_props.json
DATASET_PROPS = {
    "oqmd_3d_no_cfid": ("id", ["_oqmd_band_gap", "_oqmd_delta_e"]),
    "mp_3d_2020": ("id", ["formation_energy_per_atom", "band_gap"]),
    "megnet": ("id", ["e_form", "gap pbe"]),
    "dft_2d": ("jid", ["formation_energy_peratom", "optb88vdw_bandgap"]),
    "qe_tb": ("jid", ["indir_gap"]),
}

_GAP_MARKERS = ("gap",)
_FORM_MARKERS = ("form", "f_enp", "_oqmd_delta_e")


def _pick_kind(prop: str):
    if "mbj" in prop:
        return None  # the reference skips mbj gaps (different physics)
    if any(m in prop for m in _GAP_MARKERS):
        return "gap"
    if any(m in prop for m in _FORM_MARKERS) or prop in _FORM_MARKERS:
        return "form"
    return None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--gap_model", default="jv_optb88vdw_bandgap_alignn",
                   help="zoo name or local model dir for gap props")
    p.add_argument("--form_model",
                   default="jv_formation_energy_peratom_alignn",
                   help="zoo name or local model dir for formation props")
    p.add_argument("--datasets", default=None,
                   help="comma list; default: all registered")
    p.add_argument("--limit", type=int, default=None,
                   help="cap structures per dataset (smoke runs)")
    p.add_argument("--output_dir", default=".")
    p.add_argument("--device", default=None,
                   help="torch device of the models (default cuda)")
    args = p.parse_args(argv)

    import numpy as np

    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.data.figshare import load_dataset
    from alignn_tpu_torch.zoo import (get_figshare_model,
                                      graph_kwargs_from_config,
                                      load_model_dir, predict_structures)

    def _load(name_or_dir):
        if os.path.isdir(name_or_dir):
            return load_model_dir(name_or_dir, args.device)
        return get_figshare_model(name_or_dir)

    models = {}
    rows = []
    datasets = (args.datasets.split(",") if args.datasets
                else list(DATASET_PROPS))
    for ds in datasets:
        id_tag, props = DATASET_PROPS[ds]
        # one load a dataset, not a property: large json payloads
        try:
            records = load_dataset(ds)
        except Exception as exp:  # noqa: BLE001 - per database, as JAX
            print(ds, "load failed:", exp)
            continue
        for prop in props:
            kind = _pick_kind(prop)
            if kind is None:
                continue
            if kind not in models:
                models[kind] = _load(
                    args.gap_model if kind == "gap" else args.form_model)
            model, cfg = models[kind]

            ids, structs, targets = [], [], []
            for r in records:
                t = r.get(prop, "na")
                if t in ("na", None, ""):
                    continue
                ids.append(r.get(id_tag, r.get("id", len(ids))))
                structs.append(Atoms.from_dict(r["atoms"]))
                targets.append(float(t))
                if args.limit and len(ids) >= args.limit:
                    break
            if not ids:
                print(ds, prop, "no labeled records")
                continue
            # the featurisation must match the checkpoint's training
            # config (feature table, cutoff, neighbours)
            preds = predict_structures(
                model, structs, **graph_kwargs_from_config(cfg))[:, 0]
            targets = np.asarray(targets)
            fname = os.path.join(args.output_dir,
                                 f"{ds}_{prop}predictions.csv")
            with open(fname, "w") as f:
                f.write("id,target,prediction,difference\n")
                for i, t, pr in zip(ids, targets, preds):
                    f.write("%s, %6f, %6f, %6f\n" % (i, t, pr,
                                                     abs(t - pr)))
            mae = float(np.abs(targets - preds).mean())
            row = {"dataset": ds, "prop": prop, "n": len(ids), "mae": mae,
                   "csv": fname}
            rows.append(row)
            print(json.dumps(row))
    return rows


if __name__ == "__main__":
    main()
