"""Generate and optionally run per-property training campaigns
(counterpart of ``alignn_tpu/scripts/train_all.py``).

One training job per (dataset, target) over the headline property lists
of the reference's ``train_all_*`` family, emitted as shell scripts that
call :func:`alignn_tpu_torch.data.figshare.train_prop_model` (or run
inline with ``--run``).
"""

from __future__ import annotations

import argparse
import json
import os
import stat
import sys

# the headline JARVIS-DFT targets of the reference's README tables
JV_3D_TARGETS = [
    "formation_energy_peratom", "optb88vdw_bandgap",
    "optb88vdw_total_energy", "ehull", "mbj_bandgap", "bulk_modulus_kv",
    "shear_modulus_gv", "magmom_oszicar", "slme", "spillage",
    "kpoint_length_unit", "encut", "epsx", "epsy", "epsz", "mepsx",
    "mepsy", "mepsz", "dfpt_piezo_max_dielectric", "dfpt_piezo_max_dij",
    "dfpt_piezo_max_eij", "exfoliation_energy", "max_efg",
    "avg_elec_mass", "avg_hole_mass", "n-Seebeck", "p-Seebeck",
    "n-powerfact", "p-powerfact",
]
MEGNET_TARGETS = ["e_form", "gap pbe"]
QM9_TARGETS = ["HOMO", "LUMO", "U0", "U", "H", "G", "ZPVE", "Cv"]

DATASET_TARGETS = {
    "dft_3d": JV_3D_TARGETS,
    "dft_2d": ["formation_energy_peratom", "optb88vdw_bandgap",
               "exfoliation_energy"],
    "megnet": MEGNET_TARGETS,
    "qm9_std_jctc": QM9_TARGETS,
    # electron/phonon DOS campaigns (reference scripts/train_edos_pdos.py)
    "edos_pdos": ["edos_up", "pdos_elast"],
}


def main(argv=None):
    p = argparse.ArgumentParser(description="campaign generator")
    p.add_argument("--dataset", default="dft_3d",
                   choices=sorted(DATASET_TARGETS))
    p.add_argument("--targets", default=None,
                   help="comma-separated override of the target list")
    p.add_argument("--output_root", default="campaign")
    p.add_argument("--epochs", default=300, type=int)
    p.add_argument("--batch_size", default=64, type=int)
    p.add_argument("--run", action="store_true",
                   help="run jobs inline instead of writing scripts")
    p.add_argument("--device", default=None,
                   help="torch device of the jobs (default cuda)")
    args = p.parse_args(argv)

    targets = (args.targets.split(",") if args.targets
               else DATASET_TARGETS[args.dataset])
    device = f", device='{args.device}'" if args.device else ""
    os.makedirs(args.output_root, exist_ok=True)
    jobs = []
    for target in targets:
        safe = target.replace(" ", "_").replace("-", "m")
        out_dir = os.path.join(args.output_root,
                               f"{args.dataset}_{safe}")
        os.makedirs(out_dir, exist_ok=True)
        job = {
            "dataset": args.dataset, "prop": target,
            "epochs": args.epochs, "batch_size": args.batch_size,
            "output_dir": out_dir,
        }
        with open(os.path.join(out_dir, "job.json"), "w") as f:
            json.dump(job, f, indent=2)
        script = os.path.join(out_dir, "run.sh")
        with open(script, "w") as f:
            f.write(
                "#!/bin/bash\n"
                f"{sys.executable} -c \""
                "from alignn_tpu_torch.data.figshare import "
                "train_prop_model; "
                f"train_prop_model(dataset='{args.dataset}', "
                f"prop='{target}', epochs={args.epochs}, "
                f"batch_size={args.batch_size}, "
                f"output_dir='{out_dir}'{device})\"\n")
        os.chmod(script, os.stat(script).st_mode | stat.S_IEXEC)
        jobs.append(job)
        if args.run:
            from alignn_tpu_torch.data.figshare import train_prop_model

            train_prop_model(dataset=args.dataset, prop=target,
                             epochs=args.epochs,
                             batch_size=args.batch_size,
                             output_dir=out_dir, device=args.device)
    print(f"generated {len(jobs)} jobs under {args.output_root}")


if __name__ == "__main__":
    main()
