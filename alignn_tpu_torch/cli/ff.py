"""FF task CLI (reference `alignn/run_alignn_ff.py` argparse dispatch).

    python -m alignn_tpu_torch.cli.ff --model_path DIR --file_path POSCAR \
        --task optimize [--device cpu]

Counterpart of ``alignn_tpu/cli/ff.py`` with the same arguments and
tasks, plus ``--device`` (default ``cuda``).

Tasks: unrelaxed_energy | optimize | nve | nvt_langevin | nvt_andersen |
nvt_berendsen | npt_berendsen | npt_nose_hoover | ev_curve | vacancy |
surface | phonons | phonons3 (reference run_alignn_ff.py:100-257).
"""

from __future__ import annotations

import argparse
import json
import sys

from alignn_tpu_torch.chem.atoms import Atoms
from alignn_tpu_torch.ff.forcefield import ForceField


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="alignn_tpu_torch force-field tasks")
    p.add_argument("--model_path", required=True,
                   help="trained atomwise model directory")
    p.add_argument("--file_path", default="POSCAR",
                   help="structure file (POSCAR/.cif/.xyz/.pdb)")
    p.add_argument("--task", default="unrelaxed_energy",
                   choices=["unrelaxed_energy", "optimize", "nve",
                            "nvt_langevin", "nvt_andersen",
                            "nvt_berendsen", "npt_berendsen",
                            "npt_nose_hoover", "ev_curve", "vacancy",
                            "nvt_nose_hoover",
                            "surface", "interface", "phonons",
                            "phonons3"])
    p.add_argument("--substrate_path", default=None,
                   help="substrate structure for --task interface")
    p.add_argument("--temperature_K", default=300.0, type=float)
    p.add_argument("--pressure_GPa", default=0.0, type=float)
    p.add_argument("--timestep_fs", default=1.0, type=float)
    p.add_argument("--md_steps", default=100, type=int)
    p.add_argument("--opt_steps", default=200, type=int)
    p.add_argument("--fmax", default=0.05, type=float)
    p.add_argument("--optimize_lattice", action="store_true", default=True)
    p.add_argument("--no_optimize_lattice", dest="optimize_lattice",
                   action="store_false")
    p.add_argument("--on_device_md", action="store_true",
                   help="run nve/nvt_langevin as on-device chunks, "
                        "each step a replayed CUDA graph on the card "
                        "(fast path for long trajectories)")
    p.add_argument("--chunk_steps", default=50, type=int)
    p.add_argument("--supercell", default="2,2,2")
    p.add_argument("--miller", default="1,1,1")
    p.add_argument("--output_dir", default=".")
    p.add_argument("--stress_wt", default=1.0, type=float)
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (cuda or cpu)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    atoms = Atoms.from_file(args.file_path)
    ff = ForceField(atoms, model_path=args.model_path,
                    dirname=args.output_dir, stress_wt=args.stress_wt,
                    device=args.device)
    task = args.task
    if task == "unrelaxed_energy":
        e = ff.unrelaxed_atoms()
        print(json.dumps({"energy": e}))
    elif task == "optimize":
        a, e = ff.optimize_atoms(fmax=args.fmax, steps=args.opt_steps,
                                 optimize_lattice=args.optimize_lattice)
        print(json.dumps({"energy": e, "atoms": a.to_dict()}))
    elif task in ("nve", "nvt_langevin", "nvt_andersen", "nvt_berendsen",
                  "nvt_nose_hoover",
                  "npt_berendsen", "npt_nose_hoover"):
        if args.on_device_md and task in ("nve", "nvt_langevin"):
            kw = dict(steps=args.md_steps, timestep_fs=args.timestep_fs,
                      chunk_steps=args.chunk_steps)
            if task == "nve":
                kw["initial_temperature_K"] = args.temperature_K
            else:
                kw["temperature_K"] = args.temperature_K
            _a, log = ff.run_md_on_device(ensemble=task, **kw)
            print(json.dumps(log.rows[-1]))
            return
        method = {"nve": ff.run_nve_velocity_verlet}.get(
            task, getattr(ff, f"run_{task}", None))
        kw = dict(steps=args.md_steps, timestep_fs=args.timestep_fs)
        if task != "nve":
            kw["temperature_K"] = args.temperature_K
        else:
            kw["initial_temperature_K"] = args.temperature_K
        if task.startswith("npt"):
            kw["pressure_GPa"] = args.pressure_GPa
        _a, log = method(**kw)
        print(json.dumps(log.rows[-1]))
    elif task == "ev_curve":
        out = ff.ev_curve(steps=args.opt_steps, fmax=args.fmax)
        print(json.dumps(out["eos"]))
    elif task == "vacancy":
        sc = tuple(int(x) for x in args.supercell.split(","))
        out = ff.vacancy_formation(supercell=sc, fmax=args.fmax,
                                   steps=args.opt_steps)
        print(json.dumps(out))
    elif task == "surface":
        miller = tuple(int(x) for x in args.miller.split(","))
        out = ff.surface_energy(miller=miller, fmax=args.fmax,
                                steps=args.opt_steps)
        print(json.dumps({k: v for k, v in out.items()
                          if k != "interface"}))
    elif task == "interface":
        if not args.substrate_path:
            raise SystemExit("--task interface requires --substrate_path")
        substrate = Atoms.from_file(args.substrate_path)
        out = ff.interface_energy(substrate, fmax=args.fmax,
                                  steps=args.opt_steps)
        print(json.dumps({k: v for k, v in out.items()
                          if k != "interface"}))
    elif task == "phonons":
        sc = tuple(int(x) for x in args.supercell.split(","))
        out = ff.phonons(supercell=sc)
        freqs = out["frequencies_THz"][0]
        print(json.dumps({"gamma_THz": freqs}))
    elif task == "phonons3":
        sc = tuple(int(x) for x in args.supercell.split(","))
        out = ff.phonons3(supercell=sc)
        print(json.dumps({"theta_d_K": out["theta_d_K"],
                          "gruneisen": out["gruneisen"],
                          "kappa_w_mk": out["kappa_w_mk"][:3]}))


if __name__ == "__main__":
    main(sys.argv[1:])
