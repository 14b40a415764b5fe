#!/usr/bin/env python
"""Relax a set of (cubic) structures and report lattice constants
(counterpart of ``alignn_tpu/scripts/cubic_mat_relax.py``).
"""

import argparse
import json

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True)
    p.add_argument("files", nargs="+")
    p.add_argument("--fmax", type=float, default=0.05)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--optimizer", default="fire")
    p.add_argument("--output", default="relaxed.json")
    p.add_argument("--device", default=None,
                   help="torch device of the model (default cuda)")
    args = p.parse_args(argv)

    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.ff.calculator import Calculator
    from alignn_tpu_torch.ff.relax import relax

    calc = Calculator(path=args.model_path, device=args.device)
    out = {}
    for f in args.files:
        atoms = Atoms.from_file(f)
        a0 = float(np.linalg.norm(atoms.lattice_mat[0]))
        relaxed, energy, n = relax(calc, atoms, optimizer=args.optimizer,
                                   fmax=args.fmax, steps=args.steps,
                                   optimize_lattice=True)
        a1 = float(np.linalg.norm(relaxed.lattice_mat[0]))
        out[f] = {"a_initial": a0, "a_relaxed": a1,
                  "energy": energy, "steps": n,
                  "atoms": relaxed.to_dict()}
        print(f, f"a {a0:.3f} -> {a1:.3f} A, E {energy:.4f} eV ({n} steps)")
    with open(args.output, "w") as fo:
        json.dump(out, fo)
    return out


if __name__ == "__main__":
    main()
