#!/usr/bin/env python
"""Vacancy-formation campaign over structures (counterpart of
``alignn_tpu/scripts/defect.py``): for each input structure, the vacancy
formation energy of each distinct element with the trained FF
(``ff.tasks.vacancy_formation``).
"""

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True)
    p.add_argument("files", nargs="+")
    p.add_argument("--supercell", default="2,2,2")
    p.add_argument("--output", default="vacancies.json")
    p.add_argument("--device", default=None,
                   help="torch device of the model (default cuda)")
    args = p.parse_args(argv)

    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.ff.calculator import Calculator
    from alignn_tpu_torch.ff.tasks import vacancy_formation

    calc = Calculator(path=args.model_path, device=args.device)
    sc = tuple(int(x) for x in args.supercell.split(","))
    out = {}
    for f in args.files:
        atoms = Atoms.from_file(f)
        out[f] = vacancy_formation(calc, atoms, supercell=sc)
        print(f, out[f])
    with open(args.output, "w") as fo:
        json.dump(out, fo)
    return out


if __name__ == "__main__":
    main()
