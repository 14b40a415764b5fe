#!/usr/bin/env python
"""Energy-volume curves and EOS fits for a set of structures
(counterpart of ``alignn_tpu/scripts/ev_curve.py``).
"""

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True)
    p.add_argument("files", nargs="+", help="structure files")
    p.add_argument("--dx", default=None,
                   help="comma-separated strain grid (default +-5%%)")
    p.add_argument("--output", default="ev_curves.json")
    p.add_argument("--device", default=None,
                   help="torch device of the model (default cuda)")
    args = p.parse_args(argv)

    import numpy as np

    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.ff.calculator import Calculator
    from alignn_tpu_torch.ff.tasks import ev_curve

    calc = Calculator(path=args.model_path, device=args.device)
    kw = {}
    if args.dx:
        kw["dx"] = [float(x) for x in args.dx.split(",")]
    out = {}
    for f in args.files:
        atoms = Atoms.from_file(f)
        res = ev_curve(calc, atoms, **kw)
        out[f] = {k: (np.asarray(v).tolist()
                      if isinstance(v, np.ndarray) else v)
                  for k, v in res.items() if k != "fcdata"}
        eos = res.get("eos", {})
        print(f, "V0", eos.get("V0"), "B(GPa)", eos.get("B_GPa"))
    with open(args.output, "w") as fo:
        json.dump(out, fo)
    return out


if __name__ == "__main__":
    main()
