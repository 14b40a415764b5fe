#!/usr/bin/env python
"""Energy-volume curves for a set of structures, side by side
(counterpart of ``alignn_tpu/scripts/ev_curve_comp.py``).

Runs the FF EV-curve task (relax, then a +/-5% isotropic strain sweep and
a Murnaghan fit) on each input structure, plots the per-atom E(V) curves
in a 1xN grid, and prints ``Formula,DFT,FF`` bulk-modulus comparison rows
(DFT values from a records json with ``bulk_modulus_kv``).
"""

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_path", required=True,
                   help="FF model dir (config.json + checkpoint)")
    p.add_argument("files", nargs="+", help="structure files (POSCAR/CIF)")
    p.add_argument("--records_json", default=None,
                   help="optional json list with reference "
                        "bulk_modulus_kv values keyed by file basename")
    p.add_argument("--stress_wt", type=float, default=0.3)
    p.add_argument("--no_relax", action="store_true",
                   help="skip the pre-relaxation (reference "
                        "on_relaxed_struct=True is the default)")
    p.add_argument("--output", default="ev_chem.png")
    p.add_argument("--device", default=None,
                   help="torch device of the model (default cuda)")
    args = p.parse_args(argv)

    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.ff.calculator import Calculator
    from alignn_tpu_torch.ff.tasks import ev_curve

    calc = Calculator(path=args.model_path, stress_wt=args.stress_wt,
                      device=args.device)
    ref_kv = {}
    if args.records_json:
        with open(args.records_json) as f:
            for r in json.load(f):
                ref_kv[r.get("id", r.get("jid", ""))] = r.get(
                    "bulk_modulus_kv", "na")

    results = []
    for path in args.files:
        atoms = Atoms.from_file(path)
        out = ev_curve(calc, atoms, relax_first=not args.no_relax)
        formula = "".join(f"{el}{n if n > 1 else ''}"
                          for el, n in sorted(atoms.composition.items()))
        n = atoms.num_atoms
        results.append({
            "file": path, "formula": formula,
            "vols": [v / n for v in out["volumes"]],
            "energies": [e / n for e in out["energies"]],
            "kv_ff": out["kv"],
        })
        base = os.path.splitext(os.path.basename(path))[0]
        dft = ref_kv.get(base, ref_kv.get(path, ref_kv.get(formula,
                                                           "na")))
        print("Formula,DFT,FF", formula, dft, out["kv"])

    kv = {r["formula"]: r["kv_ff"] for r in results}
    try:
        import matplotlib
    except ImportError:   # a host without it still gets the numbers
        print(json.dumps({"plot": None, "kv_ff": kv}))
        return results

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(results)
    plt.rcParams.update({"font.size": 14})
    fig, axes = plt.subplots(1, n, figsize=(3.0 * n + 3, 4),
                             squeeze=False)
    for i, r in enumerate(results):
        ax = axes[0][i]
        ax.set_title(r["formula"])
        ax.plot(r["vols"], r["energies"], "-*", label=r["file"])
        ax.set_xlabel("V")
        if i == 0:
            ax.set_ylabel("E(eV/atom)")
    fig.tight_layout()
    fig.savefig(args.output)
    plt.close(fig)
    print(json.dumps({"plot": args.output, "kv_ff": kv}))
    return results


if __name__ == "__main__":
    main()
