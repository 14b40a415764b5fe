#!/usr/bin/env python
"""Vacancy formation energies from a total-energy model (counterpart of
``alignn_tpu/scripts/alignn_evac.py``).

Instead of relaxing with the FF (that path is ``scripts/defect.py``), it
scores the frozen defect structure with the per-atom total-energy
property model:

    Ef = E_def_total - (N_def + 1) * E_bulk_per_atom + mu(removed) + 1.3

as the reference's ``alignn_evac.py`` does, with its +1.3 eV empirical
shift and without rescaling the per-atom bulk prediction.

Chemical potentials come from ``--chem_pot_json`` ({element: mu_eV});
an element without one takes the bulk per-atom energy, with a warning.
"""

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("files", nargs="+", help="structure files")
    p.add_argument("--model", default="jv_optb88vdw_total_energy_alignn",
                   help="zoo name or local model dir (per-atom total E)")
    p.add_argument("--chem_pot_json", default=None,
                   help="json {element: mu_eV} (jarvis unary_energy)")
    p.add_argument("--supercell", default="2,2,2")
    p.add_argument("--shift", type=float, default=1.3,
                   help="empirical Ef shift (reference alignn_evac)")
    p.add_argument("--output", default="evac.json")
    p.add_argument("--device", default=None,
                   help="torch device of the model (default cuda)")
    args = p.parse_args(argv)

    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.ff.tasks import generate_vacancies
    from alignn_tpu_torch.zoo import (get_figshare_model,
                                      graph_kwargs_from_config,
                                      load_model_dir, predict_structures)

    if os.path.isdir(args.model):
        model, cfg = load_model_dir(args.model, args.device)
    else:
        model, cfg = get_figshare_model(args.model)
    # the featurisation must match the checkpoint's training config
    gkw = graph_kwargs_from_config(cfg)
    chem_pot = {}
    if args.chem_pot_json:
        with open(args.chem_pot_json) as f:
            chem_pot = json.load(f)
    sc = tuple(int(x) for x in args.supercell.split(","))

    mem = []
    for path in args.files:
        atoms = Atoms.from_file(path)
        bulk = atoms.make_supercell(sc)
        vacancies = list(generate_vacancies(atoms, supercell=sc))
        # one prediction call a file: the bulk and every vacancy share a
        # bucket
        structs = [bulk] + [vac for _, vac in vacancies]
        e_peratom = predict_structures(model, structs, **gkw)[:, 0]
        e_bulk_peratom = float(e_peratom[0])
        for (el, vac), e_vac in zip(vacancies, e_peratom[1:]):
            e_def_total = float(e_vac) * vac.num_atoms
            if el not in chem_pot:
                print(f"warning: no chem_pot for {el}; using bulk "
                      f"per-atom energy (pass --chem_pot_json)")
            mu = chem_pot.get(el, e_bulk_peratom)
            ef = (e_def_total - (vac.num_atoms + 1) * e_bulk_peratom
                  + mu + args.shift)
            info = {"file": path, "symb": el, "Ef2": float(ef),
                    "n_def": vac.num_atoms, "mu": float(mu)}
            mem.append(info)
            print(info)
    with open(args.output, "w") as f:
        json.dump(mem, f)
    return mem


if __name__ == "__main__":
    main()
