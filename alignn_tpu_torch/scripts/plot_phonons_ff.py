#!/usr/bin/env python
"""Phonon band structure and DOS plots from a trained FF (counterpart of
``alignn_tpu/scripts/plot_phonons_ff.py``): the harmonic phonon pipeline
(``ff.phonons``) for a structure, saved as band and DOS plots.
"""

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True)
    p.add_argument("--file_path", required=True)
    p.add_argument("--supercell", default="2,2,2")
    p.add_argument("--output_prefix", default="phonons")
    p.add_argument("--device", default=None,
                   help="torch device of the model (default cuda)")
    args = p.parse_args(argv)

    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.ff import phonons as ph
    from alignn_tpu_torch.ff.calculator import Calculator

    atoms = Atoms.from_file(args.file_path)
    calc = Calculator(path=args.model_path, device=args.device)
    sc = tuple(int(x) for x in args.supercell.split(","))
    bands = ph.phonon_band_structure(calc, atoms, supercell=sc)
    fc = bands.get("fcdata") or bands.get("fc")
    freqs = np.asarray(bands["frequencies_THz"])  # [nq, nmodes]
    dos = ph.phonon_dos(fc)
    try:
        import matplotlib
    except ImportError:   # a host without it still gets the numbers
        print("matplotlib is not installed: no plot written")
        return {"frequencies_THz": freqs, "dos": dos, "plot": None}

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    for mode in range(freqs.shape[1]):
        axes[0].plot(freqs[:, mode], lw=0.8)
    axes[0].set_ylabel("THz")
    axes[0].set_title("Phonon bands")
    axes[1].plot(dos["frequencies_THz"], dos["dos"])
    axes[1].set_title("DOS")
    axes[1].set_xlabel("THz")
    fig.tight_layout()
    out = f"{args.output_prefix}_bands_dos.png"
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print("wrote", out)
    return {"frequencies_THz": freqs, "dos": dos, "plot": out}


if __name__ == "__main__":
    main()
