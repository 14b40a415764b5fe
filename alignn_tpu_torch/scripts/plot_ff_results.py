#!/usr/bin/env python
"""Plot FF training histories and parity scatters (counterpart of
``alignn_tpu/scripts/plot_ff_results.py``): ``train.plots.plot_ff_training``
over one or more run directories.
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("dirs", nargs="+", help="training output dirs")
    p.add_argument("--results", default="Val_results.json")
    args = p.parse_args(argv)

    from alignn_tpu_torch.train.plots import plot_ff_training

    for d in args.dirs:
        plot_ff_training(d, results=args.results)
        print(f"plots written under {d} (history.png, parity.png)")


if __name__ == "__main__":
    main()
