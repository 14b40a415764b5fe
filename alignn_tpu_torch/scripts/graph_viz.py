#!/usr/bin/env python
"""Visualize a crystal graph (counterpart of
``alignn_tpu/scripts/graph_viz.py``).

Builds the legacy adjacency graph of a structure and draws it with
networkx (spring layout, nodes labelled by element).
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--file_path", required=True)
    p.add_argument("--cutoff", type=float, default=8.0)
    p.add_argument("--max_neighbors", type=int, default=12)
    p.add_argument("--output", default="graph.png")
    args = p.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import networkx as nx

    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.graph.legacy import Graph

    atoms = Atoms.from_file(args.file_path)
    g = Graph.from_atoms(atoms, cutoff=args.cutoff)
    nxg = g.to_networkx()
    labels = {i: e for i, e in enumerate(atoms.elements)}
    plt.figure(figsize=(6, 6))
    nx.draw(nxg, labels=labels, node_color="#8ab4f8", node_size=400,
            font_size=8)
    plt.savefig(args.output, dpi=120, bbox_inches="tight")
    print("wrote", args.output)


if __name__ == "__main__":
    main()
