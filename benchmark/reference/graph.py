"""Crystal graphs for the plain reference: periodic k-NN edges and the
line graph, in numpy.

The rules are the published ALIGNN ones (jarvis-tools
``nearest_neighbor_edges`` and ``build_undirected_edgedata``, DGL's
``line_graph`` with backtracking):

- fractional coordinates are wrapped into [0, 1);
- each site keeps every neighbour (any periodic image, self-images
  included, the site itself excluded) whose distance is at most that of
  its ``max_neighbors``-th nearest, within ``cutoff``; while any site has
  fewer neighbours than that, the cutoff grows (to the longest lattice
  vector, then doubling);
- every kept (i, j, image) gives two directed edges, i -> j with the image
  and j -> i with its negation; without canonisation a bond that both ends
  keep appears twice in each direction, with it (``use_canonize``) each
  bond is first written with the lower site id first and that site in the
  home cell, and a bond written twice is kept once;
- the bond vector of edge e is r_e = cart(frac[dst] + image) - cart(frac[src]);
- the line graph joins e1 -> e2 wherever dst(e1) == src(e2), an edge and
  its own reverse included.

Written from those rules with a brute-force search over periodic images;
it shares no code with the program under test.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import numpy as np


@dataclass
class Graph:
    """One structure's graph (numpy, float64 geometry)."""

    z: np.ndarray        # [N] atomic numbers
    frac: np.ndarray     # [N, 3] wrapped fractional coordinates
    lattice: np.ndarray  # [3, 3] rows are lattice vectors
    src: np.ndarray      # [E] int64
    dst: np.ndarray      # [E] int64
    images: np.ndarray   # [E, 3] int64
    r: np.ndarray        # [E, 3] bond vectors
    lg_src: np.ndarray   # [L] int64 edge ids
    lg_dst: np.ndarray   # [L] int64 edge ids

    @property
    def counts(self):
        return len(self.z), len(self.src), len(self.lg_src)


def wrap(frac: np.ndarray) -> np.ndarray:
    f = np.asarray(frac, dtype=np.float64) % 1.0
    return np.where(f >= 1.0, f - 1.0, f)


def _cart(f: np.ndarray, lattice: np.ndarray) -> np.ndarray:
    """Cartesian rows of fractional rows f: f0 a + f1 b + f2 c."""
    return (f[:, 0:1] * lattice[0] + f[:, 1:2] * lattice[1]
            + f[:, 2:3] * lattice[2])


def _pairs(frac, lattice, cutoff, atol=1e-5):
    """(i, j, image [P, 3], distance [P]) of every pair within cutoff.

    A distance is that of the image's position, cart(f_j + n), from the
    site's, cart(f_i), each position formed as f0 a + f1 b + f2 c, the
    squares summed x, y, z: written out so that distances that are equal
    by symmetry (a site's periodic images) tie or part exactly as in any
    implementation that forms them so, whatever the rounding."""
    recip = np.linalg.inv(lattice).T          # rows: reciprocal / 2 pi
    reach = np.ceil(cutoff * np.linalg.norm(recip, axis=1)).astype(int) + 1
    grid = np.stack(np.meshgrid(*[np.arange(-k, k + 1) for k in reach],
                                indexing="ij"), -1).reshape(-1, 3)
    site = _cart(frac, lattice)
    out_i, out_j, out_im, out_d = [], [], [], []
    for im in grid:
        pos = _cart(frac + im, lattice)
        d = pos[None, :, :] - site[:, None, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
            + d[..., 2] * d[..., 2]
        ii, jj = np.nonzero((d2 <= cutoff * cutoff) & (d2 > atol * atol))
        out_i.append(ii)
        out_j.append(jj)
        out_im.append(np.repeat(im[None], len(ii), 0))
        out_d.append(np.sqrt(d2[ii, jj]))
    return (np.concatenate(out_i), np.concatenate(out_j),
            np.concatenate(out_im), np.concatenate(out_d))


def knn_edges(frac, lattice, cutoff=8.0, max_neighbors=12):
    """[(i, j, image)] kept by the k-NN rule, in site order."""
    n = len(frac)
    for _ in range(10):
        i, j, im, d = _pairs(frac, lattice, cutoff)
        if np.bincount(i, minlength=n).min() >= max_neighbors:
            break
        longest = np.linalg.norm(lattice, axis=1).max()
        cutoff = longest if cutoff < longest else 2 * cutoff
    else:
        raise ValueError("k-NN graph: too few neighbours")
    kept = []
    for site in range(n):
        sel = np.nonzero(i == site)[0]
        dk = np.sort(d[sel])[max_neighbors - 1]
        for p in sel[d[sel] <= dk]:
            kept.append((site, int(j[p]), tuple(int(x) for x in im[p])))
    return kept


def line_graph(src: np.ndarray, dst: np.ndarray, n: int):
    """(lg_src, lg_dst): e1 -> e2 wherever dst[e1] == src[e2]."""
    into = [[] for _ in range(n)]
    for e, t in enumerate(dst):
        into[t].append(e)
    lg_src, lg_dst = [], []
    for e2, s in enumerate(src):
        lg_src.extend(into[s])
        lg_dst.extend([e2] * len(into[s]))
    return np.asarray(lg_src, np.int64), np.asarray(lg_dst, np.int64)


def canonical(i: int, j: int, im: tuple) -> tuple:
    """The bond i -> j (image im) written from its lower site, which sits
    in the home cell."""
    if j < i:
        return j, i, tuple(-x for x in im)
    return i, j, im


def build(z, frac, lattice, cutoff=8.0, max_neighbors=12,
          use_canonize=False) -> Graph:
    """The k-NN graph with its line graph."""
    frac = wrap(frac)
    lattice = np.asarray(lattice, dtype=np.float64)
    kept = knn_edges(frac, lattice, cutoff, max_neighbors)
    if use_canonize:
        seen, unique = set(), []
        for bond in (canonical(*k) for k in kept):
            if bond not in seen:
                seen.add(bond)
                unique.append(bond)
        kept = unique
    src, dst, images = [], [], []
    for i, j, im in kept:
        src += [i, j]
        dst += [j, i]
        images += [im, tuple(-x for x in im)]
    src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    images = np.asarray(images, np.int64).reshape(-1, 3)
    r = (frac[dst] + images - frac[src]) @ lattice
    lg_src, lg_dst = line_graph(src, dst, len(frac))
    return Graph(np.asarray(z, np.int64), frac, lattice, src, dst, images,
                 r, lg_src, lg_dst)


def edges_differ(a, b) -> int:
    """How many directed edges (src, dst, image) one of two graphs has and
    the other lacks, duplicates counted: 0 for the same edges."""
    def bag(g):
        im = np.rint(np.asarray(g.images)).astype(np.int64)
        return Counter(zip(np.asarray(g.src).tolist(),
                           np.asarray(g.dst).tolist(),
                           map(tuple, im.tolist())))
    ca, cb = bag(a), bag(b)
    return sum(((ca - cb) + (cb - ca)).values())
