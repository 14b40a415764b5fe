"""Graph construction: periodic k-NN / radius graphs + line-graph indices.

Counterpart of ``alignn_tpu/graph/build.py`` (host-side numpy, no torch):
flat index arrays, edges sorted by dst, the line graph sorted by lg_dst.
The neighbour search of the k-NN, the radius and the jarvis radius
strategies takes the C++ cell list (:mod:`alignn_tpu_torch.native`, a copy
of the JAX package's) first, as the JAX package does, and the numpy
supercell tiling on a host without ``g++``.

Line-graph semantics match DGL's default ``backtracking=True``: an L-edge
(e1 -> e2) exists for every ordered pair with dst(e1) == src(e2),
including the pair of an edge with its own reverse.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from alignn_tpu_torch import native
from alignn_tpu_torch.chem.atoms import Atoms


@dataclass
class GraphData:
    """One structure's graph as flat numpy arrays (host-side)."""

    z: np.ndarray            # [N] atomic numbers (int32)
    frac_coords: np.ndarray  # [N, 3]
    lattice: np.ndarray      # [3, 3]
    volume: float
    src: np.ndarray          # [E] int32
    dst: np.ndarray          # [E] int32, ascending
    r: np.ndarray            # [E, 3] cart displacement src -> dst
    images: np.ndarray       # [E, 3] periodic image of dst (float)
    lg_src: Optional[np.ndarray] = None  # [L] int32 edge ids
    lg_dst: Optional[np.ndarray] = None  # [L] int32 edge ids, ascending
    # optional training labels
    target: Optional[np.ndarray] = None            # [T] graph-level
    atomwise_target: Optional[np.ndarray] = None   # [N, A]
    forces: Optional[np.ndarray] = None            # [N, 3]
    stress: Optional[np.ndarray] = None            # [3, 3]
    additional: Optional[np.ndarray] = None        # [Fadd]

    @property
    def num_nodes(self) -> int:
        return int(self.z.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def num_lg_edges(self) -> int:
        return 0 if self.lg_src is None else int(self.lg_src.shape[0])


# ---------------------------------------------------------------------------
# periodic neighbour search
# ---------------------------------------------------------------------------


def _image_ranges(atoms: Atoms, cutoff: float, bond_tol: float = 0.5):
    """Supercell image index ranges needed to cover `cutoff`."""
    recp = 2 * np.pi * np.linalg.inv(atoms.lattice_mat).T
    recp_len = np.sqrt(np.sum(recp**2, axis=1))
    maxr = np.ceil((cutoff + bond_tol) * recp_len / (2 * np.pi))
    frac = atoms.frac_coords
    nmin = np.floor(np.min(frac, axis=0)) - maxr
    nmax = np.ceil(np.max(frac, axis=0)) + maxr
    return nmin.astype(np.int64), nmax.astype(np.int64)


def _tiled_pairs(atoms: Atoms, cutoff: float, bond_tol: float = 0.5,
                 atol: float = 1e-5):
    """All (src, dst, image, displacement, distance) pairs within cutoff.

    Self-pairs at distance ~0 are excluded.  Returns arrays
    (u [P], v [P], images [P,3] int, disp [P,3], dist [P]).

    The C++ cell list first (its own image window, whatever `bond_tol`),
    numpy supercell tiling when it is unavailable, as in the JAX package.
    """
    pairs = native.periodic_pairs_native(atoms.lattice_mat,
                                         atoms.frac_coords, cutoff,
                                         atol=atol)
    if pairs is not None:
        return pairs
    nmin, nmax = _image_ranges(atoms, cutoff, bond_tol)
    ranges = [np.arange(nmin[k], nmax[k]) for k in range(3)]
    cell_images = np.stack(
        np.meshgrid(*ranges, indexing="ij"), axis=-1).reshape(-1, 3)
    cart = atoms.cart_coords
    n = cart.shape[0]
    shifts = cell_images.astype(np.float64) @ atoms.lattice_mat
    us, vs, ims, disps, dists = [], [], [], [], []
    # chunk over images to bound memory for large cells
    chunk = max(1, int(4e7 // max(n * n, 1)))
    for s0 in range(0, shifts.shape[0], chunk):
        sh = shifts[s0:s0 + chunk]
        # disp[i, m, j] = cart[j] + sh[m] - cart[i]
        disp = (cart[None, None, :, :] + sh[None, :, None, :]
                - cart[:, None, None, :])
        dist = np.linalg.norm(disp, axis=-1)
        ii, mm, jj = np.nonzero((dist <= cutoff) & (dist > atol))
        us.append(ii)
        vs.append(jj)
        ims.append(cell_images[s0 + mm])
        disps.append(disp[ii, mm, jj])
        dists.append(dist[ii, mm, jj])
    return (np.concatenate(us), np.concatenate(vs),
            np.concatenate(ims), np.concatenate(disps),
            np.concatenate(dists))


def all_neighbors(atoms: Atoms, cutoff: float):
    """Per-site neighbour lists: list over sites of (dst, dist, image)."""
    u, v, images, _disp, dist = _tiled_pairs(atoms, cutoff)
    order = np.argsort(u, kind="stable")
    u, v, images, dist = u[order], v[order], images[order], dist[order]
    bounds = np.searchsorted(u, np.arange(atoms.num_atoms + 1))
    return [(v[lo:hi], dist[lo:hi], images[lo:hi])
            for lo, hi in zip(bounds[:-1], bounds[1:])]


# ---------------------------------------------------------------------------
# k-nearest strategy
# ---------------------------------------------------------------------------


def wrap_frac(frac: np.ndarray) -> np.ndarray:
    """Wrap fractional coords into [0, 1) -- strictly.

    ``frac % 1.0`` alone maps a tiny negative coordinate to exactly 1.0
    in f64; the follow-up subtraction pins that boundary to 0.0 so two
    code paths that wrap agree.
    """
    f = np.asarray(frac, dtype=np.float64) % 1.0
    return np.where(f >= 1.0, f - 1.0, f)


def canonize_edge(src_id, dst_id, src_image, dst_image):
    """Canonical edge: sorted ids, src shifted into the (0,0,0) image."""
    if dst_id < src_id:
        src_id, dst_id = dst_id, src_id
        src_image, dst_image = dst_image, src_image
    if src_image != (0, 0, 0):
        shift = src_image
        src_image = tuple(np.subtract(src_image, shift))
        dst_image = tuple(np.subtract(dst_image, shift))
    return src_id, dst_id, src_image, dst_image


def nearest_neighbor_edges(atoms: Atoms, cutoff: float = 8.0,
                           max_neighbors: int = 12,
                           use_canonize: bool = True,
                           max_attempts: int = 10,
                           tie_tol: float = 0.0) -> dict:
    """Periodic k-NN edge set with k-th-shell tie inclusion.

    Returns {(src_id, dst_id): set(dst_image)}.  The cutoff grows while
    any site has fewer than `max_neighbors` neighbours; every neighbour at
    distance <= d_k * (1 + tie_tol) is kept, so ties can exceed k.
    ``tie_tol`` > 0 (the Calculator uses 1e-6) keeps the edge set of
    high-symmetry crystals stable under uniform strain.
    """
    for _attempt in range(max_attempts):
        neighbors = all_neighbors(atoms, cutoff)
        if min(len(nb[0]) for nb in neighbors) >= max_neighbors:
            break
        lat = atoms.lattice
        big = max(lat.a, lat.b, lat.c)
        cutoff = big if cutoff < big else 2 * cutoff
    else:
        raise ValueError(f"kNN graph failed after {max_attempts} attempts")

    edges: dict = {}
    for site_idx, (ids, distances, images) in enumerate(neighbors):
        order = np.argsort(distances, kind="stable")
        ids, distances, images = ids[order], distances[order], images[order]
        max_dist = distances[max_neighbors - 1]
        keep = distances <= max_dist * (1.0 + tie_tol)
        for dst, image in zip(ids[keep], images[keep]):
            image = tuple(int(x) for x in image)
            if use_canonize:
                src_id, dst_id, _src_im, dst_im = canonize_edge(
                    site_idx, int(dst), (0, 0, 0), image)
                edges.setdefault((src_id, dst_id), set()).add(dst_im)
            else:
                edges.setdefault((site_idx, int(dst)), set()).add(image)
    return edges


def build_undirected_edgedata(atoms: Atoms, edges: dict):
    """Expand the edge dict into +/-r directed pairs.

    The reverse edge stores the negated image, so
    ``r_e == cart[dst_e] + images_e @ lattice - cart[src_e]`` for every
    edge.
    """
    u, v, r, all_images = [], [], [], []
    for (src_id, dst_id), image_set in edges.items():
        for dst_image in image_set:
            dst_coord = atoms.frac_coords[dst_id] + np.array(dst_image)
            d = atoms.lattice.cart_coords(
                dst_coord - atoms.frac_coords[src_id])
            neg_image = tuple(-x for x in dst_image)
            for uu, vv, dd, im in [(src_id, dst_id, d, dst_image),
                                   (dst_id, src_id, -d, neg_image)]:
                u.append(uu)
                v.append(vv)
                r.append(dd)
                all_images.append(im)
    return (np.array(u, dtype=np.int32), np.array(v, dtype=np.int32),
            np.array(r, dtype=np.float64),
            np.array(all_images, dtype=np.float64))


# ---------------------------------------------------------------------------
# radius strategy
# ---------------------------------------------------------------------------


def radius_graph(atoms: Atoms, cutoff: float = 5.0, bond_tol: float = 0.5,
                 atol: float = 1e-5, cutoff_extra: float = 0.5,
                 max_attempts: int = 20):
    """Supercell-tiled radius graph; the cutoff grows until every atom has
    an incident edge.  Returns (u, v, r, images)."""
    for _ in range(max_attempts):
        u, v, images, disp, _dist = _tiled_pairs(
            atoms, cutoff, bond_tol=bond_tol, atol=atol)
        present = np.zeros(atoms.num_atoms, dtype=bool)
        present[u] = True
        present[v] = True
        if present.all() and u.size > 0:
            return (u.astype(np.int32), v.astype(np.int32),
                    disp, images.astype(np.float64))
        cutoff += cutoff_extra
    raise ValueError(f"radius graph failed after {max_attempts} attempts")


def radius_graph_jarvis(atoms: Atoms, cutoff: float = 4.0,
                        cutoff_extra: float = 0.5, max_attempts: int = 10,
                        atol: float = 1e-5):
    """Per-atom sphere-query radius graph.  Unlike :func:`radius_graph` it
    drops every self-image bond (i -> i in another cell), pads the search
    radius by no `bond_tol`, and extends the cutoff by `cutoff_extra`
    until every atom has an incident edge.  Returns (u, v, r, images)."""
    for _ in range(max_attempts):
        u, v, images, disp, _dist = _tiled_pairs(
            atoms, cutoff, bond_tol=0.0, atol=atol)
        keep = u != v
        u, v, images, disp = u[keep], v[keep], images[keep], disp[keep]
        present = np.zeros(atoms.num_atoms, dtype=bool)
        present[u] = True
        present[v] = True
        if present.all() and u.size > 0:
            return (u.astype(np.int32), v.astype(np.int32),
                    disp, images.astype(np.float64))
        cutoff += cutoff_extra
    raise ValueError(
        f"radius_graph_jarvis failed after {max_attempts} attempts")


# ---------------------------------------------------------------------------
# line graph
# ---------------------------------------------------------------------------


def line_graph_edges(src: np.ndarray, dst: np.ndarray, num_nodes: int):
    """L(g) index arrays: L-edge (e1 -> e2) iff dst[e1] == src[e2].

    Output is sorted by e2 (lg_dst ascending), so reductions over lg_dst
    are contiguous ranges.
    """
    e = src.shape[0]
    if e == 0:
        return (np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int32))
    sort_idx = np.argsort(dst, kind="stable").astype(np.int64)
    counts = np.bincount(dst, minlength=num_nodes)
    starts = np.concatenate([[0], np.cumsum(counts)])
    c2 = counts[src]
    total = int(c2.sum())
    lg_dst = np.repeat(np.arange(e, dtype=np.int64), c2)
    grp_start = np.repeat(starts[src], c2)
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.concatenate([[0], np.cumsum(c2)])[:-1], c2)
    lg_src = sort_idx[grp_start + offs]
    return lg_src.astype(np.int32), lg_dst.astype(np.int32)


# ---------------------------------------------------------------------------
# top-level assembly
# ---------------------------------------------------------------------------


def build_graph(atoms: Atoms, neighbor_strategy: str = "k-nearest",
                cutoff: float = 8.0, max_neighbors: int = 12,
                use_canonize: bool = True, compute_line_graph: bool = True,
                cutoff_extra: float = 3.5,
                tie_tol: float = 0.0,
                lg_cutoff: Optional[float] = None) -> GraphData:
    """Build a :class:`GraphData` for one structure, edges sorted by dst."""
    # the image-range search derives its window from the fractional
    # bounding box, so coordinates are wrapped into [0, 1) first
    frac = np.asarray(atoms.frac_coords)
    if frac.size and (frac.min() < 0.0 or frac.max() >= 1.0):
        atoms = Atoms(lattice_mat=atoms.lattice_mat,
                      frac_coords=wrap_frac(frac),
                      elements=atoms.elements)
    if neighbor_strategy == "k-nearest":
        edges = nearest_neighbor_edges(
            atoms, cutoff=cutoff, max_neighbors=max_neighbors,
            use_canonize=use_canonize, tie_tol=tie_tol)
        u, v, r, images = build_undirected_edgedata(atoms, edges)
    elif neighbor_strategy == "radius_graph":
        u, v, r, images = radius_graph(
            atoms, cutoff=cutoff, cutoff_extra=cutoff_extra)
    elif neighbor_strategy == "radius_graph_jarvis":
        # its own cutoff_extra (0.5), not build_graph's, as in JAX
        u, v, r, images = radius_graph_jarvis(atoms, cutoff=cutoff)
    else:
        raise ValueError(f"unknown neighbor_strategy: {neighbor_strategy}")

    order = np.argsort(v, kind="stable")
    u, v, r, images = u[order], v[order], r[order], images[order]
    lg_src = lg_dst = None
    if compute_line_graph:
        lg_src, lg_dst = line_graph_edges(u, v, atoms.num_atoms)
        if lg_cutoff is not None:
            # pruned line graph: keep only bond pairs whose two bonds are
            # both <= lg_cutoff (filtering keeps lg_dst sorted)
            short = np.linalg.norm(r, axis=1) <= float(lg_cutoff)
            keep = short[lg_src] & short[lg_dst]
            lg_src, lg_dst = lg_src[keep], lg_dst[keep]
    return GraphData(
        z=atoms.atomic_numbers,
        frac_coords=atoms.frac_coords.astype(np.float64),
        lattice=atoms.lattice_mat.astype(np.float64),
        volume=atoms.volume,
        src=u.astype(np.int32),
        dst=v.astype(np.int32),
        r=r.astype(np.float64),
        images=np.asarray(images, dtype=np.float64),
        lg_src=lg_src,
        lg_dst=lg_dst,
    )


ROCKSALT_FRAC = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5],
                          [0, 0.5, 0.5], [0.5, 0, 0], [0, 0.5, 0],
                          [0, 0, 0.5], [0.5, 0.5, 0.5]])
ROCKSALT_ELEMENTS = ["Na", "Cl", "K", "Br", "Mg", "O", "Ca", "S"]


def rocksalt_graphs(n: int, seed: int = 0, rattle: float = 0.02,
                    **graph_kw) -> list:
    """`n` labelled, rattled 8-atom rocksalt cells (cubic, a = 4.2 + 0.3
    N(0, 1) Å), each as a k-NN graph (12 neighbours, cutoff 8 Å, or the
    :func:`build_graph` arguments `graph_kw` give): the synthetic batch of
    ``bench.py``.

    One numpy generator from `seed` draws, cell by cell: the lattice
    constant, the rattle of the fractional coordinates (`rattle` times
    N(0, 1)), the energy target N(0, 1) and the forces 0.1 N(0, 1); the
    stress label is 0.01 I.  ``bench.py`` draws in this order with rattle
    0.02, ``tests/test_dense.py`` with rattle 0.03.
    """
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(n):
        a = 4.2 + 0.3 * rng.standard_normal()
        frac = ROCKSALT_FRAC + rattle * rng.standard_normal((8, 3))
        g = build_graph(Atoms(lattice_mat=np.eye(3) * a, frac_coords=frac,
                              elements=ROCKSALT_ELEMENTS),
                        **{"cutoff": 8.0, "max_neighbors": 12, **graph_kw})
        g.target = np.array([rng.standard_normal()])
        g.forces = rng.standard_normal((8, 3)) * 0.1
        g.stress = np.eye(3) * 0.01
        graphs.append(g)
    return graphs
