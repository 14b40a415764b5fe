"""Crystal/molecular structure container with file IO.

Counterpart of ``alignn_tpu/chem/atoms.py``: lattice math, fractional and
cartesian coordinates, POSCAR/CIF/XYZ/PDB parsing, supercells (diagonal
and general integer matrices) and the dict round-trip in the schema of
the datasets (``lattice_mat``, ``coords``, ``elements``, ``cartesian``,
...), plus the atomic mass table of the MD and phonon modules.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from alignn_tpu_torch.chem.periodic_table import Z_FROM_SYMBOL, atomic_number


@dataclass(frozen=True)
class Lattice:
    """3x3 row-vector lattice."""

    matrix: np.ndarray

    def __post_init__(self):
        object.__setattr__(
            self, "matrix",
            np.asarray(self.matrix, dtype=np.float64).reshape(3, 3)
        )

    @property
    def a(self) -> float:
        return float(np.linalg.norm(self.matrix[0]))

    @property
    def b(self) -> float:
        return float(np.linalg.norm(self.matrix[1]))

    @property
    def c(self) -> float:
        return float(np.linalg.norm(self.matrix[2]))

    @property
    def abc(self) -> np.ndarray:
        return np.linalg.norm(self.matrix, axis=1)

    @property
    def angles(self) -> np.ndarray:
        """(alpha, beta, gamma) in degrees."""
        m = self.matrix
        norms = np.linalg.norm(m, axis=1)
        alpha = np.degrees(np.arccos(np.clip(
            np.dot(m[1], m[2]) / (norms[1] * norms[2]), -1, 1)))
        beta = np.degrees(np.arccos(np.clip(
            np.dot(m[0], m[2]) / (norms[0] * norms[2]), -1, 1)))
        gamma = np.degrees(np.arccos(np.clip(
            np.dot(m[0], m[1]) / (norms[0] * norms[1]), -1, 1)))
        return np.array([alpha, beta, gamma])

    @property
    def volume(self) -> float:
        return float(abs(np.linalg.det(self.matrix)))

    @property
    def inv_matrix(self) -> np.ndarray:
        return np.linalg.inv(self.matrix)

    @property
    def reciprocal(self) -> np.ndarray:
        """Reciprocal lattice rows (2*pi convention)."""
        return 2.0 * np.pi * np.linalg.inv(self.matrix).T

    def cart_coords(self, frac: np.ndarray) -> np.ndarray:
        return np.asarray(frac, dtype=np.float64) @ self.matrix

    def frac_coords(self, cart: np.ndarray) -> np.ndarray:
        return np.asarray(cart, dtype=np.float64) @ self.inv_matrix

    @staticmethod
    def from_parameters(a, b, c, alpha, beta, gamma) -> "Lattice":
        """Build lattice matrix from lengths (Angstrom) and angles (deg)."""
        alpha_r, beta_r, gamma_r = np.radians([alpha, beta, gamma])
        cx = c * np.cos(beta_r)
        cy = c * (np.cos(alpha_r) - np.cos(beta_r) * np.cos(gamma_r)) \
            / np.sin(gamma_r)
        cz = np.sqrt(max(c**2 - cx**2 - cy**2, 0.0))
        mat = np.array([
            [a, 0.0, 0.0],
            [b * np.cos(gamma_r), b * np.sin(gamma_r), 0.0],
            [cx, cy, cz],
        ])
        return Lattice(mat)


@dataclass
class Atoms:
    """A periodic (or open-boundary) atomic structure."""

    lattice_mat: np.ndarray
    frac_coords: np.ndarray
    elements: list
    props: list = field(default_factory=list)
    cartesian_input: bool = False

    def __post_init__(self):
        self.lattice_mat = np.asarray(
            self.lattice_mat, dtype=np.float64).reshape(3, 3)
        self.frac_coords = np.asarray(
            self.frac_coords, dtype=np.float64).reshape(-1, 3)
        self.elements = list(self.elements)
        if not self.props:
            self.props = ["" for _ in self.elements]

    # -- constructors -------------------------------------------------------

    @classmethod
    def create(cls, lattice_mat, coords, elements, cartesian=False,
               props=None):
        """Create from lattice + coords (frac by default, cart if
        cartesian)."""
        lattice = Lattice(lattice_mat)
        coords = np.asarray(coords, dtype=np.float64).reshape(-1, 3)
        frac = lattice.frac_coords(coords) if cartesian else coords
        return cls(lattice_mat=lattice.matrix, frac_coords=frac,
                   elements=list(elements), props=list(props or []))

    @classmethod
    def from_dict(cls, d: dict) -> "Atoms":
        """jarvis-schema dict: lattice_mat/coords/elements/cartesian/props."""
        return cls.create(
            lattice_mat=d["lattice_mat"],
            coords=d["coords"],
            elements=d["elements"],
            cartesian=bool(d.get("cartesian", False)),
            props=d.get("props"),
        )

    def to_dict(self) -> dict:
        lat = self.lattice
        return {
            "lattice_mat": self.lattice_mat.tolist(),
            "coords": self.frac_coords.tolist(),
            "elements": list(self.elements),
            "abc": lat.abc.tolist(),
            "angles": lat.angles.tolist(),
            "cartesian": False,
            "props": list(self.props),
        }

    # -- properties ---------------------------------------------------------

    @property
    def lattice(self) -> Lattice:
        return Lattice(self.lattice_mat)

    @property
    def cart_coords(self) -> np.ndarray:
        return self.frac_coords @ self.lattice_mat

    @property
    def num_atoms(self) -> int:
        return len(self.elements)

    @property
    def atomic_numbers(self) -> np.ndarray:
        return np.array([atomic_number(e) for e in self.elements],
                        dtype=np.int32)

    @property
    def volume(self) -> float:
        return self.lattice.volume

    @property
    def composition(self) -> dict:
        comp: dict = {}
        for e in self.elements:
            comp[e] = comp.get(e, 0) + 1
        return comp

    @property
    def density(self) -> float:
        """g/cm^3 using integer-ish atomic masses."""
        masses = _ATOMIC_MASS
        total = sum(masses[Z_FROM_SYMBOL[e]] for e in self.elements)
        return float(total / (self.volume * 0.602214076))

    # -- transformations ----------------------------------------------------

    def make_supercell(self, dims) -> "Atoms":
        dims = np.asarray(dims, dtype=np.int64).reshape(3)
        images = np.stack(np.meshgrid(
            np.arange(dims[0]), np.arange(dims[1]), np.arange(dims[2]),
            indexing="ij"), axis=-1).reshape(-1, 3)
        new_lat = self.lattice_mat * dims[:, None]
        new_frac = []
        new_elems = []
        for img in images:
            new_frac.append((self.frac_coords + img) / dims)
            new_elems.extend(self.elements)
        return Atoms(lattice_mat=new_lat,
                     frac_coords=np.concatenate(new_frac, axis=0),
                     elements=new_elems)

    def make_supercell_matrix(self, p) -> "Atoms":
        """General integer-matrix supercell: new_lat = P @ lat.

        Needed by the Zur interface matching (ff/zur.py) and the slab
        maker (ff/tasks.py), where the transformations are
        non-diagonal.  Atoms fill by
        enumerating old-lattice translations inside the new cell.
        """
        p = np.asarray(p, dtype=np.int64).reshape(3, 3)
        n_cells = abs(int(round(np.linalg.det(p))))
        if n_cells == 0:
            raise ValueError("singular supercell matrix")
        new_lat = p @ self.lattice_mat
        corners = (np.array(list(np.ndindex(2, 2, 2))) @ p)
        lo = corners.min(axis=0) - 1
        hi = corners.max(axis=0) + 1
        grids = [np.arange(lo[i], hi[i] + 1) for i in range(3)]
        imgs = np.stack(np.meshgrid(*grids, indexing="ij"),
                        axis=-1).reshape(-1, 3)
        inv_p = np.linalg.inv(p)
        fracs, elems = [], []
        for img in imgs:
            f_new = (self.frac_coords + img) @ inv_p
            keep = np.all((f_new > -1e-9) & (f_new < 1 - 1e-9), axis=1)
            if keep.any():
                fracs.append(f_new[keep])
                elems.extend(np.asarray(self.elements)[keep].tolist())
        frac = np.concatenate(fracs, axis=0)
        if frac.shape[0] != n_cells * self.num_atoms:
            raise RuntimeError(
                f"supercell fill mismatch: {frac.shape[0]} vs "
                f"{n_cells * self.num_atoms}")
        return Atoms(lattice_mat=new_lat, frac_coords=frac,
                     elements=elems)

    def center_around_origin(self) -> "Atoms":
        shift = self.frac_coords.mean(axis=0)
        return Atoms(lattice_mat=self.lattice_mat,
                     frac_coords=self.frac_coords - shift + 0.5,
                     elements=self.elements, props=self.props)

    def with_positions(self, cart_coords=None, frac_coords=None,
                       lattice_mat=None) -> "Atoms":
        """Functional update used by the MD and relaxation loops."""
        lat = self.lattice_mat if lattice_mat is None \
            else np.asarray(lattice_mat)
        if cart_coords is not None:
            frac = np.asarray(cart_coords) @ np.linalg.inv(lat)
        elif frac_coords is not None:
            frac = np.asarray(frac_coords)
        else:
            frac = self.frac_coords
        return Atoms(lattice_mat=lat, frac_coords=frac,
                     elements=self.elements, props=self.props)

    # -- IO -----------------------------------------------------------------

    @classmethod
    def from_poscar(cls, path_or_str: str) -> "Atoms":
        """Parse a VASP POSCAR/CONTCAR (string or file path)."""
        if "\n" in path_or_str:
            text = path_or_str
        else:
            with open(path_or_str) as f:
                text = f.read()
        lines = [ln for ln in text.splitlines()]
        scale = float(lines[1].split()[0])
        lat = np.array([[float(x) for x in lines[i].split()[:3]]
                        for i in (2, 3, 4)])
        if scale < 0:  # negative scale = target volume
            vol = abs(np.linalg.det(lat))
            scale = (abs(scale) / vol) ** (1.0 / 3.0)
        lat = lat * scale
        species_line = lines[5].split()
        if all(tok.lstrip("-").isdigit() for tok in species_line):
            # VASP4 format without symbols: use props line 0 as symbols
            raise ValueError("POSCAR without element symbols not supported")
        counts = [int(x) for x in lines[6].split()]
        idx = 7
        if lines[idx].strip().lower().startswith("s"):  # selective dynamics
            idx += 1
        mode = lines[idx].strip().lower()
        cartesian = mode.startswith("c") or mode.startswith("k")
        idx += 1
        n = sum(counts)
        coords = np.array([[float(x) for x in lines[idx + i].split()[:3]]
                           for i in range(n)])
        if cartesian:
            coords = coords * scale
        elements = []
        for sym, cnt in zip(species_line, counts):
            elements.extend([sym] * cnt)
        return cls.create(lat, coords, elements, cartesian=cartesian)

    def to_poscar(self) -> str:
        """Serialize to POSCAR text."""
        order = []
        for e in self.elements:
            if e not in order:
                order.append(e)
        counts = {e: 0 for e in order}
        perm = []
        for e in order:
            for i, el in enumerate(self.elements):
                if el == e:
                    perm.append(i)
                    counts[e] += 1
        lines = ["alignn_tpu generated", "1.0"]
        for row in self.lattice_mat:
            lines.append(" ".join(f"{x:.10f}" for x in row))
        lines.append(" ".join(order))
        lines.append(" ".join(str(counts[e]) for e in order))
        lines.append("direct")
        for i in perm:
            lines.append(" ".join(f"{x:.10f}" for x in self.frac_coords[i]))
        return "\n".join(lines) + "\n"

    @classmethod
    def from_xyz(cls, path_or_str: str, box_size: float = 500.0) -> "Atoms":
        """Parse XYZ; molecules get a large cubic box (open boundary)."""
        if "\n" in path_or_str:
            text = path_or_str
        else:
            with open(path_or_str) as f:
                text = f.read()
        lines = text.splitlines()
        n = int(lines[0].split()[0])
        elements, coords = [], []
        for ln in lines[2:2 + n]:
            parts = ln.split()
            elements.append(parts[0])
            coords.append([float(x) for x in parts[1:4]])
        coords = np.asarray(coords)
        lat = np.eye(3) * box_size
        # center the molecule in the box
        coords = coords - coords.mean(axis=0) + box_size / 2.0
        return cls.create(lat, coords, elements, cartesian=True)

    @classmethod
    def from_cif(cls, path_or_str: str) -> "Atoms":
        """Minimal CIF parser: cell parameters + atom_site loop (P1 only).

        Symmetry operations beyond P1 are not expanded; files written by
        most ML-dataset pipelines are P1.
        """
        if "\n" in path_or_str:
            text = path_or_str
        else:
            with open(path_or_str) as f:
                text = f.read()
        vals = {}
        for key in ("_cell_length_a", "_cell_length_b", "_cell_length_c",
                    "_cell_angle_alpha", "_cell_angle_beta",
                    "_cell_angle_gamma"):
            for ln in text.splitlines():
                if ln.strip().startswith(key):
                    tok = ln.split()[1].split("(")[0]
                    vals[key] = float(tok)
                    break
        lat = Lattice.from_parameters(
            vals["_cell_length_a"], vals["_cell_length_b"],
            vals["_cell_length_c"], vals["_cell_angle_alpha"],
            vals["_cell_angle_beta"], vals["_cell_angle_gamma"])
        lines = text.splitlines()
        elements, coords = [], []
        i = 0
        while i < len(lines):
            if lines[i].strip() == "loop_":
                headers = []
                j = i + 1
                while j < len(lines) and lines[j].strip().startswith("_"):
                    headers.append(lines[j].strip())
                    j += 1
                if any("_atom_site_fract_x" in h for h in headers):
                    col = {h: k for k, h in enumerate(headers)}
                    sym_col = None
                    for name in ("_atom_site_type_symbol", "_atom_site_label"):
                        if name in col:
                            sym_col = col[name]
                            break
                    xc = col["_atom_site_fract_x"]
                    yc = col["_atom_site_fract_y"]
                    zc = col["_atom_site_fract_z"]
                    while j < len(lines):
                        parts = lines[j].split()
                        if len(parts) < len(headers):
                            break
                        sym = "".join(c for c in parts[sym_col]
                                      if c.isalpha())[:2]
                        # legacy all-uppercase labels ("CA1", "FE1")
                        # would otherwise map Ca->C, Fe->F
                        sym = sym.capitalize()
                        if sym not in Z_FROM_SYMBOL:
                            sym = sym[:1]
                        elements.append(sym)
                        coords.append([float(parts[xc].split("(")[0]),
                                       float(parts[yc].split("(")[0]),
                                       float(parts[zc].split("(")[0])])
                        j += 1
                    break
                i = j
            else:
                i += 1
        return cls.create(lat.matrix, np.asarray(coords), elements,
                          cartesian=False)

    @classmethod
    def from_pdb(cls, path_or_str: str, box_size: float = 500.0) -> "Atoms":
        """Minimal PDB parser (ATOM/HETATM records, open boundary box)."""
        if "\n" in path_or_str:
            text = path_or_str
        else:
            with open(path_or_str) as f:
                text = f.read()
        elements, coords = [], []
        for ln in text.splitlines():
            if ln.startswith(("ATOM", "HETATM")):
                x = float(ln[30:38])
                y = float(ln[38:46])
                z = float(ln[46:54])
                sym = ln[76:78].strip() or ln[12:16].strip()[:2]
                sym = sym.capitalize()
                if sym not in Z_FROM_SYMBOL:
                    sym = sym[:1].upper()
                elements.append(sym)
                coords.append([x, y, z])
        coords = np.asarray(coords)
        lat = np.eye(3) * box_size
        coords = coords - coords.mean(axis=0) + box_size / 2.0
        return cls.create(lat, coords, elements, cartesian=True)

    @classmethod
    def from_file(cls, path: str) -> "Atoms":
        """Dispatch on filename: POSCAR/.vasp, .cif, .xyz, .pdb."""
        name = path.lower()
        if name.endswith(".cif"):
            return cls.from_cif(path)
        if name.endswith(".xyz"):
            return cls.from_xyz(path)
        if name.endswith(".pdb"):
            return cls.from_pdb(path)
        return cls.from_poscar(path)

    def __repr__(self):
        return (f"Atoms(n={self.num_atoms}, elements={self.composition}, "
                f"abc={np.round(self.lattice.abc, 3).tolist()})")


# Standard atomic masses indexed by Z (u); index 0 unused.
_ATOMIC_MASS = np.array([
    0.0,
    1.008, 4.003, 6.94, 9.012, 10.81, 12.011, 14.007, 15.999, 18.998, 20.180,
    22.990, 24.305, 26.982, 28.085, 30.974, 32.06, 35.45, 39.948, 39.098,
    40.078, 44.956, 47.867, 50.942, 51.996, 54.938, 55.845, 58.933, 58.693,
    63.546, 65.38, 69.723, 72.630, 74.922, 78.971, 79.904, 83.798, 85.468,
    87.62, 88.906, 91.224, 92.906, 95.95, 97.0, 101.07, 102.906, 106.42,
    107.868, 112.414, 114.818, 118.710, 121.760, 127.60, 126.904, 131.293,
    132.905, 137.327, 138.905, 140.116, 140.908, 144.242, 145.0, 150.36,
    151.964, 157.25, 158.925, 162.500, 164.930, 167.259, 168.934, 173.045,
    174.967, 178.49, 180.948, 183.84, 186.207, 190.23, 192.217, 195.084,
    196.967, 200.592, 204.38, 207.2, 208.980, 209.0, 210.0, 222.0, 223.0,
    226.0, 227.0, 232.038, 231.036, 238.029, 237.0, 244.0, 243.0, 247.0,
    247.0, 251.0, 252.0, 257.0, 258.0, 259.0, 262.0,
])


def atomic_masses() -> np.ndarray:
    """Atomic mass table indexed by Z (for MD)."""
    return _ATOMIC_MASS


def dumpjson(data, filename):
    """Write `data` as indented JSON (the FF tasks' artifacts)."""
    with open(filename, "w") as f:
        json.dump(data, f, indent=2)


def loadjson(filename):
    with open(filename) as f:
        return json.load(f)
