"""Real-format QM9 ingestion, without torch_geometric or rdkit (port of
``data/qm9_raw.py``).

Reads the actual QM9 distribution in either of its two public layouts:

1. **PyG raw layout** — ``gdb9.sdf`` (3-D structures, MDL V2000 blocks) +
   ``gdb9.sdf.csv`` (19 properties per molecule) + ``uncharacterized.txt``
   (3054 failed-consistency indices to skip). This is what
   ``torch_geometric.datasets.QM9`` downloads and what the reference's
   ``examples/qm9/qm9.py:55-57`` consumes via its ``pre_transform``
   (HydraGNN's ``examples/qm9/qm9.py:15-22``).
2. **Original Ramakrishnan layout** — a directory of ``dsgdb9nsd_*.xyz``
   files, properties on the comment line, ``*^`` float exponents.

Targets reproduce PyG's ``y`` exactly — same column order
(mu, alpha, homo, lumo, gap, r2, zpve, U0, U298, H298, G298, Cv,
U0_atom, U298_atom, H298_atom, G298_atom, A, B, C) and same unit
conversions (Hartree -> eV, kcal/mol -> eV) — so ``y[10]`` is the free
energy the reference example trains on and MAEs are comparable number for
number.
"""

import csv
import os
from typing import List, Optional, Sequence

import numpy as np

from hydragnn_tpu_torch.data.dataobj import GraphData
from hydragnn_tpu_torch.data.elements import atomic_number
from hydragnn_tpu_torch.data.radius_graph import radius_graph

HAR2EV = 27.211386246
KCALMOL2EV = 0.04336414

# names for the 19 PyG-ordered targets; index 10 = g298 (free energy)
TARGET_NAMES = [
    "mu", "alpha", "homo", "lumo", "gap", "r2", "zpve",
    "u0", "u298", "h298", "g298", "cv",
    "u0_atom", "u298_atom", "h298_atom", "g298_atom",
    "A", "B", "C",
]

# per-column unit conversion in PyG order (PyG QM9 `conversion` vector)
_CONVERSION = np.array(
    [1.0, 1.0, HAR2EV, HAR2EV, HAR2EV, 1.0, HAR2EV, HAR2EV, HAR2EV,
     HAR2EV, HAR2EV, 1.0, KCALMOL2EV, KCALMOL2EV, KCALMOL2EV,
     KCALMOL2EV, 1.0, 1.0, 1.0],
    dtype=np.float64,
)


def parse_sdf_v2000(text: str):
    """Parse an MDL SDF string into [(symbols, pos[n,3], bonds[m,2])].

    Fixed-width counts line (3+3 chars) with a whitespace fallback; bond
    atom indices returned 0-based. Property blocks between molecules are
    skipped; molecules are delimited by ``$$$$``.
    """
    mols = []
    for block in text.split("$$$$"):
        lines = block.strip("\n").split("\n")
        # skip leading blank lines left by the delimiter
        while lines and not lines[0].strip():
            lines = lines[1:]
        if len(lines) < 4:
            continue
        counts = lines[3]
        try:
            natoms = int(counts[0:3])
            nbonds = int(counts[3:6])
        except ValueError:
            fields = counts.split()
            natoms, nbonds = int(fields[0]), int(fields[1])
        symbols, pos = [], []
        for ln in lines[4 : 4 + natoms]:
            fields = ln.split()
            pos.append([float(fields[0]), float(fields[1]), float(fields[2])])
            symbols.append(fields[3])
        bonds = []
        for ln in lines[4 + natoms : 4 + natoms + nbonds]:
            try:
                a, b = int(ln[0:3]), int(ln[3:6])
            except ValueError:
                fields = ln.split()
                a, b = int(fields[0]), int(fields[1])
            bonds.append([a - 1, b - 1])
        mols.append(
            (
                symbols,
                np.asarray(pos, dtype=np.float32),
                np.asarray(bonds, dtype=np.int64).reshape(-1, 2),
            )
        )
    return mols


def read_gdb9_csv(path: str) -> np.ndarray:
    """``gdb9.sdf.csv`` -> [N, 19] float64 targets in PyG order with PyG
    unit conversions applied. CSV columns are
    mol_id, A, B, C, mu..cv, u0_atom..g298_atom; PyG reorders to put the
    rotational constants last (``y = cat([y[:, 3:], y[:, :3]])``)."""
    rows = []
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        if not header[0].lower().startswith("mol"):
            # explicit raise (not assert): must survive python -O, or a
            # wrong-format file parses silently with misaligned targets
            raise ValueError(f"unexpected gdb9 csv header {header[:2]}")
        for rec in reader:
            if not rec:
                continue
            vals = np.asarray([float(v) for v in rec[1:20]], dtype=np.float64)
            rows.append(np.concatenate([vals[3:], vals[:3]]))
    return np.asarray(rows, dtype=np.float64) * _CONVERSION


def read_uncharacterized(path: str) -> List[int]:
    """0-based indices of molecules to skip. The real file is a 9-line
    banner, then ``   <index>  <name> ...`` rows, then a 2-line tail
    (count summary) — PyG slices ``[9:-2]`` and so do we; within that
    window, rows whose first token isn't an integer are ignored."""
    skips = []
    with open(path) as f:
        lines = f.read().split("\n")
    for ln in lines[9:-2]:
        tok = ln.split()
        if tok:
            try:
                skips.append(int(tok[0]) - 1)
            except ValueError:
                continue
    return skips


def _float_fortran(s: str) -> float:
    """QM9 xyz files use Fortran-ish '*^' exponents (1.23*^-4)."""
    return float(s.replace("*^", "e"))


def parse_dsgdb9nsd_xyz(path: str):
    """One ``dsgdb9nsd_*.xyz`` file -> (symbols, pos, y19).

    Comment line: ``gdb <id> A B C mu alpha homo lumo gap r2 zpve U0 U H G
    Cv``. Only 15 properties exist in this layout; the four atomization
    energies are absent and returned as NaN (PyG computes them from the sdf
    csv, which carries them precomputed).
    """
    with open(path) as f:
        lines = f.read().split("\n")
    natoms = int(lines[0].split()[0])
    props = lines[1].split()
    # props[0]='gdb', props[1]=index, props[2:17]=A..Cv
    raw = np.asarray([_float_fortran(v) for v in props[2:17]], dtype=np.float64)
    a_b_c, rest = raw[:3], raw[3:]  # mu..Cv (12 values)
    y = np.full(19, np.nan, dtype=np.float64)
    y[:12] = rest
    y[16:19] = a_b_c
    y[:12] *= _CONVERSION[:12]
    symbols, pos = [], []
    for ln in lines[2 : 2 + natoms]:
        fields = ln.split()
        symbols.append(fields[0])
        pos.append([_float_fortran(v) for v in fields[1:4]])
    return symbols, np.asarray(pos, dtype=np.float32), y


class QM9RawDataset:
    """List-like dataset of GraphData parsed from a real QM9 tree.

    ``root`` may contain ``gdb9.sdf`` (+ ``gdb9.sdf.csv``,
    ``uncharacterized.txt``) or a set of ``dsgdb9nsd_*.xyz`` files.
    ``target_index`` selects one PyG-ordered property as the graph target
    (default 10 = free energy, the reference example's choice);
    ``per_atom=True`` divides it by the atom count
    (``data.y[:, 10] / len(data.x)``, reference ``qm9.py:19``).
    ``edges='radius'`` builds radius graphs (our pipeline recomputes edge
    structure, like the reference's serialized loader); ``'bonds'`` keeps
    the SDF bond list as undirected edges (PyG-QM9 semantics).
    """

    def __init__(
        self,
        root: str,
        target_index: int = 10,
        per_atom: bool = True,
        edges: str = "radius",
        radius: float = 7.0,
        max_neighbours: int = 5,
        num_samples: Optional[int] = None,
    ):
        self.samples: List[GraphData] = []
        sdf = os.path.join(root, "gdb9.sdf")
        if os.path.exists(sdf):
            mols = parse_sdf_v2000(open(sdf).read())
            targets = read_gdb9_csv(sdf + ".csv")
            skip_path = os.path.join(root, "uncharacterized.txt")
            skips = set(
                read_uncharacterized(skip_path)
                if os.path.exists(skip_path)
                else []
            )
            if len(mols) != targets.shape[0]:
                raise ValueError(
                    f"sdf has {len(mols)} molecules but csv has "
                    f"{targets.shape[0]} rows — misaligned inputs"
                )
            it = (
                (i, syms, pos, bonds, targets[i])
                for i, (syms, pos, bonds) in enumerate(mols)
            )
        else:
            files = sorted(
                f for f in os.listdir(root)
                if f.startswith("dsgdb9nsd_") and f.endswith(".xyz")
            )
            if not files:
                raise FileNotFoundError(
                    f"no gdb9.sdf and no dsgdb9nsd_*.xyz under {root!r}"
                )
            skips = set()

            def _gen():
                for i, fn in enumerate(files):
                    syms, pos, y = parse_dsgdb9nsd_xyz(os.path.join(root, fn))
                    yield i, syms, pos, np.zeros((0, 2), np.int64), y

            it = _gen()

        for i, syms, pos, bonds, y in it:
            if i in skips:
                continue
            if num_samples is not None and len(self.samples) >= num_samples:
                break
            z = np.asarray([atomic_number(s) for s in syms], dtype=np.float32)
            d = GraphData(x=z.reshape(-1, 1), pos=pos, y=y.astype(np.float32))
            if edges == "bonds" and bonds.size:
                und = np.concatenate([bonds, bonds[:, ::-1]], axis=0)
                d.edge_index = und.T.astype(np.int64)
            else:
                d.edge_index = radius_graph(pos, radius, max_neighbours)
            t = float(y[target_index])
            if per_atom:
                t /= len(z)
            d.targets = [np.asarray([t], dtype=np.float32)]
            d.target_types = ["graph"]
            self.samples.append(d)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]

    def __iter__(self):
        return iter(self.samples)


def write_qm9_sdf(
    root: str,
    molecules: Sequence,
    targets: np.ndarray,
    skips: Sequence[int] = (),
):
    """Write (symbols, pos) molecules + a [N,19] RAW-unit target table in
    the exact gdb9 layout (sdf + csv + uncharacterized.txt). Used by the
    offline example to materialize its synthetic molecules in the real
    format so the real parser is the one code path; also handy for tests.
    ``targets`` must be in CSV (raw) units and CSV column order
    (A,B,C,mu..cv,u0_atom..g298_atom) — exactly what the file stores.
    """
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "gdb9.sdf"), "w") as f:
        for mi, (symbols, pos) in enumerate(molecules):
            f.write(f"gdb_{mi + 1}\n  written by hydragnn_tpu\n\n")
            f.write(f"{len(symbols):3d}{0:3d}  0  0  0  0  0  0  0  0999 V2000\n")
            for s, p in zip(symbols, pos):
                f.write(
                    f"{p[0]:10.4f}{p[1]:10.4f}{p[2]:10.4f} {s:<3s}"
                    " 0  0  0  0  0  0  0  0  0  0  0  0\n"
                )
            f.write("M  END\n$$$$\n")
    cols = ["mol_id", "A", "B", "C", "mu", "alpha", "homo", "lumo", "gap",
            "r2", "zpve", "u0", "u298", "h298", "g298", "cv",
            "u0_atom", "u298_atom", "h298_atom", "g298_atom"]
    with open(os.path.join(root, "gdb9.sdf.csv"), "w") as f:
        f.write(",".join(cols) + "\n")
        for mi, row in enumerate(np.asarray(targets, dtype=np.float64)):
            f.write(
                f"gdb_{mi + 1}," + ",".join(f"{v:.8g}" for v in row) + "\n"
            )
    with open(os.path.join(root, "uncharacterized.txt"), "w") as f:
        f.write("\n" * 9)  # banner lines, as in the real file
        for s in skips:
            f.write(f"  {int(s) + 1}  dummy\n")
        # tail line, as in the real file (with the trailing newline it
        # occupies the [-2:] slice read_uncharacterized excludes)
        f.write(f"{len(list(skips))} compounds\n")
