"""Extended-XYZ reader and writer without ase (port of ``data/extxyz.py``).

The OC20 raw S2EF/IS2RE distribution ships periodic structures as
``.extxyz`` frames (plus ``.txt`` sidecars with system metadata); the
reference ingests them through ``ase.io`` + ``AtomsToGraphs``
(HydraGNN's ``examples/open_catalyst_2020/utils/atoms_to_graphs.py:26``).
This module is the ase-free equivalent, in the same spirit as the in-repo
CFG parser: a comment-line grammar of ``key=value`` pairs (values may be
quoted), a ``Properties=name:type:ncols:...`` column spec for the per-atom
table, and ``Lattice="ax ay az bx ... cz"`` row-major cell vectors.

``frame_to_graph`` then plays the role of ``AtomsToGraphs.convert``:
radius graph (PBC-aware when the frame has a lattice), energy (optionally
per atom), forces, edge lengths as edge_attr.
"""

import os
import re
from typing import Dict, Iterator, List, Optional

import numpy as np

from hydragnn_tpu_torch.data.dataobj import GraphData
from hydragnn_tpu_torch.data.elements import atomic_number, symbol
from hydragnn_tpu_torch.data.radius_graph import radius_graph, radius_graph_pbc

_TOKEN = re.compile(
    r"""([A-Za-z_][A-Za-z0-9_:-]*)         # key
        \s*=\s*
        ("[^"]*"|'[^']*'|\S+)              # quoted or bare value
    """,
    re.VERBOSE,
)

_TYPE = {"S": str, "R": float, "I": int, "L": lambda s: s in ("T", "True", "1")}


def _parse_comment(line: str) -> Dict[str, object]:
    out = {}
    for key, raw in _TOKEN.findall(line):
        v = raw.strip()
        if v and v[0] in "\"'":
            v = v[1:-1]
        out[key] = v
    return out


def _parse_properties(spec: str):
    """``species:S:1:pos:R:3:forces:R:3`` -> [(name, caster, ncols), ...]"""
    fields = spec.split(":")
    cols = []
    for i in range(0, len(fields), 3):
        name, typ, n = fields[i], fields[i + 1], int(fields[i + 2])
        cols.append((name, _TYPE[typ], n))
    return cols


def iter_extxyz(path: str) -> Iterator[dict]:
    """Yield frames as dicts:
    ``symbols`` [n], ``z`` [n], ``pos`` [n,3], ``cell`` [3,3] or None,
    ``pbc`` [3] bool, ``info`` (remaining comment keys, floats where they
    parse), ``arrays`` (extra per-atom columns, e.g. forces)."""
    with open(path) as f:
        iframe = 0
        while True:
            header = f.readline()
            if not header:
                return
            if not header.strip():
                continue
            try:
                yield _parse_frame(f, header)
            except Exception as e:
                raise ValueError(
                    f"{path}: malformed extxyz frame {iframe}: {e}"
                ) from e
            iframe += 1


def _parse_frame(f, header: str) -> dict:
    natoms = int(header.split()[0])
    comment = f.readline()
    kv = _parse_comment(comment)
    spec = kv.pop("Properties", "species:S:1:pos:R:3")
    columns = _parse_properties(str(spec))
    ncols_expected = sum(n for _, _, n in columns)
    cell = None
    if "Lattice" in kv:
        cell = np.fromstring(str(kv.pop("Lattice")), sep=" ").reshape(3, 3)
    pbc = np.array([False] * 3)
    if "pbc" in kv:
        pbc = np.array(
            [t in ("T", "True", "1") for t in str(kv.pop("pbc")).split()]
        )
    elif cell is not None:
        pbc = np.array([True] * 3)
    info = {}
    for k, v in kv.items():
        try:
            info[k] = float(v)  # type: ignore[arg-type]
        except (TypeError, ValueError):
            info[k] = v
    data: Dict[str, list] = {name: [] for name, _, _ in columns}
    for iatom in range(natoms):
        line = f.readline()
        if not line:
            raise ValueError(
                f"file ends inside atom table (atom {iatom} of {natoms})"
            )
        fields = line.split()
        if len(fields) < ncols_expected:
            raise ValueError(
                f"atom {iatom}: {len(fields)} columns, Properties spec "
                f"needs {ncols_expected}"
            )
        at = 0
        for name, caster, n in columns:
            data[name].append([caster(x) for x in fields[at : at + n]])
            at += n
    symbols = [row[0] for row in data.pop("species")]
    pos = np.asarray(data.pop("pos"), dtype=np.float64)
    # numeric columns (R/I/L) become float arrays; string-typed extras (any
    # Properties ...:S:n besides species) stay as object arrays instead of
    # crashing a legitimate file on float64 coercion
    numeric = {name for name, caster, _ in columns if caster is not str}
    arrays = {}
    for k, v in data.items():
        if k in ("species", "pos"):
            continue
        if k in numeric:
            a = np.asarray(v, dtype=np.float64)
            arrays[k] = a.squeeze(-1) if a.shape[-1] == 1 else a
        else:
            a = np.asarray(v, dtype=object)
            arrays[k] = a.squeeze(-1) if a.shape[-1] == 1 else a
    return {
        "symbols": symbols,
        "z": np.asarray([atomic_number(s) for s in symbols], np.int64),
        "pos": pos,
        "cell": cell,
        "pbc": pbc,
        "info": info,
        "arrays": arrays,
    }


def read_extxyz(path: str) -> List[dict]:
    return list(iter_extxyz(path))


def write_extxyz(path: str, frames, append: bool = False):
    """Write frames (dicts shaped like :func:`iter_extxyz` yields, with
    ``z`` or ``symbols``; optional ``cell``, ``info``, ``arrays``)."""
    mode = "a" if append else "w"
    with open(path, mode) as f:
        for fr in frames:
            syms = fr.get("symbols") or [symbol(int(zz)) for zz in fr["z"]]
            pos = np.asarray(fr["pos"], dtype=np.float64)
            n = len(syms)
            parts = []
            if fr.get("cell") is not None:
                cell = np.asarray(fr["cell"], dtype=np.float64).reshape(3, 3)
                parts.append(
                    'Lattice="' + " ".join(f"{v:.8f}" for v in cell.ravel()) + '"'
                )
                pbc = fr.get("pbc")
                flags = (
                    "T T T"
                    if pbc is None
                    else " ".join("T" if b else "F" for b in np.asarray(pbc))
                )
                parts.append(f'pbc="{flags}"')
            props = "species:S:1:pos:R:3"
            arrays = dict(fr.get("arrays", {}))
            col_type = {}
            for k, v in arrays.items():
                v = np.asarray(v)
                ncols = 1 if v.ndim == 1 else v.shape[1]
                if v.dtype == bool:
                    col_type[k] = "L"  # extxyz logical encoding (T/F)
                elif np.issubdtype(v.dtype, np.number):
                    col_type[k] = "R"
                else:
                    col_type[k] = "S"
                props += f":{k}:{col_type[k]}:{ncols}"
            parts.insert(0, f"Properties={props}")
            for k, v in fr.get("info", {}).items():
                s = str(v)
                if any(c.isspace() for c in s):
                    s = f'"{s}"'  # quote so the round-trip survives
                parts.append(f"{k}={s}")
            f.write(f"{n}\n{' '.join(parts)}\n")
            for i in range(n):
                row = f"{syms[i]:<3s} " + " ".join(f"{c:.8f}" for c in pos[i])
                for k, v in arrays.items():
                    v = np.asarray(v)
                    vals = np.atleast_1d(v[i] if v.ndim > 1 else [v[i]])
                    t = col_type[k]
                    if t == "L":
                        row += " " + " ".join("T" if c else "F" for c in vals)
                    elif t == "S":
                        row += " " + " ".join(str(c) for c in vals)
                    else:
                        row += " " + " ".join(f"{float(c):.8f}" for c in vals)
                f.write(row + "\n")


def frame_to_graph(
    frame: dict,
    radius: float = 6.0,
    max_neighbours: int = 50,
    energy_per_atom: bool = True,
    energy_key: str = "energy",
    forces_key: str = "forces",
) -> GraphData:
    """AtomsToGraphs.convert analog: one extxyz frame -> GraphData with
    graph-level (per-atom) energy target and node-level forces target;
    edge_attr = interatomic distance (the reference's ``Distance``
    transform, norm=False)."""
    z = frame["z"].astype(np.float32).reshape(-1, 1)
    pos = frame["pos"].astype(np.float32)
    if frame.get("cell") is not None and bool(np.any(frame["pbc"])):
        # per-axis pbc mask: a slab (pbc="T T F") must not form edges
        # through the vacuum axis
        edge_index, lengths = radius_graph_pbc(
            pos.astype(np.float64), frame["cell"], radius, max_neighbours,
            pbc=frame["pbc"],
        )
    else:
        edge_index = radius_graph(pos, radius, max_neighbours)
        lengths = np.linalg.norm(
            pos[edge_index[0]] - pos[edge_index[1]], axis=1
        )
    d = GraphData(
        x=z,
        pos=pos,
        supercell_size=None
        if frame.get("cell") is None
        else np.asarray(frame["cell"], np.float32),
    )
    d.edge_index = edge_index
    d.edge_attr = np.asarray(lengths, np.float32).reshape(-1, 1)
    if energy_key not in frame["info"]:
        raise KeyError(
            f"frame has no {energy_key!r} in its comment line "
            f"(keys: {sorted(frame['info'])}); pass energy_key= to name "
            "the right one — refusing to train on silent zero labels"
        )
    energy = float(frame["info"][energy_key])
    if energy_per_atom:
        energy /= max(len(z), 1)
    d.targets = [np.asarray([energy], np.float32)]
    d.target_types = ["graph"]
    if forces_key in frame["arrays"]:
        d.targets.append(np.asarray(frame["arrays"][forces_key], np.float32))
        d.target_types.append("node")
    return d


def load_extxyz_dir(
    dirpath: Optional[str] = None,
    radius: float = 6.0,
    max_neighbours: int = 50,
    energy_per_atom: bool = True,
    forces_norm_threshold: Optional[float] = 100.0,
    num_samples: Optional[int] = None,
    files: Optional[List[str]] = None,
) -> List[GraphData]:
    """Extxyz frames -> graphs, dropping frames whose max force norm
    exceeds the threshold (the reference's ``forces_norm_threshold =
    100.0`` eV/A sanity filter, ``open_catalyst_2020/train.py:60``).

    Source is either every ``*.extxyz``/``*.xyz`` under ``dirpath`` or an
    explicit ``files`` list (the parallel-preprocessing case: each rank
    passes its nsplit share)."""
    if files is None:
        if dirpath is None:
            raise ValueError("need dirpath or files")
        files = [
            os.path.join(dirpath, fn)
            for fn in sorted(os.listdir(dirpath))
            if fn.endswith(".extxyz") or fn.endswith(".xyz")
        ]
    out: List[GraphData] = []
    for path in files:
        for frame in iter_extxyz(path):
            if forces_norm_threshold is not None and "forces" in frame["arrays"]:
                norms = np.linalg.norm(frame["arrays"]["forces"], axis=1)
                if norms.size and norms.max() > forces_norm_threshold:
                    continue
            out.append(
                frame_to_graph(
                    frame, radius, max_neighbours, energy_per_atom
                )
            )
            if num_samples is not None and len(out) >= num_samples:
                return out
    return out
