"""Real-format MPtrj ingestion, without pymatgen or jarvis (port of
``data/mptrj.py``).

The MPtrj distribution (``MPtrj_2022.9_full.json``) is one JSON object:
``{mp_id: {frame_id: record}}`` where each record carries a pymatgen
``Structure`` dict (lattice matrix + sites with fractional/cartesian
coordinates and species), plus ``energy_per_atom`` /
``corrected_total_energy``, ``force`` [n,3], ``stress`` [3,3], ``magmom``
[n]. The reference parses it with pymatgen + jarvis
(HydraGNN's ``examples/mptrj/train.py:33-36,100-118``); this module
reads the same schema directly.

Graph construction mirrors the reference: **non-periodic** radius graph at
5.0 A capped at 50 neighbours (``train.py:67`` — the reference deliberately
uses ``RadiusGraph``, not the PBC variant, on these bulk frames), energy as
the graph target, forces as the node target, frames with max force norm
above 100 eV/A dropped (``train.py:74``).
"""

import json
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from hydragnn_tpu_torch.data.dataobj import GraphData
from hydragnn_tpu_torch.data.elements import atomic_number
from hydragnn_tpu_torch.data.radius_graph import radius_graph


def structure_from_dict(s: dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """pymatgen ``Structure.as_dict()`` -> (z [n], pos_cartesian [n,3],
    lattice [3,3]). Sites may carry ``xyz`` (cartesian) directly; otherwise
    cartesian = frac @ lattice_matrix (pymatgen row-vector convention)."""
    lattice = np.asarray(s["lattice"]["matrix"], dtype=np.float64)
    zs, pos = [], []
    for site in s["sites"]:
        species = site["species"]
        # dominant species on the site (occu-weighted argmax)
        el = max(species, key=lambda sp: sp.get("occu", 1.0))["element"]
        zs.append(atomic_number(el))
        if "xyz" in site:
            pos.append(site["xyz"])
        else:
            pos.append(np.asarray(site["abc"], dtype=np.float64) @ lattice)
    return (
        np.asarray(zs, dtype=np.int64),
        np.asarray(pos, dtype=np.float64),
        lattice,
    )


def iter_mptrj_entries(path: str, chunk: int = 1 << 22) -> Iterator[tuple]:
    """Stream ``(mp_id, frames_dict)`` pairs from the top level of an
    MPtrj JSON WITHOUT loading the whole file (the real
    ``MPtrj_2022.9_full.json`` is tens of GB; ``json.load`` would exhaust
    host RAM). Incremental scan: find each top-level key, then
    ``raw_decode`` just that entry's value from a growing buffer.

    A file that ends before the top-level closing brace raises (a
    truncated download must not silently train on a partial dataset —
    ``json.load`` would have raised too). ``chunk`` is the refill size
    (small values exercise the boundary handling in tests)."""
    decoder = json.JSONDecoder()
    with open(path) as f:
        buf = f.read(chunk)

        def _fill(need_more=True):
            nonlocal buf
            data = f.read(chunk)
            if not data and need_more:
                raise ValueError(f"truncated MPtrj JSON: {path}")
            buf += data
            return bool(data)

        # opening brace
        i = buf.find("{")
        while i < 0:
            _fill()
            i = buf.find("{")
        buf = buf[i + 1 :]
        while True:
            # next key or closing brace
            while True:
                stripped = buf.lstrip(" \t\r\n,")
                if stripped[:1] in ('"', "}"):
                    buf = stripped
                    break
                if not _fill(need_more=False):
                    raise ValueError(
                        f"truncated MPtrj JSON (no closing brace): {path}"
                    )
            if buf[:1] == "}":
                return
            # parse "key":
            key, end = _decode_growing(decoder, lambda: buf, _fill)
            buf = buf[end:].lstrip(" \t\r\n")
            while buf[:1] != ":":
                _fill()
                buf = buf.lstrip(" \t\r\n")
            buf = buf[1:].lstrip(" \t\r\n")
            # parse the value (one mp_id's frames dict)
            value, end = _decode_growing(decoder, lambda: buf, _fill)
            buf = buf[end:]
            yield key, value


def _decode_growing(decoder, get_buf, fill):
    """raw_decode against a growing buffer. Distinguishes an INCOMPLETE
    value (error at/near the end of the buffer, or an unterminated string
    whose closing quote hasn't arrived) from a genuine syntax error —
    the latter re-raises immediately instead of buffering the rest of a
    tens-of-GB file. Refill size doubles per retry so a large entry costs
    O(V) re-parses of geometric prefixes (~2x total), not O(V^2/chunk)."""
    rounds = 1
    at_eof = False
    while True:
        buf = get_buf()
        # strip per attempt: refills can land right after a ':' so the
        # value starts behind fresh whitespace raw_decode won't skip
        stripped = buf.lstrip(" \t\r\n")
        lead = len(buf) - len(stripped)
        try:
            value, end = decoder.raw_decode(stripped)
            return value, lead + end
        except json.JSONDecodeError as e:
            # incomplete if the error sits inside the final (possibly
            # split) token: non-string JSON tokens — numbers, literals,
            # \uXXXX escapes — are < 16 chars, so a failure in the last 16
            # chars means "need more bytes"; split strings report
            # "Unterminated string" at the string's start. Anything
            # earlier is a genuine syntax error: re-raise with position
            # instead of buffering the rest of a tens-of-GB file.
            incomplete = (
                e.pos >= len(stripped) - 16
                or e.msg.startswith("Unterminated string")
            )
            if not incomplete:
                raise
            if at_eof:
                raise ValueError(
                    "truncated MPtrj JSON (value incomplete at EOF)"
                ) from e
            for _ in range(rounds):
                if not fill(need_more=False):
                    # EOF mid-refill: the value may have JUST completed —
                    # one final decode decides truncated vs done
                    at_eof = True
                    break
            rounds = min(rounds * 2, 64)


def iter_mptrj(
    path: str,
    energy_per_atom: bool = True,
) -> Iterator[dict]:
    """Yield flat records: ``z, pos, lattice, energy, forces, stress,
    magmom, mp_id, frame_id`` from the nested two-level JSON (streamed —
    constant memory in the number of mp_ids)."""
    for mp_id, frames in iter_mptrj_entries(path):
        for frame_id, k in frames.items():
            z, pos, lattice = structure_from_dict(k["structure"])
            if energy_per_atom:
                energy = k.get("energy_per_atom")
                if energy is None:
                    total = k.get("corrected_total_energy")
                    if total is None:
                        raise KeyError(
                            f"{mp_id}/{frame_id}: record has neither "
                            "'energy_per_atom' nor 'corrected_total_energy'"
                        )
                    energy = total / len(z)
            else:
                energy = k.get("corrected_total_energy")
                if energy is None:
                    per_atom = k.get("energy_per_atom")
                    if per_atom is None:
                        # loud failure, mirroring extxyz.frame_to_graph —
                        # a malformed record must not train on a 0.0 label
                        raise KeyError(
                            f"{mp_id}/{frame_id}: record has neither "
                            "'corrected_total_energy' nor 'energy_per_atom'"
                        )
                    energy = per_atom * len(z)
            yield {
                "mp_id": mp_id,
                "frame_id": frame_id,
                "z": z,
                "pos": pos,
                "lattice": lattice,
                "energy": float(energy),
                "forces": np.asarray(k.get("force", []), dtype=np.float64),
                "stress": np.asarray(k.get("stress", []), dtype=np.float64),
                "magmom": np.asarray(
                    k.get("magmom") if k.get("magmom") is not None else [],
                    dtype=np.float64,
                ),
            }


def load_mptrj(
    path: str,
    radius: float = 5.0,
    max_neighbours: int = 50,
    energy_per_atom: bool = True,
    forces_norm_threshold: Optional[float] = 100.0,
    num_samples: Optional[int] = None,
) -> List[GraphData]:
    """MPtrj JSON -> [GraphData] with graph energy + node forces targets."""
    out: List[GraphData] = []
    for rec in iter_mptrj(path, energy_per_atom):
        forces = rec["forces"]
        if (
            forces_norm_threshold is not None
            and forces.size
            and np.linalg.norm(forces, axis=1).max() > forces_norm_threshold
        ):
            continue
        pos = rec["pos"].astype(np.float32)
        # node features [z, x, y, z-coord] — the reference's MPtrj pipeline
        # feeds cartesian coordinates as node features alongside the atomic
        # number (HydraGNN's examples/mptrj/train.py:143,234-235 with
        # input_node_features [0,1,2,3]): an invariant MLP node head can
        # only learn a force field if directional information reaches it.
        # coordinates are centered per-frame (forces are translation
        # invariant; absolute box offsets only ill-condition the first layer)
        d = GraphData(
            x=np.concatenate(
                [
                    rec["z"].astype(np.float32).reshape(-1, 1),
                    pos - pos.mean(axis=0, keepdims=True),
                ],
                axis=1,
            ),
            pos=pos,
        )
        d.edge_index = radius_graph(pos, radius, max_neighbours)
        lengths = np.linalg.norm(pos[d.edge_index[0]] - pos[d.edge_index[1]], axis=1)
        d.edge_attr = lengths.astype(np.float32).reshape(-1, 1)
        d.targets = [np.asarray([rec["energy"]], np.float32)]
        d.target_types = ["graph"]
        if forces.size:
            d.targets.append(forces.astype(np.float32))
            d.target_types.append("node")
        d.extras["mp_id"] = rec["mp_id"]
        if rec["stress"].size:
            d.extras["stress"] = rec["stress"].astype(np.float32)
        if rec["magmom"].size:
            d.extras["magmom"] = rec["magmom"].astype(np.float32)
        out.append(d)
        if num_samples is not None and len(out) >= num_samples:
            break
    return out


def write_mptrj_json(path: str, records: List[dict]):
    """Serialize flat records (as :func:`iter_mptrj` yields) back into the
    nested MPtrj schema — lets the offline example materialize synthetic
    trajectories in the real format so the real parser is the single
    ingestion path (and gives tests a round-trip)."""
    nested: dict = {}
    for rec in records:
        lattice = np.asarray(rec["lattice"], dtype=np.float64)
        inv = np.linalg.inv(lattice)
        sites = []
        from hydragnn_tpu_torch.data.elements import symbol

        for zz, xyz in zip(rec["z"], np.asarray(rec["pos"], dtype=np.float64)):
            sites.append(
                {
                    "species": [{"element": symbol(int(zz)), "occu": 1.0}],
                    "xyz": [float(v) for v in xyz],
                    "abc": [float(v) for v in xyz @ inv],
                }
            )
        entry = {
            "structure": {
                "lattice": {"matrix": lattice.tolist()},
                "sites": sites,
            },
            "energy_per_atom": float(rec["energy"]) / (
                1 if rec.get("energy_is_per_atom", True) else len(rec["z"])
            ),
            "corrected_total_energy": float(rec["energy"])
            * (len(rec["z"]) if rec.get("energy_is_per_atom", True) else 1),
            "force": np.asarray(rec["forces"], dtype=np.float64).tolist(),
            "stress": np.asarray(rec.get("stress", np.zeros((3, 3)))).tolist(),
            "magmom": np.asarray(
                rec.get("magmom", np.zeros(len(rec["z"])))
            ).tolist(),
        }
        nested.setdefault(rec["mp_id"], {})[rec["frame_id"]] = entry
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(nested, f)
