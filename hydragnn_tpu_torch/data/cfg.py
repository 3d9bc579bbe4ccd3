"""The CFG (extended AtomEye) raw format (port of ``data/cfg.py``).

Parsed directly, without ase: the particle count, the ``H0`` supercell
matrix, and per-atom rows (a mass line and a symbol line, then scaled
coordinates and auxiliary columns). Positions are the scaled coordinates
times ``H0``, which is kept as the sample's ``supercell_size`` (what
``radius_graph_pbc`` reads); graph features come from the first line of
the sibling ``.bulk`` file, zeros when there is none.
"""

import os

import numpy as np

from hydragnn_tpu_torch.data.dataobj import GraphData
from hydragnn_tpu_torch.data.raw import AbstractRawDataset

# the JAX package's table for the alloys its examples use (an unknown
# symbol reads as 0 there, and here)
_SYMBOLS = {
    "H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8,
    "F": 9, "Ne": 10, "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15,
    "S": 16, "Cl": 17, "Ar": 18, "K": 19, "Ca": 20, "Ti": 22, "V": 23,
    "Cr": 24, "Mn": 25, "Fe": 26, "Co": 27, "Ni": 28, "Cu": 29, "Zn": 30,
    "Nb": 41, "Mo": 42, "Ta": 73, "W": 74, "Re": 75, "Pt": 78, "Au": 79,
}


class CFGDataset(AbstractRawDataset):
    def transform_input_to_data_object_base(self, filepath: str):
        if not filepath.endswith(".cfg"):
            return None
        num_particles = 0
        cell = np.zeros((3, 3), dtype=np.float64)
        entry_count = 3
        rows = []
        types = []
        current_z = None
        with open(filepath, "r", encoding="utf-8") as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        i = 0
        while i < len(lines):
            ln = lines[i]
            if ln.startswith("Number of particles"):
                num_particles = int(ln.split("=")[1])
            elif ln.startswith("H0("):
                # H0(i,j) = value A
                key = ln.split("=")[0].strip()
                val = float(ln.split("=")[1].split()[0])
                r = int(key[3]) - 1
                c = int(key[5]) - 1
                cell[r, c] = val
            elif ln.startswith("entry_count"):
                entry_count = int(ln.split("=")[1])
            elif ln.startswith(("A =", ".NO_VELOCITY.", "R =", "aux")):
                pass
            else:
                fields = ln.split()
                if len(fields) == 1 and fields[0].replace(".", "").isdigit():
                    pass  # mass line
                elif len(fields) == 1:
                    current_z = _SYMBOLS.get(fields[0], 0)  # symbol line
                elif len(fields) >= 3:
                    rows.append([float(v) for v in fields])
                    types.append(current_z if current_z is not None else 0)
            i += 1

        if not rows:
            return None
        arr = np.asarray(rows, dtype=np.float64)
        scaled = arr[:, :3]
        pos = (scaled @ cell).astype(np.float32)
        aux = arr[:, 3:]
        z = np.asarray(types, dtype=np.float32)[:, None]
        full = np.concatenate([z, pos, aux], axis=1).astype(np.float32)

        node_features = []
        for item in range(len(self.node_feature_dim)):
            for icomp in range(self.node_feature_dim[item]):
                col = self.node_feature_col[item] + icomp
                node_features.append(full[:, col])
        x = np.stack(node_features, axis=1) if node_features else z

        # graph features: the first line of a sibling ".bulk" file
        y = np.zeros((sum(self.graph_feature_dim),), dtype=np.float32)
        bulk = os.path.splitext(filepath)[0] + ".bulk"
        if os.path.exists(bulk):
            with open(bulk, "r", encoding="utf-8") as f:
                graph_feat = f.readline().split()
            vals = []
            for item in range(len(self.graph_feature_dim)):
                for icomp in range(self.graph_feature_dim[item]):
                    col = self.graph_feature_col[item] + icomp
                    vals.append(float(graph_feat[col]))
            y = np.asarray(vals, dtype=np.float32)

        data = GraphData(
            x=x.astype(np.float32),
            pos=pos,
            y=y,
            supercell_size=cell,
        )
        return data
