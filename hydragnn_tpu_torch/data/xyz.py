"""The XYZ raw format (port of ``data/xyz.py``): the atom count, a comment
line (which may carry the graph targets), then ``symbol x y z [extra...]``
rows."""

import numpy as np

from hydragnn_tpu_torch.data.dataobj import GraphData
from hydragnn_tpu_torch.data.raw import AbstractRawDataset
from hydragnn_tpu_torch.data.cfg import _SYMBOLS


class XYZDataset(AbstractRawDataset):
    def transform_input_to_data_object_base(self, filepath: str):
        if not filepath.endswith(".xyz"):
            return None
        with open(filepath, "r", encoding="utf-8") as f:
            lines = f.readlines()
        natoms = int(lines[0].split()[0])
        comment = lines[1].split()
        g_feature = []
        for item in range(len(self.graph_feature_dim)):
            for icomp in range(self.graph_feature_dim[item]):
                col = self.graph_feature_col[item] + icomp
                g_feature.append(float(comment[col]) if col < len(comment) else 0.0)
        pos = []
        feats = []
        for ln in lines[2 : 2 + natoms]:
            fields = ln.split()
            z = _SYMBOLS.get(fields[0], 0) if not _is_num(fields[0]) else float(
                fields[0]
            )
            pos.append([float(fields[1]), float(fields[2]), float(fields[3])])
            row_all = [float(z)] + [float(v) for v in fields[1:]]
            row = []
            for item in range(len(self.node_feature_dim)):
                for icomp in range(self.node_feature_dim[item]):
                    col = self.node_feature_col[item] + icomp
                    row.append(row_all[col] if col < len(row_all) else 0.0)
            feats.append(row)
        return GraphData(
            x=np.asarray(feats, dtype=np.float32),
            pos=np.asarray(pos, dtype=np.float32),
            y=np.asarray(g_feature, dtype=np.float32),
        )


def _is_num(s):
    try:
        float(s)
        return True
    except ValueError:
        return False
