"""The LSMS text format, which the ``unit_test`` data also uses (port of
``data/lsms.py``)::

    line 0:  graph-level features (whitespace separated)
    line i:  feature  node_index  x  y  z  output1  output2  ...

The Dataset config's ``column_index``/``dim`` tables pick the graph and
node feature blocks. The LSMS charge-density correction subtracts the
proton count (column 0 of the picked node features) from column 1.
"""

import numpy as np

from hydragnn_tpu_torch.data.dataobj import GraphData
from hydragnn_tpu_torch.data.raw import AbstractRawDataset


class LSMSDataset(AbstractRawDataset):
    def transform_input_to_data_object_base(self, filepath: str):
        with open(filepath, "r", encoding="utf-8") as f:
            lines = f.readlines()
        graph_feat = lines[0].split()
        g_feature = [
            float(graph_feat[self.graph_feature_col[item] + icomp])
            for item in range(len(self.graph_feature_dim))
            for icomp in range(self.graph_feature_dim[item])
        ]
        node_features, positions = [], []
        for line in lines[1:]:
            fields = line.split()
            if not fields:
                continue
            positions.append([float(fields[2]), float(fields[3]), float(fields[4])])
            node_features.append([
                float(fields[self.node_feature_col[item] + icomp])
                for item in range(len(self.node_feature_dim))
                for icomp in range(self.node_feature_dim[item])
            ])
        data = GraphData(
            x=np.asarray(node_features, dtype=np.float32),
            pos=np.asarray(positions, dtype=np.float32),
            y=np.asarray(g_feature, dtype=np.float32),
        )
        if data.x.shape[1] >= 2:  # charge density: x[:, 1] -= x[:, 0]
            data.x[:, 1] = data.x[:, 1] - data.x[:, 0]
        return data
