"""Raw files to the serialized dataset (port of ``data/raw.py``).

:class:`AbstractRawDataset` walks each split's directory (``Dataset.path``:
``train``/``validate``/``test``, or ``total``), parses every file into a
``GraphData`` (a subclass's :meth:`~AbstractRawDataset.
transform_input_to_data_object_base`), divides the ``*_scaled_num_nodes``
features by the node count, takes the min and max of every feature block
over all splits together, scales each block to [0, 1], and pickles
``(minmax_node_feature, minmax_graph_feature, samples)`` per split as
``$SERIALIZED_DATA_PATH/serialized_dataset/<name>[_<split>].pkl`` (the
working directory when the variable is unset), as the JAX package does.
The pickles hold the port's ``GraphData``; ``data/serialized.py`` reads
them and the JAX package's.
"""

import os
import pickle
from typing import List

import numpy as np

from hydragnn_tpu_torch.data.dataobj import GraphData


def _tensor_divide(num, den):
    return np.divide(num, den, out=np.zeros_like(num), where=den != 0)


def serialized_dir() -> str:
    return os.path.join(os.environ.get("SERIALIZED_DATA_PATH", os.getcwd()),
                        "serialized_dataset")


class AbstractRawDataset:
    def __init__(self, config: dict):
        self.node_feature_name = config["node_features"]["name"]
        self.node_feature_dim = config["node_features"]["dim"]
        self.node_feature_col = config["node_features"]["column_index"]
        self.graph_feature_name = config["graph_features"]["name"]
        self.graph_feature_dim = config["graph_features"]["dim"]
        self.graph_feature_col = config["graph_features"]["column_index"]
        self.raw_dataset_name = config["name"]
        self.path_dictionary = config["path"]
        for kind in ("node", "graph"):
            names = getattr(self, f"{kind}_feature_name")
            if not (len(names) == len(getattr(self, f"{kind}_feature_dim"))
                    == len(getattr(self, f"{kind}_feature_col"))):
                raise ValueError(f"{kind}_features: name, dim and column_index differ in length")
        self.dataset_list: List[List[GraphData]] = []
        self.serial_data_name_list: List[str] = []
        self.minmax_node_feature = None
        self.minmax_graph_feature = None

    def transform_input_to_data_object_base(self, filepath: str):
        """One file's ``GraphData`` (None to skip the file)."""
        raise NotImplementedError

    def _parse_dir(self, raw_path: str) -> List[GraphData]:
        filelist = sorted(os.listdir(raw_path))
        if not filelist:
            raise ValueError(f"No data files provided in {raw_path}!")
        dataset = []
        for name in filelist:
            if name == ".DS_Store":
                continue
            full = os.path.join(raw_path, name)
            files = [full] if os.path.isfile(full) else (
                [os.path.join(full, s) for s in sorted(os.listdir(full))]
                if os.path.isdir(full) else [])
            for f in files:
                if os.path.isfile(f):
                    obj = self.transform_input_to_data_object_base(f)
                    if obj is not None:
                        dataset.append(obj)
        return dataset

    def load_raw_data(self):
        out_dir = serialized_dir()
        os.makedirs(out_dir, exist_ok=True)
        for dataset_type, raw_path in self.path_dictionary.items():
            if not os.path.isabs(raw_path):
                raw_path = os.path.join(os.getcwd(), raw_path)
            if not os.path.exists(raw_path):
                raise ValueError(f"Folder not found: {raw_path}")
            dataset = self.scale_features_by_num_nodes(self._parse_dir(raw_path))
            self.dataset_list.append(dataset)
            self.serial_data_name_list.append(
                self.raw_dataset_name + ".pkl" if dataset_type == "total"
                else f"{self.raw_dataset_name}_{dataset_type}.pkl")
        self.normalize_dataset()
        for serial_name, dataset in zip(self.serial_data_name_list, self.dataset_list):
            with open(os.path.join(out_dir, serial_name), "wb") as f:
                pickle.dump(self.minmax_node_feature, f)
                pickle.dump(self.minmax_graph_feature, f)
                pickle.dump(dataset, f)

    def scale_features_by_num_nodes(self, dataset):
        """Divide the ``*_scaled_num_nodes`` feature blocks by the node
        count."""
        g_idx = [i for i, n in enumerate(self.graph_feature_name) if "_scaled_num_nodes" in n]
        n_idx = [i for i, n in enumerate(self.node_feature_name) if "_scaled_num_nodes" in n]
        for data in dataset:
            if data.y is not None and g_idx:
                data.y[g_idx] = data.y[g_idx] / data.num_nodes
            if data.x is not None and n_idx:
                data.x[:, n_idx] = data.x[:, n_idx] / data.num_nodes
        return dataset

    def _blocks(self, dims):
        start = 0
        for ifeat, dim in enumerate(dims):
            yield ifeat, slice(start, start + dim)
            start += dim

    def normalize_dataset(self):
        """The min and max of every feature block over all splits, then
        each block scaled to [0, 1] (a constant block to 0)."""
        num_nf, num_gf = len(self.node_feature_dim), len(self.graph_feature_dim)
        self.minmax_graph_feature = np.full((2, num_gf), np.inf)
        self.minmax_node_feature = np.full((2, num_nf), np.inf)
        self.minmax_graph_feature[1, :] *= -1
        self.minmax_node_feature[1, :] *= -1
        for dataset in self.dataset_list:
            for data in dataset:
                for ifeat, sl in self._blocks(self.graph_feature_dim):
                    block = data.y[sl]
                    self.minmax_graph_feature[0, ifeat] = min(block.min(), self.minmax_graph_feature[0, ifeat])
                    self.minmax_graph_feature[1, ifeat] = max(block.max(), self.minmax_graph_feature[1, ifeat])
                for ifeat, sl in self._blocks(self.node_feature_dim):
                    block = data.x[:, sl]
                    self.minmax_node_feature[0, ifeat] = min(block.min(), self.minmax_node_feature[0, ifeat])
                    self.minmax_node_feature[1, ifeat] = max(block.max(), self.minmax_node_feature[1, ifeat])
        for dataset in self.dataset_list:
            for data in dataset:
                for ifeat, sl in self._blocks(self.graph_feature_dim):
                    lo, hi = self.minmax_graph_feature[:, ifeat]
                    data.y[sl] = _tensor_divide(data.y[sl] - lo, hi - lo)
                for ifeat, sl in self._blocks(self.node_feature_dim):
                    lo, hi = self.minmax_node_feature[:, ifeat]
                    data.x[:, sl] = _tensor_divide(data.x[:, sl] - lo, hi - lo)
