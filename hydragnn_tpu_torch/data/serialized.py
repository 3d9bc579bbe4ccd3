"""Serialized (``.pkl``) splits to training samples (port of
``data/serialized.py``).

:class:`SerializedGraphLoader` reads one pickled split, optionally rotates
each sample onto its principal axes, builds the radius graph (with
``periodic_boundary_conditions``, :func:`~hydragnn_tpu_torch.data.radius_graph.
radius_graph_pbc` over the sample's ``supercell_size``, whose image
lengths become ``edge_attr``; ``pos`` stays as it was, in the cell, so a
stack that recomputes distances from ``pos`` (SchNet, EGNN) sees the
in-cell distance there, as in the JAX package), appends the edge lengths
divided by the longest over the split, applies the optional
descriptors, extracts one target per head (:func:`extract_targets`) and
keeps the input node-feature columns (:func:`select_input_node_features`).

A pickle is read through :class:`SafeUnpickler`, which builds nothing but
numpy arrays and scalars, builtin containers and the port's ``GraphData``.
The JAX package writes the same pickles with its own ``GraphData``
(``hydragnn_tpu.data.dataobj.GraphData``, the same fields); that one name
is read as the port's class, so that a pickle of either package loads
without importing the other. Any other class is refused. The read goes
through ``utils.faults.flaky_read`` and is retried on a transient
``OSError`` (``utils.retry.retry_io``), as the JAX package's is.
"""

import pickle
from typing import List

import numpy as np

from hydragnn_tpu_torch.data.dataobj import GraphData
from hydragnn_tpu_torch.data.radius_graph import radius_graph, radius_graph_pbc
from hydragnn_tpu_torch.data.transforms import (
    add_edge_lengths,
    normalize_rotation,
    point_pair_features,
    spherical_descriptor,
)
from hydragnn_tpu_torch.utils import faults
from hydragnn_tpu_torch.utils.retry import retry_io

_GRAPH_DATA = {
    ("hydragnn_tpu_torch.data.dataobj", "GraphData"),
    ("hydragnn_tpu.data.dataobj", "GraphData"),
}
_BUILTINS = {"list", "dict", "tuple", "set", "frozenset", "int", "float", "bool", "str",
             "bytes", "complex", "slice", "range", "bytearray"}
# what numpy's pickles of arrays and scalars name
_NUMPY = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"), ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"), ("numpy._core.numeric", "_frombuffer"),
}


class SafeUnpickler(pickle.Unpickler):
    """An unpickler of serialized splits: numpy arrays, dtypes and
    scalars, builtin containers, and ``GraphData`` of either package (as
    the port's class). Raises ``pickle.UnpicklingError`` for anything
    else."""

    def find_class(self, module: str, name: str):
        if (module, name) in _GRAPH_DATA:
            return GraphData
        if module == "builtins" and name in _BUILTINS:
            return super().find_class(module, name)
        if (module, name) in _NUMPY or (module == "numpy" and name.endswith("DType")) or (
                module == "numpy.dtypes" and name.endswith("DType")):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"refusing to load {module}.{name} from a serialized dataset")


def read_serialized(path: str):
    """``(minmax_node_feature, minmax_graph_feature, samples)`` of one
    serialized split."""
    with open(path, "rb") as f:
        # one unpickler per object: each was dumped with a memo of its own
        return tuple(SafeUnpickler(f).load() for _ in range(3))


def extract_targets(output_type: List[str], output_index: List[int],
                    graph_feature_dim: List[int], node_feature_dim: List[int],
                    data: GraphData) -> GraphData:
    """One target array per head: ``[dim]`` for a graph head, ``[n, dim]``
    for a node head, cut from the packed ``y`` and ``x``."""
    targets = []
    for t, idx in zip(output_type, output_index):
        if t == "graph":
            start, dim = sum(graph_feature_dim[:idx]), graph_feature_dim[idx]
            targets.append(np.asarray(data.y[start : start + dim], np.float32).reshape(dim))
        elif t == "node":
            start, dim = sum(node_feature_dim[:idx]), node_feature_dim[idx]
            targets.append(np.asarray(data.x[:, start : start + dim], np.float32)
                           .reshape(data.num_nodes, dim))
        else:
            raise ValueError(f"Unknown output type: {t}")
    data.targets = targets
    data.target_types = list(output_type)
    return data


def select_input_node_features(input_node_features: List[int], data: GraphData) -> GraphData:
    data.x = data.x[:, input_node_features]
    return data


class SerializedGraphLoader:
    def __init__(self, config: dict):
        ds = config["Dataset"]
        arch = config["NeuralNetwork"]["Architecture"]
        voi = config["NeuralNetwork"]["Variables_of_interest"]
        self.periodic = arch.get("periodic_boundary_conditions", False)
        self.node_feature_dim = ds["node_features"]["dim"]
        self.graph_feature_dim = ds["graph_features"]["dim"]
        self.rotational_invariance = ds.get("rotational_invariance", False)
        self.radius = arch["radius"]
        self.max_neighbours = arch["max_neighbours"]
        self.variables = voi
        self.output_type = voi["type"]
        self.output_index = voi["output_index"]
        self.input_node_features = voi["input_node_features"]
        descriptors = ds.get("Descriptors", {})
        self.spherical_coordinates = descriptors.get("SphericalCoordinates", False)
        self.point_pair_features = descriptors.get("PointPairFeatures", False)

    def load_serialized_data(self, dataset_path: str) -> List[GraphData]:
        def read():
            faults.flaky_read(dataset_path)
            return read_serialized(dataset_path)[2]

        # one large read off a shared filesystem: a transient OSError is
        # retried with backoff instead of ending the job at its start
        dataset = retry_io(read, what=dataset_path)
        if self.rotational_invariance:
            dataset = [normalize_rotation(d) for d in dataset]
        for data in dataset:
            if self.periodic:
                edge_index, lengths = radius_graph_pbc(data.pos, data.supercell_size,
                                                       self.radius, self.max_neighbours)
                data.edge_index = edge_index
                data.edge_attr = lengths[:, None].astype(np.float32)
            else:
                data.edge_index = radius_graph(data.pos, self.radius, self.max_neighbours)
                data.edge_attr = None
                add_edge_lengths(data)
        max_edge_length = 0.0
        for data in dataset:
            if data.edge_attr.size:
                max_edge_length = max(max_edge_length, float(data.edge_attr.max()))
        max_edge_length = max(max_edge_length, 1e-12)
        for data in dataset:
            data.edge_attr = data.edge_attr / max_edge_length
        if self.spherical_coordinates:
            dataset = [spherical_descriptor(d) for d in dataset]
        if self.point_pair_features:
            dataset = [point_pair_features(d) for d in dataset]
        for data in dataset:
            extract_targets(self.output_type, self.output_index, self.graph_feature_dim,
                            self.node_feature_dim, data)
            select_input_node_features(self.input_node_features, data)
        if "subsample_percentage" in self.variables:
            from hydragnn_tpu_torch.data.split import stratified_subsample

            return stratified_subsample(dataset, self.variables["subsample_percentage"])
        return dataset
