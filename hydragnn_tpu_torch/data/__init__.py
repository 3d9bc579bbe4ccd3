from hydragnn_tpu_torch.data.dataobj import GraphData
from hydragnn_tpu_torch.data.elements import SYMBOL_TO_Z, Z_TO_SYMBOL, atomic_number
from hydragnn_tpu_torch.data.extxyz import (
    frame_to_graph,
    iter_extxyz,
    load_extxyz_dir,
    read_extxyz,
    write_extxyz,
)
from hydragnn_tpu_torch.data.layout import BatchLayout, collate_for_layout
from hydragnn_tpu_torch.data.mptrj import load_mptrj, write_mptrj_json
from hydragnn_tpu_torch.data.qm9_raw import QM9RawDataset, write_qm9_sdf
from hydragnn_tpu_torch.data.radius_graph import radius_graph, radius_graph_pbc

__all__ = [
    "BatchLayout", "GraphData", "QM9RawDataset", "SYMBOL_TO_Z", "Z_TO_SYMBOL",
    "atomic_number", "collate_for_layout", "frame_to_graph", "iter_extxyz",
    "load_extxyz_dir", "load_mptrj", "radius_graph", "radius_graph_pbc", "read_extxyz",
    "write_extxyz", "write_mptrj_json", "write_qm9_sdf",
]
