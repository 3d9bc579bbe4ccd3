from hydragnn_tpu_torch.data.dataobj import GraphData
from hydragnn_tpu_torch.data.layout import BatchLayout, collate_for_layout

__all__ = ["BatchLayout", "GraphData", "collate_for_layout"]
