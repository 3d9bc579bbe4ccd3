"""GraphData — the host-side (numpy) sample container.

A copy of the JAX package's ``data/dataobj.py``: targets are kept as one
array per head (``targets`` + ``target_types``) instead of a packed
``y``/``y_loc`` layout. The port keeps its own copy so that it imports
nothing of the JAX package.
"""

from typing import List, Optional

import numpy as np


class GraphData:
    def __init__(
        self,
        x: Optional[np.ndarray] = None,
        pos: Optional[np.ndarray] = None,
        y: Optional[np.ndarray] = None,
        edge_index: Optional[np.ndarray] = None,
        edge_attr: Optional[np.ndarray] = None,
        supercell_size: Optional[np.ndarray] = None,
    ):
        self.x = x
        self.pos = pos
        self.y = y  # packed graph-level features (pre target extraction)
        self.edge_index = edge_index
        self.edge_attr = edge_attr
        self.supercell_size = supercell_size
        self.targets: List[np.ndarray] = []
        self.target_types: List[str] = []
        self.extras = {}

    @property
    def num_nodes(self) -> int:
        return 0 if self.x is None else int(self.x.shape[0])

    @property
    def num_edges(self) -> int:
        return 0 if self.edge_index is None else int(self.edge_index.shape[1])

    def clone(self) -> "GraphData":
        g = GraphData(
            x=None if self.x is None else self.x.copy(),
            pos=None if self.pos is None else self.pos.copy(),
            y=None if self.y is None else self.y.copy(),
            edge_index=None
            if self.edge_index is None
            else self.edge_index.copy(),
            edge_attr=None if self.edge_attr is None else self.edge_attr.copy(),
            supercell_size=None
            if self.supercell_size is None
            else np.asarray(self.supercell_size).copy(),
        )
        g.targets = [t.copy() for t in self.targets]
        g.target_types = list(self.target_types)
        g.extras = dict(self.extras)
        return g

    def __repr__(self):
        return (
            f"GraphData(num_nodes={self.num_nodes}, num_edges={self.num_edges},"
            f" heads={len(self.targets)})"
        )
