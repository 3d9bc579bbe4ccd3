"""Host-side geometric transforms (port of ``data/transforms.py``).

numpy versions of the torch_geometric transforms the serialized pipeline
applies: Distance (norm=False, cat=True), NormalizeRotation, Spherical and
PointPairFeatures.
"""

import numpy as np

from hydragnn_tpu_torch.data.dataobj import GraphData


def add_edge_lengths(data: GraphData) -> GraphData:
    """Distance(norm=False, cat=True): append ||pos_j - pos_i|| to edge_attr."""
    src, dst = data.edge_index[0], data.edge_index[1]
    d = np.linalg.norm(data.pos[src] - data.pos[dst], axis=1).astype(np.float32)
    d = d[:, None]
    if data.edge_attr is None:
        data.edge_attr = d
    else:
        data.edge_attr = np.concatenate([data.edge_attr, d], axis=1)
    return data


def normalize_rotation(data: GraphData) -> GraphData:
    """Rotate positions onto their principal components (NormalizeRotation).

    Used for the ``rotational_invariance`` dataset flag.
    """
    pos = data.pos - data.pos.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(pos, full_matrices=False)
    # sign convention: make the largest-magnitude component of each axis
    # positive so the rotation is deterministic
    signs = np.sign(vt[np.arange(vt.shape[0]), np.abs(vt).argmax(axis=1)])
    signs[signs == 0] = 1.0
    vt = vt * signs[:, None]
    data.pos = (pos @ vt.T).astype(np.float32)
    return data


def spherical_descriptor(data: GraphData) -> GraphData:
    """Append (rho, theta, phi) of each edge vector, normalized like PyG's
    Spherical transform (rho by max, angles to [0, 1])."""
    src, dst = data.edge_index[0], data.edge_index[1]
    cart = data.pos[dst] - data.pos[src]
    rho = np.linalg.norm(cart, axis=1)
    rho_max = max(float(rho.max()), 1e-12) if rho.size else 1.0
    theta = np.arctan2(cart[:, 1], cart[:, 0]) / (2 * np.pi)
    theta = theta + (theta < 0)
    safe_rho = np.maximum(rho, 1e-12)
    phi = np.arccos(np.clip(cart[:, 2] / safe_rho, -1.0, 1.0)) / np.pi
    sph = np.stack([rho / rho_max, theta, phi], axis=1).astype(np.float32)
    if data.edge_attr is None:
        data.edge_attr = sph
    else:
        data.edge_attr = np.concatenate([data.edge_attr, sph], axis=1)
    return data


def point_pair_features(data: GraphData) -> GraphData:
    """PPF descriptor per edge: (||d||, angle(n_i, d), angle(n_j, d),
    angle(n_i, n_j)); requires ``data.extras['normal']``."""
    normal = data.extras.get("normal")
    if normal is None:
        raise ValueError("PointPairFeatures requires node normals")
    src, dst = data.edge_index[0], data.edge_index[1]
    d = data.pos[dst] - data.pos[src]

    def angle(a, b):
        cross = np.linalg.norm(np.cross(a, b), axis=1)
        dot = (a * b).sum(axis=1)
        return np.arctan2(cross, dot)

    feats = np.stack(
        [
            np.linalg.norm(d, axis=1),
            angle(normal[src], d),
            angle(normal[dst], d),
            angle(normal[src], normal[dst]),
        ],
        axis=1,
    ).astype(np.float32)
    if data.edge_attr is None:
        data.edge_attr = feats
    else:
        data.edge_attr = np.concatenate([data.edge_attr, feats], axis=1)
    return data
