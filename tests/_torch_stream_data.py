"""Helper of the streaming data plane's tests (not a test module): seeded
molecule-like samples of either package's ``GraphData``, shard stores of
two families, and a tiny ``Dataset.streaming`` config. Imports neither
package at module level, so the card's tests (run without the JAX
package) can use it."""

import numpy as np

FAMILIES = (("fam_a", 1, 4, 9, 2.0), ("fam_b", 2, 6, 14, 1.0))  # name, seed, atoms [lo, hi), weight
RADIUS, MAX_NEIGHBOURS = 2.5, 8


def family_samples(graph_cls, seed, num, lo, hi, heads="graph"):
    """``num`` samples of ``lo`` to ``hi - 1`` atoms: ``x`` the atomic
    number, a radius graph (within :data:`RADIUS`, at most
    :data:`MAX_NEIGHBOURS` a node, nearest first, from numpy alone), a
    graph head (the mean atomic number) and with ``heads="graph,node"`` a
    node head (``x`` scaled)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num):
        n = int(rng.integers(lo, hi))
        pos = rng.normal(0.0, 1.2, (n, 3)).astype(np.float32)
        z = rng.choice([1.0, 6.0, 8.0], size=n).astype(np.float32)
        d = graph_cls(x=z.reshape(-1, 1), pos=pos)
        dist = np.linalg.norm(pos[:, None] - pos[None], axis=-1) + np.eye(n) * 1e9
        src, dst = [], []
        for i in range(n):
            nbr = [j for j in np.argsort(dist[i], kind="stable") if dist[i, j] <= RADIUS]
            for j in nbr[:MAX_NEIGHBOURS]:
                src.append(j)
                dst.append(i)
        d.edge_index = np.asarray([src, dst], np.int64).reshape(2, -1)
        d.targets = [np.asarray([z.mean()], np.float32)]
        d.target_types = ["graph"]
        if heads == "graph,node":
            d.targets.append((z.reshape(-1, 1) / 8.0).astype(np.float32))
            d.target_types.append("node")
        out.append(d)
    return out


def write_stores(root, writer_cls, graph_cls, num=24, train_shards=4):
    """Both families' train (``train_shards`` shards), validation and test
    stores under ``root`` (16 / 4 / 4 of ``num`` = 24). Returns
    ``{family: {split: directory}}``."""
    out = {}
    for name, seed, lo, hi, _ in FAMILIES:
        s = family_samples(graph_cls, seed, num, lo, hi)
        cut = (2 * num) // 3
        out[name] = {}
        for split, chunk, shards in (("trainset", s[:cut], train_shards),
                                     ("valset", s[cut:cut + (num - cut) // 2], 1),
                                     ("testset", s[cut + (num - cut) // 2:], 1)):
            label = str(root / f"{name}_{split}")
            for rank, part in enumerate(np.array_split(np.arange(len(chunk)), shards)):
                w = writer_cls(label, rank=rank)
                w.add([chunk[i] for i in part])
                w.save()
            out[name][split] = label
    return out


def stream_config(stores, name="streamrun", epochs=2, hidden=8, layers=2, batch=4,
                  model_type="PNA", **training):
    """A ``Dataset.streaming`` config over ``stores`` (one shard-store
    source a family, its weight from :data:`FAMILIES`)."""
    weights = {f[0]: f[4] for f in FAMILIES}
    return {
        "Verbosity": {"level": 0},
        "Dataset": {"name": name, "streaming": {
            "sources": [{"format": "shard_store", "name": fam, "train": p["trainset"],
                         "validate": p["valset"], "test": p["testset"], "weight": weights[fam]}
                        for fam, p in stores.items()],
            "window_shards": 2, "num_buckets": 2, "seed": 5}},
        "NeuralNetwork": {
            "Architecture": {
                "model_type": model_type, "radius": RADIUS, "max_neighbours": MAX_NEIGHBOURS,
                "periodic_boundary_conditions": False, "hidden_dim": hidden,
                "num_conv_layers": layers,
                "output_heads": {"graph": {"num_sharedlayers": 1, "dim_sharedlayers": 8,
                                           "num_headlayers": 1, "dim_headlayers": [8]}},
                "task_weights": [1.0]},
            "Variables_of_interest": {
                "input_node_features": [0], "output_names": ["z"], "output_index": [0],
                "type": ["graph"], "denormalize_output": False},
            "Training": {"num_epoch": epochs, "perc_train": 0.7, "loss_function_type": "mse",
                         "batch_size": batch, "resume_every": 1,
                         "Optimizer": {"type": "AdamW", "learning_rate": 1e-2}, **training}},
        "Visualization": {"create_plots": False},
    }
