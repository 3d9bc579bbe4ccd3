"""The config's derived fields (port of ``utils/config.py``).

:func:`update_config` completes a config from its data, as the JAX
package does: the heads' output dims and types and ``num_nodes`` from the
first training sample, ``input_dim``, PNA's in-degree histogram
(``pna_deg``, :func:`gather_deg`), MFC's degree bound, the aggregation
branch the run takes (``dense_aggregation``: ``HYDRAGNN_AGG`` first, then
an explicit value, then the static policy; ``data/layout.py``),
``edge_dim``, ``equivariance``, the min-max tables for denormalised
outputs, and the defaults of the Architecture and Training sections.
:func:`get_log_name_config` names the run, :func:`save_config` writes
``./logs/<name>/config.json`` and :func:`merge_config` deep-merges two
configs. :func:`model_aggregation` is the ``aggregation`` the driver
builds the model with.
"""

import json
import os
from copy import deepcopy

import numpy as np

from hydragnn_tpu_torch.ops import autotune


def arch_for_auto_policy(nn_config: dict) -> dict:
    """The Architecture section with ``input_dim`` (CGCNN's crossover key)
    derived from ``Variables_of_interest.input_node_features`` when the
    config predates :func:`update_config`."""
    arch = nn_config["Architecture"]
    feats = nn_config.get("Variables_of_interest", {}).get("input_node_features")
    if feats and "input_dim" not in arch:
        return dict(arch, input_dim=len(feats))
    return arch


def model_aggregation() -> str:
    """The model's ``aggregation``: the one ``HYDRAGNN_AGG`` names
    (``fused`` or ``segment``), else ``segment`` (K2 for PNA, K1 for the
    rest). A batch that carries the dense lists takes the lists' branch
    whatever this is."""
    forced = autotune.env_force()
    return forced if forced in ("fused", "segment") else "segment"


def update_config(config, train_loader, val_loader, test_loader):
    from hydragnn_tpu_torch.data.layout import needs_dense_neighbors

    env = os.getenv("HYDRAGNN_USE_VARIABLE_GRAPH_SIZE")
    if env is None:
        graph_size_variable = check_if_graph_size_variable(train_loader, val_loader, test_loader)
    else:
        graph_size_variable = bool(int(env))
    ds = config.get("Dataset", {})
    if "graph_features" in ds or "node_features" in ds:
        check_output_dim_consistent(train_loader.dataset[0], config)
    config["NeuralNetwork"] = update_config_NN_outputs(
        config["NeuralNetwork"], train_loader.dataset[0], graph_size_variable)
    config = normalize_output_config(config)
    config["NeuralNetwork"]["Architecture"]["input_dim"] = len(
        config["NeuralNetwork"]["Variables_of_interest"]["input_node_features"])

    arch = config["NeuralNetwork"]["Architecture"]
    if arch["model_type"] == "PNA":
        deg = gather_deg(train_loader.dataset)
        arch["pna_deg"] = deg.tolist()
        arch["max_neighbours"] = len(deg) - 1
    else:
        arch["pna_deg"] = None
    if "dense_aggregation" not in arch and not arch.get("partition_axis"):
        # the branch the run takes, recorded so that a later run reads the
        # same layout without the environment variable
        arch["dense_aggregation"] = needs_dense_neighbors(arch)
    if arch["model_type"] == "MFC":
        arch["mfc_degree_bound"] = max_in_degree(
            ld.dataset for ld in (train_loader, val_loader, test_loader))
    for key in ("radius", "num_gaussians", "num_filters", "envelope_exponent",
                "num_after_skip", "num_before_skip", "basis_emb_size", "int_emb_size",
                "out_emb_size", "num_radial", "num_spherical"):
        arch.setdefault(key, None)
    arch = update_config_equivariance(update_config_edge_dim(arch))
    config["NeuralNetwork"]["Architecture"] = arch
    arch.setdefault("freeze_conv_layers", False)
    arch.setdefault("initial_bias", None)
    arch.setdefault("activation_function", "relu")
    arch.setdefault("SyncBatchNorm", False)
    training = config["NeuralNetwork"]["Training"]
    training.setdefault("loss_function_type", "mse")
    training.setdefault("conv_checkpointing", False)
    if "Optimizer" not in training:
        training["Optimizer"] = {"type": "AdamW", "learning_rate": 1e-3}
    return config


def update_config_equivariance(arch):
    if arch.get("equivariance"):
        if arch["model_type"] not in ("EGNN", "SchNet"):
            raise ValueError("E(3) equivariance can only be ensured for EGNN and SchNet.")
    elif "equivariance" not in arch:
        arch["equivariance"] = False
    return arch


def update_config_edge_dim(arch):
    arch["edge_dim"] = None
    if arch.get("edge_features"):
        if arch["model_type"] not in ("PNA", "CGCNN", "SchNet", "EGNN"):
            raise ValueError("Edge features can only be used with EGNN, SchNet, PNA and CGCNN.")
        arch["edge_dim"] = len(arch["edge_features"])
    elif arch["model_type"] == "CGCNN":
        arch["edge_dim"] = 0
    return arch


def check_if_graph_size_variable(train_loader, val_loader, test_loader) -> bool:
    sizes = set()
    for loader in (train_loader, val_loader, test_loader):
        for d in loader.dataset:
            sizes.add(d.num_nodes)
            if len(sizes) > 1:
                return True
    return False


def _head_dim(target) -> int:
    return int(target.shape[-1] if target.ndim > 1 else target.shape[0])


def check_output_dim_consistent(data, config):
    voi = config["NeuralNetwork"]["Variables_of_interest"]
    for ihead, (t, idx) in enumerate(zip(voi["type"], voi["output_index"])):
        table = config["Dataset"]["graph_features" if t == "graph" else "node_features"]
        if _head_dim(data.targets[ihead]) != table["dim"][idx]:
            raise ValueError(f"head {ihead}: its target's dim differs from the Dataset's")


def update_config_NN_outputs(nn_config, data, graph_size_variable: bool):
    """The heads' output dims from the first sample's targets."""
    output_type = nn_config["Variables_of_interest"]["type"]
    dims = []
    for ihead, t in enumerate(output_type):
        if t == "graph":
            dims.append(int(data.targets[ihead].shape[0]))
        elif t == "node":
            if (graph_size_variable and
                    nn_config["Architecture"]["output_heads"]["node"]["type"] == "mlp_per_node"):
                raise ValueError('"mlp_per_node" is not allowed for variable graph size')
            dims.append(int(data.targets[ihead].shape[-1]))
        else:
            raise ValueError("Unknown output type", t)
    nn_config["Architecture"]["output_dim"] = dims
    nn_config["Architecture"]["output_type"] = list(output_type)
    nn_config["Architecture"]["num_nodes"] = int(data.num_nodes)
    return nn_config


def normalize_output_config(config):
    var_config = config["NeuralNetwork"]["Variables_of_interest"]
    if var_config.get("denormalize_output"):
        if (var_config.get("minmax_node_feature") is not None
                and var_config.get("minmax_graph_feature") is not None):
            dataset_path = None
        elif list(config["Dataset"]["path"].values())[0].endswith(".pkl"):
            dataset_path = list(config["Dataset"]["path"].values())[0]
        else:
            base = os.environ.get("SERIALIZED_DATA_PATH", os.getcwd())
            suffix = "" if "total" in config["Dataset"]["path"] else "_train"
            dataset_path = f"{base}/serialized_dataset/{config['Dataset']['name']}{suffix}.pkl"
        var_config = update_config_minmax(dataset_path, var_config)
    else:
        var_config["denormalize_output"] = False
    config["NeuralNetwork"]["Variables_of_interest"] = var_config
    return config


def update_config_minmax(dataset_path, var_config):
    """The denormalisation tables ``x_minmax`` and ``y_minmax``."""
    if "minmax_node_feature" not in var_config and "minmax_graph_feature" not in var_config:
        from hydragnn_tpu_torch.data.serialized import SafeUnpickler

        with open(dataset_path, "rb") as f:
            node_minmax = SafeUnpickler(f).load()
            graph_minmax = SafeUnpickler(f).load()
    else:
        node_minmax = np.asarray(var_config["minmax_node_feature"])
        graph_minmax = np.asarray(var_config["minmax_graph_feature"])
    var_config["x_minmax"] = [node_minmax[:, i].tolist() for i in var_config["input_node_features"]]
    var_config["y_minmax"] = []
    for t, idx in zip(var_config["type"], var_config["output_index"]):
        if t not in ("graph", "node"):
            raise ValueError("Unknown output type", t)
        table = graph_minmax if t == "graph" else node_minmax
        var_config["y_minmax"].append(table[:, idx].tolist())
    return var_config


def _in_degree_counts(d) -> np.ndarray:
    return np.bincount(d.edge_index[1], minlength=d.num_nodes)


def max_in_degree(datasets) -> int:
    """The largest in-degree over every split."""
    m = 0
    for ds in datasets:
        for d in ds:
            if d.num_edges:
                m = max(m, int(_in_degree_counts(d).max()))
    return m


def gather_deg(dataset) -> np.ndarray:
    """The in-degree histogram of the dataset (PNA's scalers)."""
    max_deg = max((int(_in_degree_counts(d).max()) for d in dataset if d.num_edges), default=0)
    deg = np.zeros(max_deg + 1, dtype=np.int64)
    for d in dataset:
        deg += np.bincount(_in_degree_counts(d), minlength=max_deg + 1)
    return deg


def get_log_name_config(config) -> str:
    """The run's name, as the JAX package derives it."""
    arch = config["NeuralNetwork"]["Architecture"]
    training = config["NeuralNetwork"]["Training"]
    name = config["Dataset"]["name"]
    cut = name.rfind("_") if name.rfind("_") > 0 else None
    return (
        f"{arch['model_type']}-r-{arch.get('radius')}"
        f"-ncl-{arch['num_conv_layers']}-hd-{arch['hidden_dim']}"
        f"-ne-{training['num_epoch']}"
        f"-lr-{training['Optimizer']['learning_rate']}"
        f"-bs-{training['batch_size']}"
        f"-data-{name[:cut]}"
        "-node_ft-"
        + "".join(str(x) for x in config["NeuralNetwork"]["Variables_of_interest"]["input_node_features"])
        + "-task_weights-"
        + "".join(f"{w}-" for w in arch["task_weights"])
    )


def save_config(config, log_name: str, path: str = "./logs/"):
    fname = os.path.join(path, log_name, "config.json")
    os.makedirs(os.path.dirname(fname), exist_ok=True)
    with open(fname, "w") as f:
        json.dump(config, f, indent=4, default=str)


def merge_config(a: dict, b: dict) -> dict:
    """``b`` deep-merged into a copy of ``a``."""
    result = deepcopy(a)
    for k, v in b.items():
        if isinstance(result.get(k), dict) and isinstance(v, dict):
            result[k] = merge_config(result[k], v)
        else:
            result[k] = deepcopy(v)
    return result
