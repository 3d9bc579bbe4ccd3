"""Per-sample pickle dataset (port of ``data/pickledataset.py``; the files
are the JAX package's, read and written by either package).

Parity with ``hydragnn/utils/pickledataset.py:15-183``: one ``.pkl`` file
per sample named ``<label>-<k>.pkl`` with a ``<label>-meta.pkl`` manifest,
optional subdirectory bucketing (``k // nmax_persubdir``,
``pickledataset.py:78-90``) so huge datasets don't melt the filesystem,
and rank-offset naming on multi-process writes (global index = local index
+ sum of earlier ranks' counts, ``pickledataset.py:145-183``) so every
process writes its own share without coordination beyond one counts
exchange.

Differences from the reference (deliberate): the meta file is a single
versioned dict (schema evolution + corruption detection) instead of six
sequential pickle records, and the cross-process counts exchange is an
all-gather over ``torch.distributed`` when a group is initialised (one
process: its own count) instead of mpi4py. Reads go through
``data.serialized.SafeUnpickler``, which builds the port's ``GraphData``
for either package's class name, so a dataset the JAX package wrote loads
without importing it.
Most workloads should prefer the GraphPack shard store
(``data/shard_store.py``) — mmap'd, zero-copy, one file per writer rank —
but this format matches the reference's on-disk granularity for
migrations that expect file-per-sample layouts.
"""

import os
import pickle
from typing import List, Optional, Sequence

from hydragnn_tpu_torch.data.dataobj import GraphData
from hydragnn_tpu_torch.data.serialized import (
    SafeUnpickler,
    extract_targets,
    select_input_node_features,
)
from hydragnn_tpu_torch.parallel.distributed import host_allgather_int
from hydragnn_tpu_torch.utils import faults
from hydragnn_tpu_torch.utils.retry import retry_io
from hydragnn_tpu_torch.utils.timers import comm_size_and_rank

_META_VERSION = 1


class SimplePickleWriter:
    """Write a locally-owned list of samples as per-sample pickle files.

    Rank 0 writes the meta manifest; every rank writes its own samples at
    the global offset derived from an allgather of local counts.
    """

    def __init__(
        self,
        dataset: Sequence,
        basedir: str,
        label: str = "total",
        minmax_node_feature=None,
        minmax_graph_feature=None,
        use_subdir: bool = False,
        nmax_persubdir: int = 10_000,
        attrs: Optional[dict] = None,
    ):
        if not isinstance(dataset, list):
            raise TypeError("SimplePickleWriter expects a list of samples")
        _, rank = comm_size_and_rank()
        counts = host_allgather_int(len(dataset))
        noffset = int(sum(counts[:rank]))
        ntotal = int(sum(counts))

        if rank == 0:
            os.makedirs(basedir, exist_ok=True)
            meta = {
                "version": _META_VERSION,
                "ntotal": ntotal,
                "use_subdir": bool(use_subdir),
                "nmax_persubdir": int(nmax_persubdir),
                "minmax_node_feature": minmax_node_feature,
                "minmax_graph_feature": minmax_graph_feature,
                "attrs": dict(attrs or {}),
            }
            with open(os.path.join(basedir, f"{label}-meta.pkl"), "wb") as f:
                pickle.dump(meta, f)
        # rank 0 created basedir; other ranks may race ahead of it
        os.makedirs(basedir, exist_ok=True)

        for i, data in enumerate(dataset):
            k = noffset + i
            path = _sample_path(basedir, label, k, use_subdir, nmax_persubdir)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as f:
                pickle.dump(data, f)
        # barrier: no rank may start reading until every rank has finished
        # writing its share (readers fetch samples owned by other ranks)
        host_allgather_int(1)


class SimplePickleDataset:
    """Lazy (or preloaded) per-sample pickle reader with subset views.

    ``var_config`` (the config's ``Variables_of_interest``) applies the
    same on-read target extraction / input-column selection as the
    reference's ``update_data_object`` (``pickledataset.py:92-103``).
    """

    def __init__(
        self,
        basedir: str,
        label: str = "total",
        subset: Optional[List[int]] = None,
        preload: bool = False,
        var_config: Optional[dict] = None,
    ):
        self.basedir = basedir
        self.label = label
        self.var_config = var_config
        meta_path = os.path.join(basedir, f"{label}-meta.pkl")

        def _read_meta():
            faults.flaky_read(meta_path)
            with open(meta_path, "rb") as f:
                return SafeUnpickler(f).load()

        meta = retry_io(_read_meta, what=meta_path)
        if not isinstance(meta, dict) or "version" not in meta:
            raise ValueError(
                f"{label}-meta.pkl is not a hydragnn_tpu pickle-dataset "
                "manifest (or predates the versioned format)"
            )
        self.ntotal = int(meta["ntotal"])
        self.use_subdir = bool(meta["use_subdir"])
        self.nmax_persubdir = int(meta["nmax_persubdir"])
        self.minmax_node_feature = meta.get("minmax_node_feature")
        self.minmax_graph_feature = meta.get("minmax_graph_feature")
        self.attrs = dict(meta.get("attrs", {}))
        self.subset = list(range(self.ntotal)) if subset is None else list(subset)
        self._cache = None
        if preload:
            self._cache = [self.read(k) for k in range(self.ntotal)]

    def setsubset(self, subset: List[int]):
        self.subset = list(subset)

    def read(self, k: int) -> GraphData:
        path = _sample_path(
            self.basedir, self.label, k, self.use_subdir, self.nmax_persubdir
        )

        def _read():
            faults.flaky_read(path)
            with open(path, "rb") as f:
                return SafeUnpickler(f).load()

        # per-sample reads hit the filesystem once per __getitem__; on
        # flaky shared mounts that's the hottest transient-OSError surface
        return self._update(retry_io(_read, what=path))

    def _update(self, data: GraphData) -> GraphData:
        if self.var_config is not None:
            extract_targets(
                self.var_config["type"],
                self.var_config["output_index"],
                self.var_config["graph_feature_dims"],
                self.var_config["node_feature_dims"],
                data,
            )
            select_input_node_features(
                self.var_config["input_node_features"], data
            )
        return data

    def __len__(self):
        return len(self.subset)

    def __getitem__(self, i: int) -> GraphData:
        k = self.subset[i]
        if self._cache is not None:
            return self._cache[k]
        return self.read(k)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def _sample_path(basedir, label, k, use_subdir, nmax_persubdir):
    fname = f"{label}-{k}.pkl"
    if use_subdir:
        return os.path.join(basedir, str(k // nmax_persubdir), fname)
    return os.path.join(basedir, fname)
