"""ctypes binding for the GraphPack shard format (port of
``native/graphpack.py``; the format is ``graphpack.cpp``'s, the same file
in both packages, so a shard written by either reads in the other byte for
byte).

Low-level API: ``PackWriter`` serializes {name: (array, counts)} variables to
one shard file; ``PackReader`` memory-maps it back. ``read`` copies one
sample's slice out (writeable); ``read_all`` returns a read-only view into
the mmap, valid while the reader is open: copy it before handing it to
anything that writes or pins memory (``torch.from_numpy``, a pinned
buffer). The dataset-level API (multi-shard, GraphData in/out) lives in
``hydragnn_tpu_torch/data/shard_store.py``.
"""

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np

from hydragnn_tpu_torch.native.build import load_library

_DTYPES = {
    np.dtype(np.float32): 0,
    np.dtype(np.float64): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.int64): 3,
    np.dtype(np.uint8): 4,
}
_NP_DTYPES = {v: k for k, v in _DTYPES.items()}

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = load_library("graphpack", ["graphpack.cpp"])
    lib.gpk_writer_create.restype = ctypes.c_void_p
    lib.gpk_writer_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.gpk_writer_add_var.restype = ctypes.c_int
    lib.gpk_writer_add_var.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_uint32,
        ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_void_p,
        ctypes.c_uint64,
    ]
    lib.gpk_writer_finish.restype = ctypes.c_int
    lib.gpk_writer_finish.argtypes = [ctypes.c_void_p]
    lib.gpk_writer_abort.argtypes = [ctypes.c_void_p]
    lib.gpk_open.restype = ctypes.c_void_p
    lib.gpk_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.gpk_close.argtypes = [ctypes.c_void_p]
    lib.gpk_num_samples.restype = ctypes.c_uint64
    lib.gpk_num_samples.argtypes = [ctypes.c_void_p]
    lib.gpk_num_vars.restype = ctypes.c_uint32
    lib.gpk_num_vars.argtypes = [ctypes.c_void_p]
    lib.gpk_var_name.restype = ctypes.c_char_p
    lib.gpk_var_name.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.gpk_var_dtype.restype = ctypes.c_uint32
    lib.gpk_var_dtype.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.gpk_var_ndim.restype = ctypes.c_uint32
    lib.gpk_var_ndim.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.gpk_var_dims.argtypes = [
        ctypes.c_void_p,
        ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.gpk_sample_ptr.restype = ctypes.c_void_p
    lib.gpk_sample_ptr.argtypes = [
        ctypes.c_void_p,
        ctypes.c_uint32,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.gpk_var_ptr.restype = ctypes.c_void_p
    lib.gpk_var_ptr.argtypes = [
        ctypes.c_void_p,
        ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.gpk_var_index.restype = ctypes.POINTER(ctypes.c_int64)
    lib.gpk_var_index.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    _lib = lib
    return lib


class PackWriter:
    """Writes one shard: variables are either variable-first-dim (per-sample
    ``counts``) or fixed-shape ``[num_samples, ...]``."""

    def __init__(self, path: str, num_samples: int):
        self._lib = _load()
        self._h = self._lib.gpk_writer_create(path.encode(), num_samples)
        if not self._h:
            raise OSError(f"cannot create {path}")
        self.num_samples = num_samples
        self._keepalive = []

    def add(
        self,
        name: str,
        data: np.ndarray,
        counts: Optional[np.ndarray] = None,
    ):
        """``counts is None``: fixed var, data is [num_samples, *per_sample];
        the stored dims are the per-sample shape. Else: variable var, data is
        the concatenation along dim 0 and ``counts[i]`` the per-sample
        extent; stored dims are ``(-1, *trailing)``."""
        data = np.ascontiguousarray(data)
        if data.dtype not in _DTYPES:
            raise TypeError(f"unsupported dtype {data.dtype} for {name}")
        if counts is not None:
            counts = np.ascontiguousarray(counts, dtype=np.int64)
            assert counts.shape == (self.num_samples,)
            assert int(counts.sum()) == data.shape[0], (
                f"{name}: counts sum {counts.sum()} != rows {data.shape[0]}"
            )
            dims = [-1] + list(data.shape[1:])
            cptr = counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
            self._keepalive.append(counts)
        else:
            assert data.shape[0] == self.num_samples, (
                f"{name}: fixed var must lead with num_samples"
            )
            dims = list(data.shape[1:]) or [1]
            cptr = None
        dims_arr = (ctypes.c_int64 * len(dims))(*dims)
        self._keepalive.append(data)
        rc = self._lib.gpk_writer_add_var(
            self._h,
            name.encode(),
            _DTYPES[data.dtype],
            len(dims),
            dims_arr,
            cptr,
            data.ctypes.data_as(ctypes.c_void_p),
            data.nbytes,
        )
        if rc != 0:
            raise ValueError(f"gpk_writer_add_var({name}) failed: {rc}")

    def finish(self):
        rc = self._lib.gpk_writer_finish(self._h)
        self._h = None
        self._keepalive = []
        if rc != 0:
            raise OSError(f"gpk_writer_finish failed: {rc}")

    def abort(self):
        if self._h:
            self._lib.gpk_writer_abort(self._h)
            self._h = None


class PackReader:
    def __init__(self, path: str, preload: bool = False):
        self._lib = _load()
        self._h = self._lib.gpk_open(path.encode(), int(preload))
        if not self._h:
            raise OSError(f"cannot open GraphPack shard {path}")
        self.path = path
        self.num_samples = int(self._lib.gpk_num_samples(self._h))
        self.vars: Dict[str, Tuple[int, int, Tuple[int, ...]]] = {}
        for i in range(int(self._lib.gpk_num_vars(self._h))):
            name = self._lib.gpk_var_name(self._h, i).decode()
            dt = int(self._lib.gpk_var_dtype(self._h, i))
            nd = int(self._lib.gpk_var_ndim(self._h, i))
            dims = (ctypes.c_int64 * nd)()
            self._lib.gpk_var_dims(self._h, i, dims)
            self.vars[name] = (i, dt, tuple(int(d) for d in dims))

    def read(self, name: str, sample: int) -> np.ndarray:
        """Copy one sample's slice out as a numpy array."""
        vi, dt, dims = self.vars[name]
        rows = ctypes.c_int64()
        nbytes = ctypes.c_uint64()
        ptr = self._lib.gpk_sample_ptr(
            self._h, vi, sample, ctypes.byref(rows), ctypes.byref(nbytes)
        )
        if not ptr:
            raise IndexError(f"{name}[{sample}]")
        shape = (int(rows.value),) + dims[1:]
        view = np.ctypeslib.as_array(
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
            shape=(int(nbytes.value),),
        )
        # single copy out of the mmap, already writeable for downstream use
        return view.view(_NP_DTYPES[dt]).reshape(shape).copy()

    def sample_rows(self, name: str, sample: int) -> int:
        """Row count of one sample WITHOUT copying its payload (index-only
        lookup) — lets size scans over huge stores skip the data reads."""
        vi, _dt, _dims = self.vars[name]
        rows = ctypes.c_int64()
        nbytes = ctypes.c_uint64()
        ptr = self._lib.gpk_sample_ptr(
            self._h, vi, sample, ctypes.byref(rows), ctypes.byref(nbytes)
        )
        if not ptr:
            raise IndexError(f"{name}[{sample}]")
        return int(rows.value)

    def read_all(self, name: str) -> np.ndarray:
        """The whole concatenated blob, zero-copy view into the mmap."""
        vi, dt, dims = self.vars[name]
        nbytes = ctypes.c_uint64()
        ptr = self._lib.gpk_var_ptr(self._h, vi, ctypes.byref(nbytes))
        arr = np.ctypeslib.as_array(
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
            shape=(int(nbytes.value),),
        ).view(_NP_DTYPES[dt])
        # variable-dim vars concatenate samples along dim 0; fixed-shape vars
        # store dims as the per-sample shape, so samples stack in front of it
        if dims and dims[0] == -1:
            arr = arr.reshape((-1,) + dims[1:])
        else:
            arr = arr.reshape((-1,) + dims)
        # NOTE: view into the mmap — valid only while this reader is open;
        # the dataset layer holds the reader for its lifetime.
        arr.flags.writeable = False
        return arr

    def counts(self, name: str) -> Optional[np.ndarray]:
        vi, dt, dims = self.vars[name]
        if dims[0] != -1:
            return None
        ptr = self._lib.gpk_var_index(self._h, vi)
        return np.ctypeslib.as_array(ptr, shape=(self.num_samples,)).copy()

    def close(self):
        if self._h:
            self._lib.gpk_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
