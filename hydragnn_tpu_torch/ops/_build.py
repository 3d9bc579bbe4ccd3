"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``. The
build runs at first use, from the sources in the checkout only, into
``build/kernels/<hash>/`` at the repository root (``.gitignore`` lists
``build/``). The hash covers every source and the compiler flags, so an
edited source builds anew and an unchanged one is loaded as it is. All
sources compile at once, one ``nvcc`` process each.

Pointers go to the C entries as ``ctypes.c_void_p`` (``tensor.data_ptr()``)
and so does the stream (the raw ``cudaStream_t`` of PyTorch's current
stream). Each entry returns ``cudaGetLastError()``; :func:`check` raises on
non-zero. A wrapper takes its C function from :func:`entry`, which looks it
up once per process.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCES = ("segment.cu", "fused_mp.cu", "fused_egnn.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
# argtypes of every C entry, by library
_SIGNATURES = {
    "segment": {
        # data, ids, out, E, D, S, stream
        "hg_segment_sum_f32": [_P, _P, _P, _I64, _I32, _I32, _P],
        # data, ids, out, E, D, S, out's row stride, sq_off, cnt_off, stream
        "hg_segment_moments_f32": [_P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32, _P],
        "hg_error_string": [_I32],
    },
    "fused_mp": {
        # yj, ze (nullable), mask, mask is bool, senders, receivers, out, z,
        # E, N, D, S, out's row stride, sq_off, cnt_off, stream
        "hg_fused_gather_moments_f32": [
            _P, _P, _P, _I32, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32, _I32, _P,
        ],
        # x, mask, mask is bool, senders, receivers, out, E, N, D, S,
        # out's row stride, stream
        "hg_fused_gather_sum_f32": [_P, _P, _I32, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _P],
        "hg_fused_gather_count_f32": [_P, _P, _I32, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _P],
        # h, w, senders, receivers, out, E, N, D, S, stream
        "hg_fused_gather_mul_f32": [_P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _P],
    },
    "fused_egnn": {
        # H -> dynamic shared memory bytes, or -1
        "hg_fused_egnn_smem_bytes": [_I32],
        # y_snd, y_rcv, pos, ze, mask, senders, receivers, w_rad, W2, b2,
        # Wc0, bc0, Wc1 (the last three nullable together), out,
        # E, N, H, S, out's row stride, stream
        "hg_fused_egnn_f32": [_P] * 14 + [_I64, _I32, _I32, _I32, _I32, _P],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[str, Callable] = {}
_build_log: List[str] = []


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return REPO_ROOT / "build" / "kernels" / source_hash()


def build_all() -> Path:
    """Compile every source that has no library yet, all at once; raise
    with nvcc's output when one fails. Returns the build directory."""
    out_dir = build_dir()
    todo = [s for s in SOURCES if not (out_dir / _lib_name(s)).exists()]
    if not todo:
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in todo:
        # write to a private name, then rename: a build running at the
        # same time in another process never loads a half-written library
        tmp = out_dir / f".{_lib_name(src)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )))
    failures = []
    for src, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        _build_log.append(f"== nvcc {src} (rc {proc.returncode})\n{stdout}{stderr}")
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {src} (rc {proc.returncode}):\n{stderr}")
            continue
        os.replace(tmp, out_dir / _lib_name(src))
    if failures:
        raise RuntimeError("\n".join(failures))
    return out_dir


def _lib_name(src: str) -> str:
    return f"lib{Path(src).stem}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all() / _lib_name(f"{name}.cu")
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = (
                    ctypes.c_char_p if fn == "hg_error_string" else ctypes.c_int
                )
            _libs[name] = lib
        return lib


def entry(lib: str, fn: str):
    """The C function ``fn`` of ``csrc/<lib>.cu``, its argument types set;
    built and looked up on the first call, then taken from a dict."""
    f = _entries.get(fn)
    if f is None:
        f = _entries[fn] = getattr(load(lib), fn)
    return f


def build_log() -> str:
    """nvcc's output (``-Xptxas -v``: registers, spills) of this process's
    builds; empty when the libraries were already built."""
    return "\n".join(_build_log)


def check(rc: int, what: str):
    """Raise when a C entry reported a CUDA error for its launch."""
    if rc != 0:
        msg = entry("segment", "hg_error_string")(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} at launch: {msg}")
