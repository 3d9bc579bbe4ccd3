"""Build and load the port's host-side C++ libraries (port of
``native/build.py``).

The sources are the port's own copies, ``hydragnn_tpu_torch/native/*.cpp``
(GraphPack shards, the distributed sample store, the region timer); the
port compiles nothing outside its package. Each library is built with
``g++ -O3 -std=c++17 -shared -fPIC`` at first use into
``build/native/<hash>/`` at the repository root (``.gitignore`` lists
``build/``), keyed by a hash of its sources and flags, so an edited source
builds anew and an unchanged one is loaded as it is. Bindings are
``ctypes`` over the sources' plain C interfaces.

The publish is process-safe: g++ writes a pid-unique temporary file that
``os.replace`` moves into place, under a lock within the process, so that
several processes building the same library cold at the same moment (test
workers, trainer processes on one host) never load a half-written file.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO_ROOT = HERE.parents[1]
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-Wall")
_LOCK = threading.Lock()


def library_path(name: str, sources, extra_flags=()) -> Path:
    """Where ``lib<name>.so`` of these sources and flags lives."""
    h = hashlib.sha256(" ".join((*FLAGS, *extra_flags)).encode())
    for s in sources:
        h.update(s.encode())
        h.update((HERE / s).read_bytes())
    return REPO_ROOT / "build" / "native" / h.hexdigest()[:16] / f"lib{name}.so"


def build_library(name: str, sources, extra_flags=()) -> str:
    """Build ``lib<name>.so`` from ``sources`` (file names in this
    directory) unless it is built already; returns its path. Raises
    ``RuntimeError`` with g++'s output when the build fails."""
    out = library_path(name, sources, extra_flags)
    with _LOCK:
        if out.exists():
            return str(out)
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", *FLAGS, *extra_flags, *(str(HERE / s) for s in sources),
               "-o", str(tmp), "-lpthread"]
        # the lock serialises the build: a second caller in this process
        # waits for the one library instead of compiling it again
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed building lib{name}.so:\n{proc.stderr}")
        os.replace(tmp, out)
    return str(out)


def load_library(name: str, sources, extra_flags=()) -> ctypes.CDLL:
    return ctypes.CDLL(build_library(name, sources, extra_flags))
