"""Kernel variants on one CUDA card: copies of the port's CUDA sources with
textual changes, built by ``nvcc`` with the port's flags, checked and timed
in turns. Shared by ``tools/moments_variants.py`` (K2, K3) and
``tools/k6_variants.py`` (K6).

A variant is a directory of the ``*.cu`` / ``*.cuh`` files of a tree's
``hydragnn_tpu_torch/csrc``, changed by substitutions: ``(file, old,
new)``, where ``old`` must occur exactly once, or ``(file, fn)``, which
maps the file's text to its new text. Variants are built under ``build/``
(gitignored).
"""

import ctypes
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from hydragnn_tpu_torch.ops import _build  # noqa: E402
from hydragnn_tpu_torch.serve import plan_from_samples  # noqa: E402
from hydragnn_tpu_torch.utils.timing import device_ms  # noqa: E402

P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def make_sources(src_dir: Path, dest: Path, subs) -> Path:
    """``dest`` emptied, filled with ``src_dir``'s kernel sources and
    changed by ``subs``; raise when an ``old`` text does not occur once."""
    if dest.exists():
        shutil.rmtree(dest)
    dest.mkdir(parents=True)
    for f in src_dir.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, dest / f.name)
    for sub in subs:
        p = dest / sub[0]
        text = p.read_text()
        if len(sub) == 2:
            p.write_text(sub[1](text))
            continue
        old, new = sub[1], sub[2]
        if text.count(old) != 1:
            raise ValueError(f"{dest.name}: {sub[0]} has {text.count(old)} copies of {old[:60]!r}")
        p.write_text(text.replace(old, new))
    return dest


def build(d: Path, src: str, kernels):
    """``nvcc`` ``d/src`` into ``d/lib<stem>.so``; returns ``(CDLL, log)``,
    the log holding ``-Xptxas -v``'s registers and spills of the entry
    functions whose names contain one of ``kernels``, and nvcc's errors."""
    lib = d / f"lib{Path(src).stem}.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(d / src)],
                         capture_output=True, text=True)
    lines, fn = [f"== nvcc {d.name}/{src} rc {res.returncode}"], ""
    for line in (res.stdout + res.stderr).splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        if any(k in fn for k in kernels) and ("registers" in line or "spill" in line):
            lines.append(f"   {fn[-64:]}: {line.strip()[-72:]}")
        elif "error" in line:
            lines.append("   " + line.strip())
    if res.returncode:
        raise RuntimeError("\n".join(lines))
    return ctypes.CDLL(str(lib)), "\n".join(lines)


def build_all(jobs, kernels):
    """:func:`build` of every ``(directory, source)`` in ``jobs`` at once,
    one nvcc process each; prints each log and returns the libraries."""
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = list(ex.map(lambda j: build(j[0], j[1], kernels), jobs))
    for _, log in built:
        print(log, flush=True)
    return [lib for lib, _ in built]


def bind(lib, signatures):
    """``{entry: function}`` for the entries of ``signatures`` that ``lib``
    has, their argument types set and an int result."""
    fns = {}
    for ent, argtypes in signatures.items():
        if hasattr(lib, ent):
            f = getattr(lib, ent)
            f.restype, f.argtypes = ctypes.c_int, argtypes
            fns[ent] = f
    return fns


def served_batch(dev):
    """The main path's largest packed batch (``chip_smoke``'s largest
    bucket: n_pad 5768, e_pad 69120) on ``dev``."""
    size = cs.FULL
    graphs = cs.make_graphs(size["graphs"], size["nodes"], size["degree"], seed=0)
    plan = plan_from_samples(graphs, max_batch_graphs=size["batch"], num_buckets=3)
    return cs.largest_batch(plan, graphs).to(dev)


def time_in_turns(calls, dev):
    """``{name: [µs, µs]}``: the median ``device_ms`` of every call, in two
    turns, in order and then reversed."""
    times = {k: [] for k in calls}
    for name in list(calls) + list(calls)[::-1]:
        times[name].append(device_ms(calls[name], dev)[1] * 1e3)
    return times
