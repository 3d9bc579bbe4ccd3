#!/usr/bin/env python3
"""K6 (SchNet's gather-multiply-sum) against variants of itself, on one CUDA
card, in turns.

    python tools/k6_variants.py [--parent DIR] [VARIANT ...]

Each variant is a copy of ``hydragnn_tpu_torch/csrc`` with a few textual
changes, built by ``nvcc`` with the port's flags into
``build/k6_variants/<name>/`` (``build/`` is gitignored;
``tools/variant_build.py`` builds and times). The walk variants
``t<tile>_c<chunks>_i<in flight>_<order>`` change K6's walk in
``gather_reduce.cuh``: edges per tile (64-512), chunks per lane (2, 4),
edges in flight per lane (1, 2, 4), and the tile walked in order or
sorted by receiver first; the shipped walk is ``t128_c2_i2_tile``. Design
choices undone: ``sender_reuse`` (a gathered row kept while the sender
repeats, as K4 does), ``scalar`` (single floats where the shipped kernel
takes float2), ``wait_in_flush`` (the wait for the zeroed output moved to
the first atomic), ``no_pdl`` (the gather kernel launched plainly after
the zeroing kernel) and ``no_pdl_memset`` (plainly after a
``cudaMemsetAsync``, as K1-K5 zero theirs). Knockouts (``ko_*``; wrong by
design) skip one part of the work while its inputs are still loaded: the
atomics, the stream of w (each edge multiplies the gathered row by
itself), both, the gather (every edge gathers row 0), the zeroing, the
whole walk (the kernel stages its ids and ends), the gather kernel (only
the zeroing runs). ``parent`` takes the kernels of another tree
(``--parent``, a ``git archive`` of the commit before the redesign,
unpacked under ``build/``), whose output the caller zeroes. With no
VARIANT named, all run.

On the largest bucket of ``chip_smoke.py``'s served batches (n_pad 5768,
e_pad 69120, its own senders and receivers) it checks every variant that
is not a knockout against ``fused_gather_weighted_sum_plain``
(``atomic_tolerance``) at D = 50 (float2, the served width), 256 (float4)
and 51 (single floats), then takes each one's median ``device_ms`` in two
turns, in order and reversed, with K1 at ``[e_pad, 50]`` by receiver (the
same w bytes streamed) as a reference. Prints ``-Xptxas -v``'s registers
and spills of the K6 kernels, one JSON line per check and per case, a
summary line (the mean of the two turns), and the card's name, power
limit and clocks.
"""

import argparse
import itertools
import json
import sys
from pathlib import Path

import numpy as np
import torch

from variant_build import (
    I32,
    I64,
    ROOT,
    P,
    bind,
    build_all,
    cs,
    make_sources,
    served_batch,
    time_in_turns,
)

from hydragnn_tpu_torch.ops import _build, fused_gather_weighted_sum_plain, segment_sum
from hydragnn_tpu_torch.ops.segment_kernels import atomic_tolerance

OUT = ROOT / "build" / "k6_variants"
HDR = "gather_reduce.cuh"
WIDTHS = (50, 256, 51)
# K6's entry functions in -Xptxas -v's output: hg::gather_reduce_kernel<T,
# Op::kMul> (the enum's fifth value) and the parent's kernel
K6_KERNELS = ("OpE4E", "fused_gather_mul")
SHIPPED = dict(tile=128, chunks=2, inflight=2)


def _walk(tile, chunks, inflight, order):
    """K6's walk with other constants than the shipped ones: edges per
    tile, chunks per lane, edges in flight per lane, tile order or sorted
    by receiver (the bitonic sort of the moments)."""
    subs = []
    if tile != SHIPPED["tile"]:
        subs.append((HDR, "  a.tile = !W::kMoments ? kTile :",
                     f"  a.tile = kOp == Op::kMul ? {tile} : !W::kMoments ? kTile :"))
    if chunks != SHIPPED["chunks"]:
        subs.append((HDR, "kPer = kWide || kOp == Op::kMul ? 2 : 4;",
                     f"kPer = kOp == Op::kMul ? {chunks} : kWide ? 2 : 4;"))
    if inflight != SHIPPED["inflight"]:
        subs.append((HDR, "kIn = kOp == Op::kMomentsZe ? 1 : 2;",
                     f"kIn = kOp == Op::kMul ? {inflight} : kOp == Op::kMomentsZe ? 1 : 2;"))
    if order == "sorted":
        subs += [(HDR, "  const bool sort = kMoments && a.sort;",
                  "  const bool sort = (kMoments || kMul) && a.sort;"),
                 (HDR, "  a.sort = W::kMoments && lanes >= kSortLanes;",
                  "  a.sort = kOp == Op::kMul || (W::kMoments && lanes >= kSortLanes);")]
    return subs


_WAIT = "  if (kMul) asm volatile(\"griddepcontrol.wait;\" ::: \"memory\");\n"
_FIRST = "reinterpret_cast<const float*>(&acc[k])[0] == 1234.5f"
_NO_PDL = (HDR, "  if constexpr (kOp == Op::kMul)\n    return launch_dependent(",
           "  if constexpr (false)\n    return launch_dependent(")
_ZERO = "  const cudaError_t err = hg::zero_for_dependent((float*)out, (int64_t)S * D, st);"
_KO_ATOMICS = (HDR, "      C::flush(row + col[k], acc[k]);\n",
               f"      if ({_FIRST}) C::flush(row + col[k], acc[k]);\n")
_KO_W = (HDR, "          w[u][k] = active[k] && in ? C::load_once(zs + col[k]) : C::zero();",
         "          w[u][k] = v[u][k];")
# the tile walks of the issue's grid, then design choices undone, then
# knockouts; every one otherwise the shipped kernel
VARIANTS = {
    f"t{t}_c{c}_i{i}_{o}": _walk(t, c, i, o)
    for t, c, i, o in itertools.product((128, 256, 512), (4, 2), (2, 1), ("tile", "sorted"))
}
VARIANTS.update({
    "t64_c2_i2_tile": _walk(64, 2, 2, "tile"),
    "t128_c2_i4_tile": _walk(128, 2, 4, "tile"),
    "sender_reuse": [(HDR, "const bool fresh = kMul || s != s_last;", "const bool fresh = s != s_last;")],
    "scalar": [(HDR, "    if (fits_chunk(a, 2)) return launch_gather_as<float2, kOp>(a, stream);\n",
                "")],
    "wait_in_flush": [(HDR, _WAIT, ""),
                      (HDR, "    if (cur < 0) return;\n", "    if (cur < 0) return;\n" + _WAIT)],
    "no_pdl": [_NO_PDL],
    "no_pdl_memset": [_NO_PDL, ("fused_mp.cu", _ZERO, "  const cudaError_t err = hg::zero_rows(out, S, D, st);")],
    "ko_atomics": [_KO_ATOMICS],
    "ko_w_stream": [_KO_W],
    "ko_atomics_and_w": [_KO_ATOMICS, _KO_W],
    "ko_gather": [(HDR, "C::load(xs + col[k])", "C::load(a.x + col[k])")],
    "ko_zero": [("fused_mp.cu", _ZERO, "  const cudaError_t err = cudaSuccess;")],
    "ko_walk": [(HDR, "  for (int q = q0; q < q1; q += kIn) {",
                 "  for (int q = q0; q < (kMul ? q0 : q1); q += kIn) {")],
    "ko_kernel": [("fused_mp.cu", "  return (int)hg::launch_gather<Op::kMul>(a, st);",
                   "  return (int)cudaGetLastError();")],
    "parent": None,
})
SIGNATURE = {"hg_fused_gather_mul_f32": [P, P, P, P, P, I64, I32, I32, I32, P]}


def make_variant(name, parent_dir):
    if name == "parent":
        return make_sources(parent_dir / "hydragnn_tpu_torch" / "csrc", OUT / name, [])
    return make_sources(_build.CSRC, OUT / name, VARIANTS[name])


def k6_call(f, h, w, snd, rcv, s, zeroed, stream):
    """One call of a variant's C entry; ``zeroed``: the caller zeroes the
    output (the parent's contract)."""
    (n, d), e = h.shape, snd.shape[0]

    def call():
        out = (torch.zeros if zeroed else torch.empty)((s, d), device=h.device)
        rc = f(h.data_ptr(), w.data_ptr(), snd.data_ptr(), rcv.data_ptr(), out.data_ptr(),
               e, n, d, s, stream)
        assert rc == 0, rc
        return out
    return call


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=ROOT / "build" / "parent",
                    help="root of the tree whose kernels the parent variant takes")
    ap.add_argument("variants", nargs="*", help=f"any of {', '.join(VARIANTS)}")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k6_variants.py needs a CUDA card")
    names = args.variants or [v for v in VARIANTS if v != "parent" or args.parent.is_dir()]
    dev = torch.device("cuda")
    print(f"card: {cs.card_line()}", flush=True)

    dirs = {name: make_variant(name, args.parent) for name in names}
    libs = build_all([(dirs[name], "fused_mp.cu") for name in names], K6_KERNELS)
    fns = {name: bind(lib, SIGNATURE)["hg_fused_gather_mul_f32"] for name, lib in zip(names, libs)}

    batch = served_batch(dev)
    n = batch.num_nodes
    snd, rcv, mask = batch.senders, batch.receivers, batch.edge_mask
    e = snd.shape[0]
    stream = torch._C._cuda_getCurrentRawStream(dev.index or 0)
    rng = np.random.default_rng(1)

    def rand(rows, cols):
        return torch.from_numpy(rng.standard_normal((rows, cols)).astype(np.float32)).to(dev)

    bad, summary = [], {}
    for d in WIDTHS:
        h, w = rand(n, d), rand(e, d) * mask[:, None]
        ref = fused_gather_weighted_sum_plain(h, w, snd, rcv, n)
        tol = atomic_tolerance(fused_gather_weighted_sum_plain(h.abs(), w.abs(), snd, rcv, n))
        calls = {name: k6_call(f, h, w, snd, rcv, n, name == "parent", stream)
                 for name, f in fns.items()}
        for name, call in calls.items():
            got = call()
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            print(json.dumps({"check": f"K6 D={d}", "variant": name, "err": err, "tol": tol}),
                  flush=True)
            if not name.startswith("ko") and not err <= tol:
                bad.append((d, name))
        if d == 50:
            calls[f"K1 [{e},{d}] by receiver"] = lambda w=w: segment_sum(w, rcv, n)
        times = time_in_turns(calls, dev)
        print(json.dumps({"case": f"K6 D={d}", "device_us_median_per_turn": times}), flush=True)
        for name, t in times.items():
            summary.setdefault(name, {})[f"D={d}"] = round(float(np.mean(t)), 2)
    print(json.dumps({"summary_device_us_mean_of_turns": summary}), flush=True)
    print(f"clocks: {cs.clocks_line()}", flush=True)
    if bad:
        raise SystemExit(f"variants that disagree with the plain version: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
