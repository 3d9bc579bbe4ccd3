#!/usr/bin/env python3
"""K2 and K3 (PNA's statistics kernels) against variants of themselves, on
one CUDA card, in turns.

    python tools/moments_variants.py [--parent DIR] [VARIANT ...]

Each variant is a copy of ``hydragnn_tpu_torch/csrc`` with a few textual
changes (a design choice undone, or a knockout: one part of the work
skipped while its inputs are still loaded), built by ``nvcc`` with the
port's flags into ``build/moments_variants/<name>/`` (``build/`` is
gitignored). ``parent`` and ``parent_ko_*`` take the sources of another
tree instead (``--parent``, e.g. a ``git archive`` of the commit before
the redesign, unpacked under ``build/``), with that tree's C entries: an
f32 mask and outputs zeroed by the caller. With no VARIANT named, all run.

At the largest bucket of ``chip_smoke.py``'s served batches (n_pad 5768,
e_pad 69120) it checks each variant that is not a knockout against the
plain versions (``atomic_tolerance``, counts exact), then takes the median
``device_ms`` (``utils/timing.device_ms``) of every variant in two turns,
in order and reversed: K3 at D = 256 without and with ``ze`` and at D = 1,
K2 at D = 256 and 1, and K1 at K2's D = 256 shape as a reference. Prints
``-Xptxas -v``'s registers and spills of the moments kernels, one JSON
line per check and per case, and the card's name, power limit and clocks.
Knockout variants are named ``*ko*``; their results are wrong by design.
Building and timing: ``tools/variant_build.py``.
"""

import argparse
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

from hydragnn_tpu_torch.ops import (
    _build,
    fused_gather_moments_plain,
    segment_moments_plain,
    segment_sum,
    segment_sum_plain,
)
from hydragnn_tpu_torch.ops.segment_kernels import atomic_tolerance, moments_layout

OUT = ROOT / "build" / "moments_variants"
HDR = "gather_reduce.cuh"

# A knockout keeps the work's inputs alive behind a test that never holds
_FIRST = (
    "  static __device__ __forceinline__ float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }\n",
    "  static __device__ __forceinline__ float zero() { return 0.f; }\n",
    "  static __device__ __forceinline__ float2 zero() { return make_float2(0.f, 0.f); }\n",
)
_FIRST_NEW = (
    _FIRST[0] + "  static __device__ __forceinline__ float first(const float4& v) { return v.x; }\n",
    _FIRST[1] + "  static __device__ __forceinline__ float first(float v) { return v; }\n",
    _FIRST[2] + "  static __device__ __forceinline__ float first(const float2& v) { return v.x; }\n",
)
KO_ATOMICS = [
    (HDR, _FIRST[0], _FIRST_NEW[0]),
    (HDR, _FIRST[1], _FIRST_NEW[1]),
    (HDR, _FIRST[2], _FIRST_NEW[2]),
    (HDR, "      C::flush(row + col[k], acc[k]);\n",
     "      if (C::first(acc[k]) == 1234.5f) C::flush(row + col[k], acc[k]);\n"),
    (HDR, "      if constexpr (kMoments) C::flush(row + a.sq_off + col[k], acc2[k]);\n",
     "      if constexpr (kMoments) if (C::first(acc2[k]) == 1234.5f) C::flush(row + a.sq_off + col[k], acc2[k]);\n"),
    (HDR, "    if (counts) atomicAdd(row + a.cnt_off, cnt);\n",
     "    if (counts && cnt == 1234.5f) atomicAdd(row + a.cnt_off, cnt);\n"),
]
KO_Z = [
    (HDR, "          if (!kRows && active[k]) C::store(",
     "          if (!kRows && active[k] && C::first(z) == 1234.5f) C::store("),
]

# K2 on K1's layout (csrc/segment.cu): a thread per slice of rows and a
# column chunk, sums and squares in registers while the id repeats
_K1_LAYOUT_KERNEL = r'''
template <typename T>
__device__ __forceinline__ void add_sq(T& a, const T& v);
template <>
__device__ __forceinline__ void add_sq<float4>(float4& a, const float4& v) {
  a.x += v.x * v.x; a.y += v.y * v.y; a.z += v.z * v.z; a.w += v.w * v.w;
}
template <>
__device__ __forceinline__ void add_sq<float>(float& a, const float& v) { a += v * v; }

template <typename T>
__global__ void __launch_bounds__(kThreads) segment_moments_runs_kernel(
    const float* __restrict__ data, const int32_t* __restrict__ ids, float* __restrict__ out,
    int64_t E, int D, int S, int ldo, int sq_off, int cnt_off, int R, int64_t items) {
  using V = Vec<T>;
  const int chunks = D / V::kWidth;
  for (int64_t item = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; item < items;
       item += (int64_t)gridDim.x * blockDim.x) {
    const int64_t slice = item / chunks;
    const int col = (int)(item - slice * chunks) * V::kWidth;
    const int64_t e0 = slice * R;
    const int64_t e1 = e0 + R < E ? e0 + R : E;
    int32_t cur = -1;
    T acc = V::zero(), acc2 = V::zero();
    float n = 0.f;
    auto flush = [&]() {
      if (!in_range(cur, S)) return;
      float* row = out + (int64_t)cur * ldo;
      V::flush(row + col, acc);
      V::flush(row + sq_off + col, acc2);
      if (col == 0) atomicAdd(row + cnt_off, n);
    };
    for (int64_t e = e0; e < e1; e += kUnroll) {
      int32_t s[kUnroll];
      T v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[u] = e + u < e1 ? __ldg(ids + e + u) : -1;
        v[u] = e + u < e1 ? __ldg(reinterpret_cast<const T*>(data + (e + u) * D + col)) : V::zero();
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (s[u] != cur) {
          flush();
          cur = s[u];
          acc = acc2 = V::zero();
          n = 0.f;
        }
        V::add(acc, v[u]);
        add_sq(acc2, v[u]);
        n += 1.f;
      }
    }
    flush();
  }
}

template <typename T>
int launch_moments_runs(const void* data, const void* ids, void* out, long long E, int D,
                        int S, int ldo, int sq_off, int cnt_off, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(out, 0, (size_t)S * ldo * sizeof(float), st);
  int dev = 0;
  cudaGetDevice(&dev);
  const int chunks = D / Vec<T>::kWidth;
  const int R = rows_per_thread(E, chunks, hg::sm_count(dev));
  const int64_t items = (E + R - 1) / R * chunks;
  segment_moments_runs_kernel<T><<<(unsigned)blocks_for(items), kThreads, 0, st>>>(
      (const float*)data, (const int32_t*)ids, (float*)out, E, D, S, ldo, sq_off, cnt_off, R,
      items);
  return (int)cudaGetLastError();
}

}  // namespace

'''
K1_LAYOUT = [
    ("segment.cu", "}  // namespace\n\n// data [E, D] f32, ids [E] i32 -> out [S, D] f32",
     _K1_LAYOUT_KERNEL + "// data [E, D] f32, ids [E] i32 -> out [S, D] f32"),
    ("segment.cu", "  return (int)hg::launch_moments<hg::Op::kRows>(a, (cudaStream_t)stream);",
     "  if (D % 4 == 0 && (uintptr_t)data % 16 == 0 && (uintptr_t)out % 16 == 0)\n"
     "    return launch_moments_runs<float4>(data, ids, out, E, D, S, ldo, sq_off, cnt_off, stream);\n"
     "  return launch_moments_runs<float>(data, ids, out, E, D, S, ldo, sq_off, cnt_off, stream);"),
]


def _flag(old, new):
    return [(HDR, old, new)]


def _parent_ko_atomics(src):
    """Every atomicAdd of the parent's two moments kernels behind the test."""
    import re

    pat = re.compile(r"atomicAdd\(([^;]+?), ([^;]+?)\);")
    for kern in ("fused_gather_moments_kernel", "segment_moments_kernel"):
        i = src.find(f"__global__ void {kern}")
        if i < 0:
            continue
        j = src.find("\n}\n", i)
        body = pat.sub(lambda m: f"if (({m.group(2)}) == 1234.5f) atomicAdd({m.group(1)}, {m.group(2)});",
                       src[i:j])
        src = src[:i] + body + src[j:]
    return src


# name -> substitutions on this tree's csrc, or ("parent", substitutions)
VARIANTS = {
    "shipped": [],
    "unsorted": _flag("constexpr int kSortLanes = 8;", "constexpr int kSortLanes = 1 << 30;"),
    "sort_tile_128": _flag("constexpr int kSortTile = 256;", "constexpr int kSortTile = 128;"),
    "sort_tile_512": _flag("constexpr int kSortTile = 256;", "constexpr int kSortTile = 512;"),
    "sort_all_widths": _flag("constexpr int kSortLanes = 8;", "constexpr int kSortLanes = 1;"),
    "lanes_16x4": _flag("  static constexpr bool kWide = sizeof(T) == 16 && kMoments;",
                        "  static constexpr bool kWide = false;"),
    "plain_z_store": [
        (HDR, "    __stcs(reinterpret_cast<float4*>(p), v);", "    *reinterpret_cast<float4*>(p) = v;"),
        (HDR, "void store(float* p, float v) { __stcs(p, v); }", "void store(float* p, float v) { *p = v; }")],
    "three_blocks_per_sm": _flag("constexpr int kGatherBlocks = 2;", "constexpr int kGatherBlocks = 3;"),
    "four_in_flight": _flag("kOp == Op::kMomentsZe ? 1 : 2;",
                            "kOp == Op::kMomentsZe ? 1 : kOp == Op::kSum ? 2 : 4;"),
    "ze_two_in_flight": _flag("kOp == Op::kMomentsZe ? 1 : 2;", "2;"),
    "k2_on_k1_layout": K1_LAYOUT,
    "ko_atomics": KO_ATOMICS,
    "ko_z_store": KO_ATOMICS[:3] + KO_Z,
    "ko_atomics_and_z": KO_ATOMICS + KO_Z,
    "parent": ("parent", []),
    "parent_ko_atomics": ("parent", [("fused_mp.cu", _parent_ko_atomics),
                                     ("segment.cu", _parent_ko_atomics)]),
    "parent_ko_z_store": ("parent", [
        ("fused_mp.cu", "    z_out[i] = z;\n", "    if (z == 1234.5f) z_out[i] = z;\n")]),
}


def make_variant(name, parent_dir):
    spec = VARIANTS[name]
    from_parent = isinstance(spec, tuple)
    src_dir = (parent_dir / "hydragnn_tpu_torch" / "csrc") if from_parent else _build.CSRC
    d = make_sources(src_dir, OUT / name, spec[1] if from_parent else spec)
    return d, "old" if from_parent else "new"


SIGNATURES = {
    "old": {"hg_fused_gather_moments_f32": [P, P, P, P, P, P, P, I64, I32, I32, I32, P],
            "hg_segment_moments_f32": [P, P, P, P, P, I64, I32, I32, P]},
    "new": {"hg_fused_gather_moments_f32": [P, P, P, I32, P, P, P, P, I64, I32, I32, I32, I32, I32,
                                            I32, P],
            "hg_segment_moments_f32": [P, P, P, I64, I32, I32, I32, I32, I32, P]},
}


def k3_call(abi, f, yj, ze, snd, rcv, mask, stream):
    (n, d), e = yj.shape, snd.shape[0]

    def ze_ptr():  # the closures hold the tensors, not their addresses
        return None if ze is None else ze.data_ptr()

    if abi == "old":
        def call():
            out = torch.zeros((n, 2 * d + 1), device=yj.device)
            z = torch.empty((e, d), device=yj.device)
            maskf = mask.to(torch.float32)
            rc = f(yj.data_ptr(), ze_ptr(), maskf.data_ptr(), snd.data_ptr(),
                   rcv.data_ptr(), out.data_ptr(), z.data_ptr(), e, n, d, n, stream)
            assert rc == 0, rc
            return out[:, :d], out[:, 2 * d:], out[:, d:2 * d], z
        return call
    sq_off, cnt_off, ldo = moments_layout(d)

    def call():
        out = torch.empty((n, ldo), device=yj.device)
        z = torch.empty((e, d), device=yj.device)
        rc = f(yj.data_ptr(), ze_ptr(), mask.data_ptr(), 1, snd.data_ptr(), rcv.data_ptr(),
               out.data_ptr(), z.data_ptr(), e, n, d, n, ldo, sq_off, cnt_off, stream)
        assert rc == 0, rc
        return out[:, :d], out[:, cnt_off:cnt_off + 1], out[:, sq_off:sq_off + d], z
    return call


def k2_call(abi, f, data, ids, n, stream):
    e, d = data.shape
    if abi == "old":
        def call():
            s, c, q = (torch.zeros((n, w), device=data.device) for w in (d, 1, d))
            rc = f(data.data_ptr(), ids.data_ptr(), s.data_ptr(), c.data_ptr(), q.data_ptr(),
                   e, d, n, stream)
            assert rc == 0, rc
            return s, c, q
        return call
    sq_off, cnt_off, ldo = moments_layout(d)

    def call():
        out = torch.empty((n, ldo), device=data.device)
        rc = f(data.data_ptr(), ids.data_ptr(), out.data_ptr(), e, d, n, ldo, sq_off, cnt_off,
               stream)
        assert rc == 0, rc
        return out[:, :d], out[:, cnt_off:cnt_off + 1], out[:, sq_off:sq_off + d]
    return call


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=ROOT / "build" / "parent",
                    help="root of the tree whose kernels the parent* variants take")
    ap.add_argument("variants", nargs="*", help=f"any of {', '.join(VARIANTS)}")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("moments_variants.py needs a CUDA card")
    names = args.variants or [
        v for v in VARIANTS if not v.startswith("parent") or args.parent.is_dir()]
    dev = torch.device("cuda")
    print(f"card: {cs.card_line()}", flush=True)

    made = {name: make_variant(name, args.parent) for name in names}
    jobs = [(name, src) for name in names for src in ("fused_mp.cu", "segment.cu")]
    libs = build_all([(made[name][0], src) for name, src in jobs],
                     ("moments", "gather_reduce", "runs"))
    fns = {}
    for (name, _), lib in zip(jobs, libs):
        abi = made[name][1]
        for ent, f in bind(lib, SIGNATURES[abi]).items():
            fns[name, ent] = (abi, f)

    batch = served_batch(dev)
    n = batch.num_nodes
    snd, rcv, mask = batch.senders, batch.receivers, batch.edge_mask
    stream = torch._C._cuda_getCurrentRawStream(dev.index or 0)
    rng = np.random.default_rng(1)

    def rand(rows, cols, m=None):
        t = torch.from_numpy(rng.standard_normal((rows, cols)).astype(np.float32)).to(dev)
        return t if m is None else torch.where(m, t, 0.0)

    def tol_of(z):
        return atomic_tolerance(segment_sum_plain(torch.cat([z.abs(), z * z], 1), rcv, n))

    cases = []
    for d in (256, 1):
        yj = rand(n, d)
        for ze in ((None, rand(snd.shape[0], d)) if d == 256 else (None,)):
            ref = fused_gather_moments_plain(yj, snd, rcv, n, mask, ze=ze)
            calls = {name: k3_call(abi, f, yj, ze, snd, rcv, mask, stream)
                     for (name, ent), (abi, f) in fns.items() if ent.startswith("hg_fused")}
            cases.append((f"K3 D={d}" + ("" if ze is None else " +ze"), calls, ref, tol_of(ref[3])))
        z = rand(snd.shape[0], d, mask[:, None])
        calls = {name: k2_call(abi, f, z, rcv, n, stream)
                 for (name, ent), (abi, f) in fns.items() if ent.startswith("hg_segment")}
        if d == 256:
            calls["K1 at the same shape"] = lambda z=z: segment_sum(z, rcv, n)
        cases.append((f"K2 D={d}", calls, segment_moments_plain(z, rcv, n), tol_of(z)))

    bad = []
    for what, calls, ref, tol in cases:
        for name, call in calls.items():
            if name.startswith("K1"):
                continue
            got = call()
            torch.cuda.synchronize()
            err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            exact = bool(torch.equal(got[1], ref[1]))
            print(json.dumps({"check": what, "variant": name, "err": err, "tol": tol,
                              "count_exact": exact}), flush=True)
            if "ko" not in name and not (err <= tol and exact):
                bad.append((what, name))
        times = time_in_turns(calls, dev)
        print(json.dumps({"case": what, "device_us_median_per_turn": times}), flush=True)
    print(f"clocks: {cs.clocks_line()}", flush=True)
    if bad:
        raise SystemExit(f"variants that disagree with the plain versions: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
