"""The port's streaming data plane (``data/stream/``) against the JAX
package's, on seeded numpy samples at CPU scale.

- Every source (shard store, list, extxyz with periodic cells, MPtrj, QM9)
  yields the JAX package's samples, shard for shard, and the same size scan.
- The weighted mix draws the JAX package's sequence over 3 epochs at world
  1 and at world 2 (ranks 0 and 1); a cursor saved by either package
  resumes in the other to the same draws; both refuse a cursor of another
  seed or window and re-derive the positions after a world change.
- The planner's bounds, budgets, ``est_waste`` and ``bucket_plan`` payload
  equal the JAX package's (its ``device_multiple`` 1, the port's one card);
  the ``StreamLoader``'s padded batches equal the JAX package's, array for
  array, with the collation thread on or off; ``example_batch`` leaves the
  cursor as it was; an oversize sample is dropped, counted and warned.
- At most one window of shards per source is resident.
- ``HYDRAGNN_NUM_WORKERS`` > 1 gives the batches of one worker, in order
  (3 workers, and 16 switching threads every microsecond), and a worker's
  error surfaces on the consumer's side; ``OMP_PLACES`` parses as in the
  JAX package.
- A ``Dataset.streaming`` ``run_training`` (PNA, hidden 8, 2 layers, 2
  epochs, two 24-sample families), both packages continuing one JAX
  starting checkpoint: per-epoch losses within ``test_torch_run_training``'s
  rtol 1e-4 / atol 1e-5, and the checkpoints' ``meta["stream"]`` equal;
  the JAX package's ``StreamLoader`` takes the port's cursor and draws
  what the port draws next.
- A run stopped at a step of its last epoch and resumed from its
  checkpoint ends bitwise where the uninterrupted run does (the port alone,
  plain versions on the CPU); ``run_prediction`` of the streaming config
  predicts its test split (the JAX package's reads ``Dataset.path``).
- ``FeedbackSink`` over the same offers admits, dedupes and drops as the
  JAX package's and writes byte-identical packs.
- Compact transfer never wraps an id: a bucket of 2**15 nodes or more
  ships int32.
"""

import copy
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import hydragnn_tpu
from hydragnn_tpu.data import stream as jax_stream
from hydragnn_tpu.data.dataobj import GraphData as JaxGraphData
from hydragnn_tpu.data.loaders import _parse_omp_places as jax_omp_places
from hydragnn_tpu.data.shard_store import ShardWriter as JaxShardWriter
from hydragnn_tpu.serve.quality import FeedbackSink as JaxFeedbackSink
from hydragnn_tpu.train import checkpoint as jax_ckpt
from hydragnn_tpu.train import driver as jax_driver
from hydragnn_tpu.utils import config as jax_config

import hydragnn_tpu_torch
from hydragnn_tpu_torch.data import stream
from hydragnn_tpu_torch.data.dataobj import GraphData
from hydragnn_tpu_torch.data.layout import BatchLayout
from hydragnn_tpu_torch.data.loaders import (
    BucketedLayout,
    GraphLoader,
    _parse_omp_places,
    _pin_worker,
)
from hydragnn_tpu_torch.data.shard_store import ShardDataset, ShardWriter
from hydragnn_tpu_torch.graph.batch import collate_graphs
from hydragnn_tpu_torch.serve.quality import FeedbackSink
from hydragnn_tpu_torch.train import checkpoint as ckpt
from hydragnn_tpu_torch.train.transfer import compact_for_transfer, decompact
from hydragnn_tpu_torch.utils import faults

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_jax_init import cached_jax_init  # noqa: F401,E402 (autouse)
from _torch_stream_data import family_samples, stream_config, write_stores  # noqa: E402

LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5  # test_torch_run_training.py's
BATCH_FIELDS = ("x", "pos", "senders", "receivers", "node_graph", "n_node", "n_edge",
                "node_mask", "edge_mask", "graph_mask")


def _tagged(cls, n, seed, lo=3, hi=9):
    """Samples whose ``x[0, 0]`` is their index: draws read as ids."""
    out = family_samples(cls, seed, n, lo, hi)
    for i, d in enumerate(out):
        d.x = d.x.copy()
        d.x[0, 0] = 1000.0 + i
    return out


def _same_sample(a, b):
    for f in ("x", "pos", "edge_index", "edge_attr", "y", "supercell_size"):
        va, vb = getattr(a, f), getattr(b, f)
        assert (va is None) == (vb is None), f
        if va is not None:
            np.testing.assert_array_equal(va, vb, err_msg=f)
    assert list(a.target_types) == list(b.target_types)
    for s, t in zip(a.targets, b.targets):
        np.testing.assert_array_equal(s, t)


def _mixes(world=1, rank=0, window=2, seed=7):
    """The same two list sources in both packages' mixes."""
    out = []
    for pkg, cls in ((stream, GraphData), (jax_stream, JaxGraphData)):
        a = pkg.ListSource(_tagged(cls, 40, 1), shard_size=8, name="a")
        b = pkg.ListSource(_tagged(cls, 60, 2), shard_size=8, name="b")
        out.append(pkg.WeightedMix([a, b], [2.0, 1.0], seed=seed, num_shards=world,
                                   shard_id=rank, window=window))
    return out


def _draws(mix, epoch):
    mix.set_epoch(epoch)
    return [(k, float(d.x[0, 0]), d.x.shape[0]) for k, d in mix]


def _plain(tree):
    if isinstance(tree, dict):
        return {str(k): _plain(v) for k, v in tree.items()}
    return int(np.asarray(tree))


# ---- sources -------------------------------------------------------------------


def _periodic_frames(num, seed):
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(num):
        n = int(rng.integers(4, 8))
        cell = np.diag(rng.uniform(6.5, 8.0, 3))
        frames.append({"z": np.full(n, 6, np.int64), "pos": rng.uniform(0, 1, (n, 3)) @ cell,
                       "cell": cell, "pbc": np.array([True, True, True]),
                       "info": {"energy": float(rng.normal())},
                       "arrays": {"forces": rng.normal(size=(n, 3))}})
    return frames


def _source_pair(kind, tmp_path):
    """``(port source, JAX source)`` over the same files or samples."""
    if kind == "shard_store":
        stores = write_stores(tmp_path, ShardWriter, GraphData, num=18, train_shards=3)
        label = stores["fam_b"]["trainset"]
        return stream.ShardStoreSource(label), jax_stream.ShardStoreSource(label)
    if kind == "list":
        return (stream.ListSource(_tagged(GraphData, 19, 3), shard_size=6),
                jax_stream.ListSource(_tagged(JaxGraphData, 19, 3), shard_size=6))
    if kind == "extxyz":
        from hydragnn_tpu.data.extxyz import write_extxyz

        frames = _periodic_frames(6, seed=5)
        (tmp_path / "xyz").mkdir()
        write_extxyz(str(tmp_path / "xyz" / "a.extxyz"), frames[:3])
        write_extxyz(str(tmp_path / "xyz" / "b.extxyz"), frames[3:])
        kw = dict(dirpath=str(tmp_path / "xyz"), radius=3.0, max_neighbours=12)
        return stream.ExtxyzSource(**kw), jax_stream.ExtxyzSource(**kw)
    if kind == "mptrj":
        from hydragnn_tpu.data.mptrj import write_mptrj_json

        rng = np.random.default_rng(11)
        records = []
        for i in range(5):
            n = int(rng.integers(3, 7))
            records.append({"mp_id": f"mp-{i}", "frame_id": f"{i}_0_{i}",
                            "z": rng.integers(1, 30, n), "pos": rng.uniform(0, 4, (n, 3)),
                            "lattice": np.eye(3) * 8.0, "energy": float(rng.normal()),
                            "forces": rng.normal(size=(n, 3))})
        path = str(tmp_path / "mptrj.json")
        write_mptrj_json(path, records)
        kw = dict(entries_per_shard=2, radius=3.0, max_neighbours=10)
        return stream.MPTrjSource(path, **kw), jax_stream.MPTrjSource(path, **kw)
    from hydragnn_tpu.data.qm9_raw import write_qm9_sdf

    rng = np.random.default_rng(4)
    mols = [(["C"] * int(n), rng.uniform(0, 3, (int(n), 3))) for n in rng.integers(3, 6, 9)]
    write_qm9_sdf(str(tmp_path), mols, rng.normal(size=(9, 19)), skips=[2])
    kw = dict(molecules_per_shard=4, radius=3.0, max_neighbours=4)
    return stream.QM9RawSource(str(tmp_path), **kw), jax_stream.QM9RawSource(str(tmp_path), **kw)


@pytest.mark.parametrize("kind", ["shard_store", "list", "extxyz", "mptrj", "qm9"])
def pytest_sources_yield_the_jax_packages_samples(tmp_path, kind):
    ours, theirs = _source_pair(kind, tmp_path)
    assert ours.num_shards() == theirs.num_shards() and ours.seekable == theirs.seekable
    assert ours.num_samples() == theirs.num_samples() and ours.name == theirs.name
    for i in range(ours.num_shards()):
        a, b = ours.read_shard(i), theirs.read_shard(i)
        assert len(a) == len(b)
        for s, t in zip(a, b):
            if ours.graph_builder is not None:
                s, t = ours.graph_builder(s), theirs.graph_builder(t)
            _same_sample(s, t)
    for got, want in zip(ours.size_scan(), theirs.size_scan()):
        np.testing.assert_array_equal(got, want)
    for s, t in zip(ours.probe_samples(3), theirs.probe_samples(3)):
        _same_sample(s, t)


def pytest_shard_order_is_lexical(tmp_path):
    for rank in (2, 10):
        w = ShardWriter(str(tmp_path / "s"), rank=rank)
        w.add(family_samples(GraphData, rank, 2, 3, 5))
        w.save()
    src = stream.ShardStoreSource(str(tmp_path / "s"))
    assert [os.path.basename(p) for p in src.paths] == ["shard.00002.gpk", "shard.00010.gpk"]
    assert src.paths == jax_stream.ShardStoreSource(str(tmp_path / "s")).paths


# ---- the mix and its cursor -------------------------------------------------


@pytest.mark.parametrize("world,rank", [(1, 0), (2, 0), (2, 1)])
def pytest_mix_draws_the_jax_sequence(world, rank):
    ours, theirs = _mixes(world, rank)
    assert ours.samples_per_epoch() == theirs.samples_per_epoch()
    for epoch in range(3):
        assert _draws(ours, epoch) == _draws(theirs, epoch)
        np.testing.assert_array_equal(ours.epoch_draws, theirs.epoch_draws)
    assert ours.residency_stats() == theirs.residency_stats()
    assert _plain(ours.state_dict()) == _plain(theirs.state_dict())


def pytest_cursor_resumes_across_packages_with_refusals():
    for saver, loader in ((0, 1), (1, 0)):
        pair = _mixes(window=3)
        _draws(pair[saver], 0)
        sd = pair[saver].state_dict()
        assert any(v["offset"] for v in sd["sources"].values())  # mid-window
        fresh = _mixes(window=3)
        fresh[loader].load_state_dict(copy.deepcopy(sd))
        assert _draws(fresh[loader], 1) == _draws(pair[saver], 1)
    for pkg_mix in _mixes(seed=7):
        sd = pkg_mix.state_dict()
        other_seed = _mixes(seed=8)
        other_window = _mixes(window=3)
        for mix in other_seed:
            with pytest.raises(ValueError, match="seed"):
                mix.load_state_dict(sd)
        for mix in other_window:
            with pytest.raises(ValueError, match="window"):
                mix.load_state_dict(sd)
    # a cursor of world 2 at world 1: positions re-derived (a fresh start)
    for ours, theirs in zip(_mixes(world=2, rank=0), _mixes(world=1)):
        _draws(ours, 0)
        sd = ours.state_dict()
        with pytest.warns(UserWarning, match="re-derived"):
            theirs.load_state_dict(sd)
        assert _draws(theirs, 1) == _draws(_mixes(world=1)[1], 1)


# ---- the planner and the loader ----------------------------------------------


def _stores_and_sources(tmp_path):
    stores = write_stores(tmp_path, ShardWriter, GraphData)
    out = []
    for pkg in (stream, jax_stream):
        out.append([pkg.ShardStoreSource(p["trainset"], name=f) for f, p in stores.items()])
    return stores, out


def pytest_planner_and_loader_batches_as_jax(tmp_path, monkeypatch):
    stores, (ours, theirs) = _stores_and_sources(tmp_path)
    extra = [ShardDataset(p["valset"]) for p in stores.values()]
    p_ours = stream.BucketPlanner(ours, 4, num_buckets=3, extra_datasets=extra)
    p_theirs = jax_stream.BucketPlanner(theirs, 4, num_buckets=3, device_multiple=1,
                                        extra_datasets=extra)
    lay_ours, lay_theirs = p_ours.plan(emit=False), p_theirs.plan(emit=False)
    assert lay_ours.node_bounds == lay_theirs.node_bounds and len(lay_ours.layouts) == 3
    for a, b in zip(lay_ours.layouts, lay_theirs.layouts):
        assert (a.n_pad, a.e_pad, a.g_pad) == (b.n_pad, b.e_pad, b.g_pad)
    assert p_ours.estimate_waste(lay_ours) == p_theirs.estimate_waste(lay_theirs)
    assert p_ours.plan_payload(lay_ours) == p_theirs.plan_payload(lay_theirs)
    monkeypatch.setenv("HYDRAGNN_STREAM_PLAN_SHARDS", "1")
    capped = stream.BucketPlanner(ours, 4, num_buckets=3)
    assert (capped.plan_payload(capped.plan(emit=False))["samples_scanned"]
            == jax_stream.BucketPlanner(theirs, 4, num_buckets=3, device_multiple=1)
            .scan()["nodes"].size)
    monkeypatch.delenv("HYDRAGNN_STREAM_PLAN_SHARDS")
    for queue in ("0", "2"):
        monkeypatch.setenv("HYDRAGNN_STREAM_QUEUE", queue)
        loaders = [pkg.StreamLoader(pkg.WeightedMix(srcs, [2.0, 1.0], seed=3, window=2), 4, lay)
                   for pkg, srcs, lay in ((stream, ours, lay_ours),
                                          (jax_stream, theirs, lay_theirs))]
        for epoch in range(2):
            before = _plain(loaders[0].state_dict())
            examples = (loaders[0].example_batch(), loaders[1].example_batch())
            assert _plain(loaders[0].state_dict()) == before
            for loader in loaders:
                loader.set_epoch(epoch)
            got, want = list(loaders[0]), list(loaders[1])
            assert len(got) == len(want) > 0
            for a, b in [examples] + list(zip(got, want)):
                for f in BATCH_FIELDS:
                    np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)),
                                                  err_msg=f)
                for s, t in zip(a.targets, b.targets):
                    np.testing.assert_array_equal(s.numpy(), np.asarray(t))
            assert loaders[0].epoch_padding_stats() == loaders[1].epoch_padding_stats()
            assert _plain(loaders[0].state_dict()) == _plain(loaders[1].state_dict())


def pytest_residency_is_one_window_per_source(tmp_path):
    _, (ours, _) = _stores_and_sources(tmp_path)
    mix = stream.WeightedMix(ours, [2.0, 1.0], seed=4, window=2)
    for epoch in range(3):
        _draws(mix, epoch)
    for st, src in zip(mix.streams, ours):
        sizes = sorted(sum(stream.sample_nbytes(d) for d in src.read_shard(i))
                       for i in range(src.num_shards()))
        assert st.open_shards_peak <= 2 and 0 < st.resident_bytes_peak <= sum(sizes[-2:])
    assert mix.residency_stats()["open_shards_peak"] <= 2


def pytest_oversize_sample_dropped_counted_and_warned():
    small = family_samples(GraphData, 1, 12, 3, 5)
    big = family_samples(GraphData, 2, 1, 30, 31)
    planner = stream.BucketPlanner([stream.ListSource(small, shard_size=4)], 4, num_buckets=2)
    layout = planner.plan(emit=False)
    mix = stream.WeightedMix([stream.ListSource(small + big, shard_size=13)], seed=1)
    loader = stream.StreamLoader(mix, 4, layout)
    with pytest.warns(UserWarning, match="fit no bucket"):
        batches = list(loader)
    assert loader._epoch_stats["oversize_dropped"] == 1
    assert sum(int(b.graph_mask.sum()) for b in batches) == 12


def pytest_worker_pool_gives_one_workers_batches(monkeypatch):
    samples = family_samples(GraphData, 9, 30, 3, 12)
    lays = [BatchLayout(64, 256, 9), BatchLayout(104, 512, 9)]
    layout = BucketedLayout(layouts=lays, node_bounds=[6, 11])
    out = {}
    # 16 workers, more than this host's cores, switching threads every
    # microsecond: the stress case of the ordered pool
    interval = sys.getswitchinterval()
    try:
        for workers in ("1", "3", "16"):
            sys.setswitchinterval(1e-6 if workers == "16" else interval)
            monkeypatch.setenv("HYDRAGNN_NUM_WORKERS", workers)
            loader = GraphLoader(samples, 4, layout, shuffle=True)
            loader.set_epoch(1)
            out[workers] = list(loader)
    finally:
        sys.setswitchinterval(interval)
    assert len(out["1"]) == len(out["3"]) == len(out["16"]) > 1
    for many in ("3", "16"):
        for a, b in zip(out["1"], out[many]):
            for s, t in zip(a.leaves()[1], b.leaves()[1]):
                assert torch.equal(s, t)

    class Broken(list):
        def __getitem__(self, i):
            if i == 7:
                raise KeyError("sample 7")
            return list.__getitem__(self, i)

    with pytest.raises(KeyError, match="sample 7"):
        list(GraphLoader(Broken(samples), 4, layout, shuffle=False))
    for spec in ("{0:4},{4:4}", "{0:2:2},{1}", "{0,2,4}", "bad", ""):
        assert _parse_omp_places(spec) == jax_omp_places(spec)
    _pin_worker(0, [sorted(os.sched_getaffinity(0))] if hasattr(os, "sched_getaffinity") else [])


# ---- run_training ----------------------------------------------------------------


def _scalars(path):
    out = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            out.setdefault(rec["tag"], {})[int(rec["step"])] = float(rec["value"])
    return {tag: [v[k] for k in sorted(v)] for tag, v in out.items()}


def pytest_streaming_run_training_as_jax(tmp_path, monkeypatch):
    """Both packages continue one JAX starting checkpoint (a warm start:
    the weights, not the loop state) for 2 streamed epochs of 8 steps.
    The rate is 1e-4: the biases of each conv's last two layers feed a
    BatchNorm in training mode, so their gradients are rounding noise that
    Adam turns into updates of up to the rate which differ between the
    packages (``test_torch_train.py``); the training losses do not see
    them, but the evaluation losses do through the running means. At 1e-4
    16 steps keep that drift inside the loss tolerance (the training
    losses agree to ~1e-7 at any rate up to 1e-3)."""
    stores = write_stores(tmp_path / "dataset", JaxShardWriter, JaxGraphData)
    config = stream_config(stores)
    config["NeuralNetwork"]["Training"]["Optimizer"]["learning_rate"] = 1e-4
    start = tmp_path / "start"
    start.mkdir()
    monkeypatch.chdir(start)
    jcfg = copy.deepcopy(config)
    tl, vl, sl, probe = jax_stream.build_stream_loaders(jcfg)
    jcfg = jax_config.update_config(jcfg, probe, vl, sl)
    _, _, jstate = jax_driver._build_model_and_trainer(jcfg, probe, 0)
    jax_ckpt.save_model(jstate, "start", path=str(start / "logs"))
    config["NeuralNetwork"]["Training"].update({"continue": 1, "startfrom": "start"})
    runs = {}
    for side in ("jax", "port"):
        where = tmp_path / side
        shutil.copytree(start / "logs", where / "logs")
        monkeypatch.chdir(where)
        if side == "jax":
            hydragnn_tpu.run_training(copy.deepcopy(config))
        else:
            state = hydragnn_tpu_torch.run_training(copy.deepcopy(config), device="cpu")
            runs["history"], runs["name"] = state.info["history"], state.info["log_name"]
    name = runs["name"]
    want = _scalars(tmp_path / "jax" / "logs" / name / "scalars.jsonl")
    history = runs["history"]
    assert [h["epoch"] for h in history] == [0, 1]
    for key, tag in (("train_loss", "train error"), ("val_loss", "validate error"),
                     ("test_loss", "test error")):
        np.testing.assert_allclose([h[key] for h in history], want[tag], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=key)
    ours = ckpt.pop_train_meta(ckpt.load_state_dict(name, path=str(tmp_path / "port" / "logs")))
    theirs = jax_ckpt.pop_train_meta(jax_ckpt.load_state_dict(
        name, path=str(tmp_path / "jax" / "logs")))
    assert _plain(ours["stream"]) == _plain(theirs["stream"])
    # the JAX package's loader takes the port's cursor and draws what the port draws
    sources = {pkg: [pkg.ShardStoreSource(p["trainset"], name=f) for f, p in stores.items()]
               for pkg in (stream, jax_stream)}
    mixes = {pkg: pkg.WeightedMix(sources[pkg], [2.0, 1.0], seed=5, window=2)
             for pkg in (stream, jax_stream)}
    for pkg, mix in mixes.items():
        mix.load_state_dict(copy.deepcopy(ours["stream"]["mix"]))
    assert _draws(mixes[stream], 2) == _draws(mixes[jax_stream], 2)


class _Stopped(Exception):
    pass


def pytest_stop_and_resume_bitwise(tmp_path, monkeypatch):
    stores = write_stores(tmp_path / "dataset", ShardWriter, GraphData)
    config = stream_config(stores, epochs=3, steps_per_dispatch=2)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HYDRAGNN_STREAM_QUEUE", "2")
    finals = {}
    for label in ("whole", "stopped"):
        where = tmp_path / label
        where.mkdir()
        monkeypatch.chdir(where)
        if label == "stopped":
            def stop_at(step):
                if step == stop_step:
                    raise _Stopped(step)

            stop_step = finals["whole_steps"] - 2  # a step of the last epoch
            monkeypatch.setattr(faults, "kill_at_step", stop_at)
            with pytest.raises(_Stopped):
                hydragnn_tpu_torch.run_training(copy.deepcopy(config), device="cpu")
            monkeypatch.undo()
            monkeypatch.chdir(where)
            monkeypatch.setenv("HYDRAGNN_STREAM_QUEUE", "2")
            resumed = copy.deepcopy(config)
            resumed["NeuralNetwork"]["Training"]["continue"] = 1
            state = hydragnn_tpu_torch.run_training(resumed, device="cpu")
            assert [h["epoch"] for h in state.info["history"]] == [2]
            assert state.info["history"][0]["train_loss"] == finals["whole_loss"]
        else:
            state = hydragnn_tpu_torch.run_training(copy.deepcopy(config), device="cpu")
            finals["whole_steps"] = int(state.step)
            finals["whole_loss"] = state.info["history"][2]["train_loss"]
        finals[label] = ckpt.load_state_dict(state.info["log_name"])
    meta = {k: ckpt.pop_train_meta(finals[k]) for k in ("whole", "stopped")}
    assert _plain(meta["whole"]["stream"]) == _plain(meta["stopped"]["stream"])
    flat = {k: jax_tree_leaves(finals[k]) for k in ("whole", "stopped")}
    assert len(flat["whole"]) == len(flat["stopped"]) > 0
    for a, b in zip(flat["whole"], flat["stopped"]):
        np.testing.assert_array_equal(a, b)
    # run_prediction of a streaming config predicts its test split
    error, _, true_values, predicted = hydragnn_tpu_torch.run_prediction(
        copy.deepcopy(config), device="cpu")
    assert np.isfinite(error) and len(predicted[0]) == len(true_values[0]) == 8


def jax_tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in jax_tree_leaves(tree[k])]
    return [np.asarray(tree)]


# ---- the feedback sink, compact transfer --------------------------------------


def pytest_feedback_sink_as_jax(tmp_path):
    sinks = {"port": FeedbackSink(str(tmp_path / "port"), max_graphs=3, max_packs=2,
                                  min_unc=0.5),
             "jax": JaxFeedbackSink(str(tmp_path / "jax"), max_graphs=3, max_packs=2,
                                    min_unc=0.5)}
    graphs = {"port": family_samples(GraphData, 6, 12, 3, 7),
              "jax": family_samples(JaxGraphData, 6, 12, 3, 7)}
    for side, sink in sinks.items():
        gs = graphs[side]
        perm = np.roll(np.arange(gs[6].num_nodes), 1)
        for k, g in enumerate(gs):
            sink.offer(g, uncertainty=[0.1 * k, None], drifted=k == 1)
        # a permuted duplicate of graph 6 (admitted above): deduplicated
        g = gs[6].clone()
        inv = np.argsort(perm)
        g.x, g.pos = g.x[perm], g.pos[perm]
        g.edge_index = inv[g.edge_index]
        assert not sink.offer(g, uncertainty=[0.9])
        sink.close()
    assert sinks["port"].stats() == sinks["jax"].stats()
    assert sinks["port"].stats()["dropped"] > 0 and sinks["port"].stats()["deduped"] == 1
    packs = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert packs == sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "meta.json", "shard.00000.gpk", "shard.00001.gpk"]
    for name in packs:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert len(jax_stream.ShardStoreSource(str(tmp_path / "port")).read_shard(1)) == 3


def pytest_compact_ids_never_wrap():
    samples = family_samples(GraphData, 1, 2, 4, 6)
    for n_pad, dtype in ((2**15 - 8, torch.int16), (2**15 + 8, torch.int32)):
        batch = collate_graphs(samples, n_pad, 64, 3)
        wire = compact_for_transfer(batch, keep_pos=True)
        assert wire.senders.dtype == dtype and wire.node_graph.dtype == dtype
        back = decompact(wire)
        for f in ("senders", "receivers", "node_graph"):
            assert torch.equal(getattr(back, f), getattr(batch, f).to(torch.int32))
