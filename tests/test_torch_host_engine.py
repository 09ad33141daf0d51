"""arch0, the host-sampling engine: the port's C++ host library against the
JAX package's (``fgnn_tpu.native``), bit for bit on the same inputs and
seeds; the port's NumPy hop functions against the reference's with the same
``default_rng``; and whole epochs of ``HostSamplingEngine`` against the
reference's from the same parameters (dropout 0): the same host batches,
per-step losses within 1e-4 (float32 sums in another order over Adam
steps)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgnn_tpu import native
from fgnn_tpu import host_engine as jhe
from fgnn_tpu.config import CachePolicy, RunConfig, SampleType
from fgnn_tpu.data import make_synthetic_dataset
from fgnn_tpu.ops.extract import host_gather
from fgnn_tpu.ops.padding import make_plan
from fgnn_tpu_torch import host_engine as the
from fgnn_tpu_torch.models.convert import params_from_flax
from fgnn_tpu_torch.ops import host_lib
from torch_parity import assert_batches_equal, port_cfg, port_ds

torch.set_num_threads(2)

CFG = RunConfig(model="graphsage", fanout=(4, 4), batch_size=128,
                num_hidden=32, sample_type=SampleType.KHOP0, dropout=0.0,
                lr=0.01)
PINSAGE = dict(model="pinsage", sample_type=SampleType.RANDOM_WALK,
               num_random_walk=4, random_walk_length=3,
               random_walk_restart_prob=0.5, num_neighbor=3, num_layer_rw=2)


@pytest.fixture(scope="module")
def ds():
    return make_synthetic_dataset(num_node=2000, avg_degree=8, feat_dim=32,
                                  num_class=8, seed=42)


@pytest.fixture(scope="module")
def graph():
    """A graph with zero-degree vertices, inputs with padding, a global
    edge-weight cumsum."""
    rng = np.random.default_rng(0)
    n = 3000
    deg = rng.integers(0, 40, n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n, indptr[-1]).astype(np.int32)
    inputs = rng.integers(-1, n, 1000).astype(np.int32)
    gcum = np.cumsum(rng.random(len(indices)) + 0.1)
    return indptr, indices, inputs, gcum


@pytest.fixture
def no_native(monkeypatch):
    """The reference's NumPy fallbacks: its library reported missing."""
    for name in ("sample_khop", "sample_weighted_khop", "sample_random_walk",
                 "dedup_remap"):
        monkeypatch.setattr(native, name, lambda *a, **k: None)


# --- the C++ library, bit for bit -------------------------------------------

def test_reference_library_is_built():
    assert native.available()


@pytest.mark.parametrize("replace", [False, True])
def test_sample_khop_bit_equal(graph, replace):
    indptr, indices, inputs, _ = graph
    for fanout in (1, 10, 256):
        np.testing.assert_array_equal(
            native.sample_khop(indptr, indices, inputs, fanout, seed=5,
                               replace=replace),
            host_lib.sample_khop(indptr, indices, inputs, fanout, 5, replace))


@pytest.mark.parametrize("dedup", [False, True])
def test_sample_weighted_khop_bit_equal(graph, dedup):
    indptr, indices, inputs, gcum = graph
    for fanout in (1, 10, 50):
        np.testing.assert_array_equal(
            native.sample_weighted_khop(indptr, indices, gcum, inputs, fanout,
                                        seed=7, dedup=dedup),
            host_lib.sample_weighted_khop(indptr, indices, gcum, inputs,
                                          fanout, 7, dedup))


def test_sample_random_walk_bit_equal(graph):
    indptr, indices, inputs, _ = graph
    for a, b in zip(native.sample_random_walk(indptr, indices, inputs, 4, 3,
                                              0.5, 5, seed=9),
                    host_lib.sample_random_walk(indptr, indices, inputs, 4, 3,
                                                0.5, 5, 9)):
        np.testing.assert_array_equal(a, b)


def test_dedup_remap_bit_equal():
    rng = np.random.default_rng(7)
    for _ in range(50):
        S = int(rng.integers(1, 40))
        cap = S + int(rng.integers(0, 30))
        n_node = int(rng.integers(S + 5, 300))
        cur = np.full(S, -1, np.int32)
        k = int(rng.integers(1, S + 1))
        cur[:k] = rng.choice(n_node, k, replace=False)
        nbr = rng.integers(-1, n_node, S * 4).astype(np.int32)
        a, b = native.dedup_remap(cur, nbr, cap), host_lib.dedup_remap(
            cur, nbr, cap)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]
        np.testing.assert_array_equal(a[2], b[2])


def test_failed_build_raises():
    with pytest.raises(RuntimeError, match="host compiler"):
        host_lib.build("fgnn-no-such-compiler")
    with pytest.raises(ValueError, match="at most 256"):
        host_lib.sample_khop(np.zeros(2, np.int64), np.zeros(0, np.int32),
                             np.zeros(1, np.int32), 257, 0)


# --- the NumPy hop functions against the reference's -----------------------

@pytest.mark.parametrize("replace", [False, True])
def test_np_khop_hop_matches(graph, no_native, replace):
    indptr, indices, inputs, _ = graph
    a, _ = jhe._np_khop_hop(np.random.default_rng(1), indptr, indices,
                            inputs, 10, replace)
    b, _ = the._np_khop_hop(np.random.default_rng(1), indptr, indices,
                            inputs, 10, replace, plain=True)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dedup", [False, True])
def test_np_weighted_hop_matches(graph, no_native, dedup):
    indptr, indices, inputs, gcum = graph
    a, _ = jhe._np_weighted_hop(np.random.default_rng(2), indptr, indices,
                                gcum, inputs, 10, dedup=dedup)
    b, _ = the._np_weighted_hop(np.random.default_rng(2), indptr, indices,
                                gcum, inputs, 10, dedup=dedup, plain=True)
    np.testing.assert_array_equal(a, b)


def test_np_random_walk_hop_matches(graph, no_native):
    indptr, indices, inputs, _ = graph
    a = jhe._np_random_walk_hop(np.random.default_rng(3), indptr, indices,
                                inputs, 5, 4, 3, 0.5)
    b = the._np_random_walk_hop(np.random.default_rng(3), indptr, indices,
                                inputs, 5, 4, 3, 0.5, plain=True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("plain", [False, True])
def test_np_multi_layer_sample_matches(ds, monkeypatch, plain):
    """The port's library (or, with plain, its NumPy path) against the
    reference's library (or its NumPy fallbacks): the same blocks."""
    if plain:
        for name in ("sample_khop", "dedup_remap"):
            monkeypatch.setattr(native, name, lambda *a, **k: None)
    plan = make_plan(64, [3, 4], ds.num_node)
    seeds = np.full(plan.num_input_cap[0], -1, np.int32)
    seeds[:64] = ds.train_set[:64]
    args = (np.asarray(ds.indptr), np.asarray(ds.indices), seeds, 64, plan)
    jb = jhe.np_multi_layer_sample(np.random.default_rng(0), *args)
    tb = the.np_multi_layer_sample(np.random.default_rng(0), *args,
                                   plain=plain)
    assert_batches_equal(jb, tb)


def test_np_multi_layer_sample_flags_a_clipped_cap(ds):
    """A unique cap too small for the hop's new nodes: the batch reports
    the overflow (the reference reports False), and the clipped picks are
    masked out."""
    plan = make_plan(64, [3, 4], ds.num_node, unique_caps=[70, 120])
    seeds = np.full(plan.num_input_cap[0], -1, np.int32)
    seeds[:64] = ds.train_set[:64]
    b = the.np_multi_layer_sample(np.random.default_rng(0),
                                  np.asarray(ds.indptr),
                                  np.asarray(ds.indices), seeds, 64, plan)
    assert bool(b.overflowed)
    for blk in b.blocks:
        assert bool((blk.src_local[blk.mask] >= 0).all())


# --- whole epochs against the reference ------------------------------------

def reference_epoch_losses(jeng, epoch=0):
    """The reference's run_epoch, step by step: its losses."""
    base = jax.random.key(jeng.cfg.seed + 99)
    losses = []
    for seeds, n, step in jeng.shuffler.batches(epoch):
        batch = jeng._sample(jeng.rng, seeds, n)
        feats = jnp.asarray(host_gather(jeng.ds.feat,
                                        np.asarray(batch.input_nodes),
                                        mod=jeng.ds.feat_mod))
        out = np.asarray(batch.output_nodes)
        labels = jnp.asarray(np.where(out >= 0, jeng.label[np.maximum(out, 0)],
                                      -1))
        key = jax.random.fold_in(base, epoch * jeng.shuffler.num_step + step)
        jeng.state, loss, _ = jeng.train_jit(jeng.state, batch, feats, labels,
                                             key)
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("kw", [
    dict(sample_type=SampleType.KHOP0),
    dict(sample_type=SampleType.WEIGHTED_KHOP_HASH_DEDUP),
    PINSAGE], ids=["khop0", "hash_dedup", "pinsage"])
def test_epoch_matches_reference(ds, kw):
    cfg = CFG.replace(**kw)
    jeng = jhe.HostSamplingEngine(cfg, ds)
    # after the reference built its tables: the port sees the same ones
    teng = the.HostSamplingEngine(port_cfg(cfg), port_ds(ds), "cpu")
    assert dataclasses.asdict(teng.plan) == dataclasses.asdict(jeng.plan)
    teng.model.load_state_dict(params_from_flax(jeng.state.params))
    want = reference_epoch_losses(jeng)
    got = []
    for seeds, n, _ in teng.shuffler.batches(0):
        loss, _, _ = teng.step(seeds, n)
        got.append(float(loss))
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the rng has moved as the reference's
    assert teng.rng.integers(0, 2**62) == jeng.rng.integers(0, 2**62)


def test_presample_ranking_matches_reference(ds):
    cfg = CFG.replace(cache_policy=CachePolicy.PRESAMPLE,
                      cache_percentage=0.2)
    jeng = jhe.HostSamplingEngine(cfg, ds)
    teng = the.HostSamplingEngine(port_cfg(cfg), port_ds(ds), "cpu")
    np.testing.assert_array_equal(jeng._np_presample_ranking(),
                                  teng._presample_ranking())


# --- training checks (mirrors of tests/test_host_engine.py) ----------------

def port_host_engine(ds, **kw):
    return the.HostSamplingEngine(port_cfg(CFG.replace(**kw)), port_ds(ds),
                                  "cpu")


@pytest.mark.parametrize("kw", [
    dict(sample_type=SampleType.KHOP0), dict(sample_type=SampleType.KHOP1),
    dict(sample_type=SampleType.WEIGHTED_KHOP),
    dict(sample_type=SampleType.WEIGHTED_KHOP_PREFIX)],
    ids=["khop0", "khop1", "weighted_khop", "weighted_khop_prefix"])
def test_host_engine_trains(ds, kw):
    eng = port_host_engine(ds, **kw)
    r0, r1 = eng.run_epoch(0), eng.run_epoch(1)
    assert set(r0) == {"epoch", "epoch_time", "loss", "acc", "num_step"}
    assert np.isfinite(r0["loss"]) and r1["loss"] < r0["loss"] + 0.5
    assert not eng.last_overflowed


def test_host_hash_dedup_unique_picks(ds):
    """Per-vertex picks are distinct neighbours; deg <= fanout vertices
    take all of them."""
    eng = port_host_engine(ds, sample_type=SampleType.WEIGHTED_KHOP_HASH_DEDUP)
    seeds, n, _ = next(eng.shuffler.batches(0))
    b = eng.sample(np.random.default_rng(1), seeds, n)
    blk, f = b.blocks[-1], eng.plan.fanouts[-1]
    inp = b.input_nodes.numpy()
    src = blk.src_local.numpy().reshape(-1, f)
    msk = blk.mask.numpy().reshape(-1, f)
    indptr = np.asarray(ds.indptr)
    checked = 0
    for i in range(n):
        live = inp[src[i][msk[i]]]
        assert len(set(live.tolist())) == len(live), (i, live)
        g = inp[i]
        nbrs = set(np.asarray(ds.indices)[indptr[g]:indptr[g + 1]].tolist())
        assert set(live.tolist()) <= nbrs
        if len(nbrs) == indptr[g + 1] - indptr[g] <= f:
            assert len(live) == len(nbrs)
            checked += 1
    assert checked > 0
    assert np.isfinite(eng.run_epoch(0)["loss"])


def test_host_random_walk_pinsage_trains(ds):
    eng = port_host_engine(ds, **PINSAGE)
    r0, r1 = eng.run_epoch(0), eng.run_epoch(1)
    assert np.isfinite(r0["loss"]) and np.isfinite(r1["loss"])
    seeds, n, _ = next(eng.shuffler.batches(0))
    b = eng.sample(np.random.default_rng(2), seeds, n)
    w, m = b.blocks[0].weights, b.blocks[0].mask
    assert w is not None and bool((w[m] >= 1).all())


def test_host_presample_cache_trains(ds):
    """PRESAMPLE 20% over the host sampler: hits and misses counted, the
    combine's rows equal to the uncached gather's."""
    eng = port_host_engine(ds, cache_policy=CachePolicy.PRESAMPLE,
                           cache_percentage=0.2)
    assert eng.cache is not None and eng.cache.num_cache == 400
    r = eng.run_epoch(0)
    assert np.isfinite(r["loss"])
    assert 0 < r["miss_bytes"] < r["feature_bytes"]
    seeds, n, _ = next(eng.shuffler.batches(1))
    b = eng.sample(np.random.default_rng(3), seeds, n)
    cached = eng.features(b, b)
    eng.cache = None
    np.testing.assert_array_equal(cached.numpy(), eng.features(b, b).numpy())
