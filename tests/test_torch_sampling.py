"""Sampling and dedup: the port against the JAX package, fed the same
uniforms (the reference's own ``jax.random.uniform`` draws), must give the
same picks, locals, masks, unique lists, ``dst_invperm`` and overflow flags,
exactly."""
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgnn_tpu.config import SampleType
from fgnn_tpu.data import make_synthetic_dataset
from fgnn_tpu.ops import hashtable as jhash
from fgnn_tpu.ops import sampling as jsamp
from fgnn_tpu_torch.ops import hashtable as thash
from fgnn_tpu_torch.ops import sampling as tsamp
from fgnn_tpu_torch.ops.padding import make_plan
from fgnn_tpu_torch.ops.reference_impl import calibrate_caps
from torch_parity import (assert_batches_equal, assert_blocks_equal,
                          jax_uniforms, to_numpy, to_torch)

torch.set_num_threads(2)
KHOP2 = SampleType.KHOP2


@pytest.fixture(scope="module")
def ds():
    return make_synthetic_dataset(num_node=5000, avg_degree=12, feat_dim=16,
                                  num_class=4, seed=11)


@pytest.fixture(scope="module")
def graphs(ds):
    indptr = np.asarray(ds.indptr)
    indices = np.asarray(ds.indices)
    jg = jsamp.CSRGraph(indptr=jnp.asarray(indptr.astype(np.int32)),
                        indices=jnp.asarray(indices))
    tg = tsamp.CSRGraph(indptr=torch.from_numpy(indptr.astype(np.int64)),
                        indices=torch.from_numpy(indices.astype(np.int32)))
    return jg, tg


def plan_for(ds, batch_size=256, fanouts=(25, 10), tiers=True):
    caps, stats = calibrate_caps(
        np.asarray(ds.indptr), np.asarray(ds.indices),
        np.asarray(ds.train_set), batch_size, list(reversed(fanouts)),
        tier_candidates=(4, 6, 8, 10, 12, 16))
    return make_plan(batch_size, fanouts, ds.num_node, unique_caps=caps,
                     tier_stats=stats if tiers else None)


def seeds_for(ds, plan, seed=0):
    s = np.full((plan.num_input_cap[0],), -1, np.int32)
    s[:plan.batch_size] = np.random.default_rng(seed).choice(
        np.asarray(ds.train_set), size=plan.batch_size, replace=False)
    return s


# --- dedup: the cases of tests/test_fused_remap.py ----------------------

def _case(rng, n_seed, S, E, pool):
    seeds = rng.choice(pool, size=n_seed, replace=False).astype(np.int32)
    seeds_pad = np.full(S, -1, np.int32)
    seeds_pad[:n_seed] = seeds
    nbrs = rng.choice(pool, size=E).astype(np.int32)
    nbrs[rng.random(E) < 0.1] = -1  # padding holes
    return seeds_pad, n_seed, nbrs


def _remap_cases():
    cases = []
    rng = np.random.default_rng(0)
    for _ in range(6):
        cases.append(_case(rng, 40, 64, 300, 2000) + (512,))
    cases.append(_case(np.random.default_rng(3), 50, 64, 400, 500) + (640,))
    rng = np.random.default_rng(7)
    for _ in range(5):
        cases.append(_case(rng, 40, 64, 300, 150) + (512,))
    cases.append((np.array([0, 1], np.int32), 2,
                  np.array([5, 6, 7, 8, 9, 10], np.int32), 4))
    cases.append((np.array([0, 1], np.int32), 2,
                  np.array([5, 5, 6, 7, 8, 9, 0], np.int32), 4))
    return cases


@pytest.mark.parametrize("case", range(len(_remap_cases())))
def test_unique_and_remap_matches(case):
    seeds, n, nbrs, cap = _remap_cases()[case]
    ju, jn, jl, jo = jhash.unique_and_remap(
        jnp.asarray(seeds), jnp.int32(n), jnp.asarray(nbrs), cap)
    tu, tn, tl, to = thash.unique_and_remap(
        torch.from_numpy(seeds), torch.tensor(n, dtype=torch.int32),
        torch.from_numpy(nbrs), cap)
    np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    assert int(jn) == int(tn) and bool(jo) == bool(to)
    assert tu.dtype == tl.dtype == torch.int32


# --- samplers with injected uniforms ------------------------------------

def test_floyd_matches_on_degree_edge_cases():
    """deg 0, deg < fanout, deg == fanout and degrees up to 2^24 + 3, where
    float32(J + 1) rounds: the draw must be taken in float32 as in JAX."""
    fanout = 10
    deg = np.array([0, 1, 9, 10, 11, 25, 1000, 2**24 + 3, 123456789] * 40,
                   np.int32)
    key = jax.random.key(5)
    jp, jv = jsamp._floyd_without_replacement(key, jnp.asarray(deg), fanout)
    u = to_torch(jax.random.uniform(key, (deg.shape[0], fanout)))
    tp, tv = tsamp._floyd_without_replacement(u, torch.from_numpy(deg), fanout)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("fanout", [3, 25])
def test_sample_layer_matches(ds, graphs, fanout):
    jg, tg = graphs
    rng = np.random.default_rng(fanout)
    inputs = rng.integers(0, ds.num_node, 300).astype(np.int32)
    inputs[rng.random(300) < 0.2] = -1
    key = jax.random.key(fanout)
    jn, jv, _ = jsamp.sample_layer(key, jg, jnp.asarray(inputs), fanout, KHOP2)
    u = to_torch(jax.random.uniform(key, (300, fanout)))
    tn, tv = tsamp.sample_layer(tg, torch.from_numpy(inputs), fanout, KHOP2, u)
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("layout", ["plan", "clipping"])
def test_tiered_last_hop_matches(ds, graphs, layout):
    jg, tg = graphs
    plan = plan_for(ds)
    V = plan.num_input_cap[-1]
    tier_layout = plan.tier_layout
    if layout == "clipping":
        # a tier-0 cap far below the high-degree count: overflow must flag
        tier_layout = ((128, 25), (V - 128, 10))
    rng = np.random.default_rng(1)
    cur = rng.integers(0, ds.num_node, V).astype(np.int32)
    cur[rng.random(V) < 0.1] = -1
    num_cur = int((cur >= 0).sum())
    key = jax.random.key(9)
    jb, ju, jn, jo = jsamp._tiered_last_hop(
        key, jg, jnp.asarray(cur), jnp.int32(num_cur), tier_layout, False)
    u = to_torch(jax.random.uniform(key, tier_layout[0]))
    tb, tu, tn, to = tsamp._tiered_last_hop(
        tg, torch.from_numpy(cur), torch.tensor(num_cur, dtype=torch.int32),
        tier_layout, u)
    assert_blocks_equal(jb, tb)
    np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
    assert int(jn) == int(tn)
    assert bool(jo) == bool(to) == (layout == "clipping")


@pytest.mark.parametrize("mode", ["tiered", "flat no-dedup", "dedup",
                                  "dedup clipping"])
def test_multi_layer_sample_matches(ds, graphs, mode):
    jg, tg = graphs
    plan = plan_for(ds, tiers=mode == "tiered")
    if mode == "dedup clipping":
        plan = make_plan(256, (25, 10), ds.num_node, unique_caps=[300, 700])
    dedup = mode.startswith("dedup")
    seeds = seeds_for(ds, plan)
    key = jax.random.key(13)
    jbatch = jax.jit(lambda k: jsamp.multi_layer_sample(
        k, jg, jnp.asarray(seeds), jnp.int32(plan.batch_size), plan, KHOP2,
        dedup_last_hop=dedup))(key)
    rand = jax_uniforms(key, tsamp.uniform_shapes(plan, KHOP2, dedup))
    tbatch = tsamp.multi_layer_sample(
        tg, torch.from_numpy(seeds), plan.batch_size, plan, KHOP2,
        dedup_last_hop=dedup, rand=rand)
    assert_batches_equal(jbatch, tbatch)
    assert (tbatch.blocks[0].tier_split is not None) == (mode == "tiered")
    assert bool(tbatch.overflowed) == (mode == "dedup clipping")


def test_injected_uniforms_are_checked(ds, graphs):
    _, tg = graphs
    with pytest.raises(ValueError, match="uniforms"):
        tsamp.sample_layer(tg, torch.zeros(4, dtype=torch.int32), 3, KHOP2,
                           torch.zeros(4, 2))


# --- the port's own generator -------------------------------------------

def test_tiered_sampling_distribution_with_generator(ds, graphs):
    """Mirror of test_tiered_hop.py::test_tiered_sampling_distribution on
    the port's own torch generator: deg <= fB vertices take ALL neighbours
    exactly once; deg > fB vertices get min(deg, f) true neighbours."""
    _, tg = graphs
    plan = plan_for(ds)
    batch = tsamp.multi_layer_sample(
        tg, torch.from_numpy(seeds_for(ds, plan)), plan.batch_size, plan,
        KHOP2, dedup_last_hop=False, rand=torch.Generator().manual_seed(0))
    assert not bool(batch.overflowed)
    blk = batch.blocks[0]
    assert blk.tier_split is not None
    indptr, indices = np.asarray(ds.indptr), np.asarray(ds.indices)
    V = blk.dst_invperm.shape[0]
    inputs = to_numpy(batch.input_nodes)
    fr_ids = inputs[:V]
    mask = to_numpy(blk.mask)
    dst = to_numpy(blk.dst_local)[mask]
    nbr = inputs[V:][mask]
    f, fB = plan.fanouts[-1], plan.tier_b_fanout
    per_dst = {}
    for d, nb in zip(dst, nbr):
        per_dst.setdefault(int(d), []).append(int(nb))
    checked_small = checked_big = 0
    for d, nbs in per_dst.items():
        vid = fr_ids[d]
        assert vid >= 0
        true_nbrs = indices[indptr[vid]:indptr[vid + 1]].tolist()
        # CSR slots are sampled; the synthetic graph is a multigraph
        assert not (Counter(nbs) - Counter(true_nbrs))
        if len(true_nbrs) <= fB:
            assert sorted(nbs) == sorted(true_nbrs)
            checked_small += 1
        else:
            assert len(nbs) == min(len(true_nbrs), f)
            checked_big += 1
    assert checked_small > 10 and checked_big > 10


def test_khop2_uniformity_with_generator():
    """Mirror of test_sampling.py::test_khop2_uniformity on the port's own
    generator: picks are distinct per row and uniform over the neighbours
    (800 draws of one degree-10 vertex in one call, 5-sigma band)."""
    n_nbr, fanout, trials = 10, 3, 800
    g = tsamp.CSRGraph(indptr=torch.tensor([0, n_nbr, n_nbr]),
                       indices=torch.arange(n_nbr, dtype=torch.int32))
    nbrs, valid = tsamp.sample_layer(g, torch.zeros(trials, dtype=torch.int32),
                                     fanout, KHOP2,
                                     torch.Generator().manual_seed(0))
    assert bool(valid.all())
    rows = nbrs.reshape(trials, fanout).numpy()
    assert all(len(set(r)) == fanout for r in rows)
    counts = np.bincount(rows.reshape(-1), minlength=n_nbr)
    expected = trials * fanout / n_nbr
    assert np.all(np.abs(counts - expected) < 5 * np.sqrt(expected)), counts
