"""KHOP1, the weighted samplers and the direct-index dedup: the port against
the JAX package, fed the reference's own draws (``jax.random.uniform`` of
the keys it splits), must give the same picks, masks, blocks, unique lists
and overflow flags, exactly. On the port's own generator the picks must
follow the weights (mirrors of tests/test_sampling.py and
tests/test_weighted_hash_dedup.py).

The graph mixes the hash-dedup sampler's three degree regimes: deg <=
fanout (take-all), fanout < deg <= 128 (Gumbel top-k) and deg > 128 (the
oversampled stream)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgnn_tpu.config import SampleType
from fgnn_tpu.data.schema import Dataset
from fgnn_tpu.data.synthetic import build_alias_tables
from fgnn_tpu.ops import hashtable as jhash
from fgnn_tpu.ops import sampling as jsamp
from fgnn_tpu.ops.padding import make_plan
from fgnn_tpu.ops.reference_impl import calibrate_caps
from fgnn_tpu_torch.config import SampleType as TSampleType
from fgnn_tpu_torch.data.schema import Dataset as TDataset
from fgnn_tpu_torch.data.synthetic import build_alias_tables as t_build_tables
from fgnn_tpu_torch.ops import hashtable as thash
from fgnn_tpu_torch.ops import sampling as tsamp
from fgnn_tpu_torch.ops import padding as tpadding
from torch_parity import (assert_batches_equal, jax_hop_uniforms,
                          jax_uniforms, to_torch)

torch.set_num_threads(2)

NEW_TYPES = ("khop1", "weighted_khop", "weighted_khop_prefix",
             "weighted_khop_hash_dedup")
N = 600


@pytest.fixture(scope="module")
def wds():
    """600 nodes: 40% of degree 0-8, 40% of 9-128, 20% of 129-299."""
    rng = np.random.default_rng(0)
    deg = np.concatenate([rng.integers(0, 9, 240), rng.integers(9, 129, 240),
                          rng.integers(129, 300, 120)])
    rng.shuffle(deg)
    indptr = np.zeros(N + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    E = int(indptr[-1])
    ds = Dataset(name="wmix", num_node=N, num_edge=E, num_class=4,
                 indptr=indptr,
                 indices=rng.integers(0, N, E).astype(np.int32),
                 feat=np.zeros((N, 1), np.float32),
                 label=np.zeros(N, np.int32),
                 train_set=np.arange(N, dtype=np.int32),
                 valid_set=np.zeros(0, np.int32),
                 test_set=np.zeros(0, np.int32))
    build_alias_tables(ds, seed=3)
    return ds


def _pad_lane(a):
    """The reference engine's lane padding of the per-edge arrays."""
    rem = (-len(a)) % jsamp.INDICES_LANE
    return np.pad(a, (0, rem)) if rem else a


@pytest.fixture(scope="module")
def graphs(wds):
    """The reference's graph as its engine builds it (lane-padded tables)
    and the port's (unpadded)."""
    jg = jsamp.CSRGraph(
        indptr=jnp.asarray(wds.indptr.astype(np.int32)),
        indices=jnp.asarray(_pad_lane(wds.indices)),
        prob_table=jnp.asarray(_pad_lane(wds.prob_table)),
        alias_table=jnp.asarray(_pad_lane(wds.alias_table)),
        prob_prefix_table=jnp.asarray(_pad_lane(wds.prob_prefix_table)))
    tg = tsamp.CSRGraph(
        indptr=torch.from_numpy(wds.indptr),
        indices=torch.from_numpy(wds.indices),
        prob_table=torch.from_numpy(wds.prob_table),
        alias_table=torch.from_numpy(wds.alias_table),
        prob_prefix_table=torch.from_numpy(wds.prob_prefix_table))
    return jg, tg


def hop_rows(wds, n=400, seed=0):
    """(nodes, off, deg) of ``n`` random vertices."""
    nodes = np.random.default_rng(seed).integers(0, N, n).astype(np.int32)
    off = wds.indptr[nodes]
    return nodes, off, (wds.indptr[nodes + 1] - off).astype(np.int32)


def assert_same(j, t):
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# --- each sampler, the reference's draws injected -------------------------

@pytest.mark.parametrize("fanout", [3, 10])
def test_with_replacement_matches(fanout):
    deg = np.array([0, 1, 2, 9, 10, 11, 129, 1000, 2**24 + 3] * 30, np.int32)
    key = jax.random.key(fanout)
    j = jsamp._with_replacement(key, jnp.asarray(deg), fanout)
    u = to_torch(jax.random.uniform(key, (deg.shape[0], fanout)))
    assert_same(j, tsamp._with_replacement(u, torch.from_numpy(deg), fanout))


@pytest.mark.parametrize("fanout", [3, 10])
def test_weighted_alias_matches(wds, graphs, fanout):
    jg, tg = graphs
    _, off, deg = hop_rows(wds)
    key = jax.random.key(10 + fanout)
    j = jsamp._weighted_alias(key, jnp.asarray(deg),
                              jnp.asarray(off.astype(np.int32)), jg, fanout)
    u = to_torch(jax_hop_uniforms(key, (deg.shape[0], 2 * fanout),
                                  "weighted_khop"))
    assert_same(j, tsamp._weighted_alias(u, torch.from_numpy(deg),
                                         torch.from_numpy(off), tg, fanout))


@pytest.mark.parametrize("fanout", [3, 10])
def test_weighted_prefix_matches(wds, graphs, fanout):
    """The 32-step binary search over the float32 ``u * total``: picks bit
    for bit."""
    jg, tg = graphs
    _, off, deg = hop_rows(wds, seed=1)
    key = jax.random.key(20 + fanout)
    j = jsamp._weighted_prefix(key, jnp.asarray(deg),
                               jnp.asarray(off.astype(np.int32)), jg, fanout)
    u = to_torch(jax.random.uniform(key, (deg.shape[0], fanout)))
    assert_same(j, tsamp._weighted_prefix(u, torch.from_numpy(deg),
                                          torch.from_numpy(off), tg, fanout))


@pytest.mark.parametrize("k", [1, 5, 10])
def test_first_k_distinct_matches(k):
    """Rows with repeats, -1 entries and fewer than k distinct values."""
    rng = np.random.default_rng(k)
    idx = rng.integers(-1, 12, (300, 4 * k)).astype(np.int32)
    idx[:50] = rng.integers(0, 3, (50, 4 * k))          # short rows
    j = jsamp._first_k_distinct(jnp.asarray(idx), k)
    assert_same(j, tsamp._first_k_distinct(torch.from_numpy(idx), k))


@pytest.mark.parametrize("fanout", [3, 10])
def test_weighted_gumbel_dedup_matches(wds, graphs, fanout):
    """Every branch: take-all, Gumbel top-k and the stream."""
    jg, tg = graphs
    _, off, deg = hop_rows(wds, n=600, seed=2)
    assert (deg <= fanout).any() and (deg > 128).any()
    assert ((deg > fanout) & (deg <= 128)).any()
    key = jax.random.key(30 + fanout)
    j = jsamp._weighted_gumbel_dedup(key, jnp.asarray(deg),
                                     jnp.asarray(off.astype(np.int32)), jg,
                                     fanout)
    width = tsamp.draw_width(TSampleType.WEIGHTED_KHOP_HASH_DEDUP, fanout)
    u = to_torch(jax_hop_uniforms(key, (deg.shape[0], width),
                                  "weighted_khop_hash_dedup"))
    assert_same(j, tsamp._weighted_gumbel_dedup(
        u, torch.from_numpy(deg), torch.from_numpy(off), tg, fanout))


@pytest.mark.parametrize("st", NEW_TYPES)
def test_sample_layer_matches(wds, graphs, st):
    jg, tg = graphs
    fanout = 10
    nodes, _, _ = hop_rows(wds, n=300, seed=3)
    nodes[np.random.default_rng(4).random(300) < 0.2] = -1
    key = jax.random.key(40)
    jn, jv, _ = jsamp.sample_layer(key, jg, jnp.asarray(nodes), fanout,
                                   SampleType(st))
    width = tsamp.draw_width(TSampleType(st), fanout)
    u = to_torch(jax_hop_uniforms(key, (300, width), st))
    assert_same((jn, jv), tsamp.sample_layer(tg, torch.from_numpy(nodes),
                                             fanout, TSampleType(st), u))


def test_sample_layer_names_the_missing_tables(graphs):
    _, tg = graphs
    bare = tsamp.CSRGraph(indptr=tg.indptr, indices=tg.indices)
    with pytest.raises(ValueError, match="build_alias_tables"):
        tsamp.sample_layer(bare, torch.zeros(4, dtype=torch.int32), 3,
                           TSampleType.WEIGHTED_KHOP_PREFIX,
                           torch.Generator().manual_seed(0))


@pytest.mark.parametrize("mode", ["no-dedup last hop", "dedup", "direct"])
@pytest.mark.parametrize("st", NEW_TYPES)
def test_multi_layer_sample_matches(wds, graphs, monkeypatch, st, mode):
    """Two hops (fanouts [10, 3] deepest first), the plain no-dedup last
    hop (``_append_slots``, never tiered for these samplers), every hop
    deduped by the sort, or by the direct-index table."""
    jg, tg = graphs
    if mode == "direct":
        monkeypatch.setattr(jsamp, "DIRECT_REMAP_MAX_NODES", N)
        monkeypatch.setattr(tsamp, "DIRECT_REMAP_MAX_NODES", N)
    fanouts, B = (10, 3), 64
    caps = calibrate_caps(wds.indptr, wds.indices, wds.train_set, B,
                          list(reversed(fanouts)),
                          replace=st == "khop1")
    plan = make_plan(B, fanouts, N, unique_caps=caps)
    seeds = np.full(plan.num_input_cap[0], -1, np.int32)
    seeds[:B] = np.random.default_rng(5).choice(N, B, replace=False)
    dedup = mode != "no-dedup last hop"
    key = jax.random.key(50)
    jbatch = jax.jit(lambda k: jsamp.multi_layer_sample(
        k, jg, jnp.asarray(seeds), jnp.int32(B), plan, SampleType(st),
        dedup_last_hop=dedup))(key)
    tplan = tpadding.make_plan(B, fanouts, N, unique_caps=caps)
    rand = jax_uniforms(key, tsamp.uniform_shapes(tplan, TSampleType(st),
                                                  dedup), st)
    tbatch = tsamp.multi_layer_sample(
        tg, torch.from_numpy(seeds), B, tplan, TSampleType(st),
        dedup_last_hop=dedup, rand=rand)
    assert_batches_equal(jbatch, tbatch)
    assert tbatch.blocks[0].tier_split is None
    assert (tbatch.blocks[0].src_slice_offset is None) == dedup


# --- the direct-index dedup: tests/test_direct_remap.py's cases ------------

def _direct_case(seed):
    rng = np.random.default_rng(seed)
    n_node, S, E, cap = 500, 32, 256, 128
    seeds = np.full(S, -1, np.int32)
    seeds[:20] = rng.choice(n_node, 20, replace=False)
    nbrs = np.full(E, -1, np.int32)
    nbrs[:180] = rng.integers(0, n_node, 180)
    return seeds, 20, nbrs[rng.permutation(E)], cap, n_node


def _overflow_case():
    # room for only 4 new nodes
    return (np.arange(8, dtype=np.int32), 8,
            np.resize(np.arange(20, 70, dtype=np.int32), 64), 12, 100)


@pytest.mark.parametrize("case", ["seed 0", "seed 1", "seed 2", "overflow"])
def test_unique_and_remap_direct_matches(case):
    seeds, n, nbrs, cap, n_node = (_overflow_case() if case == "overflow"
                                   else _direct_case(int(case[-1])))
    j = jhash.unique_and_remap_direct(jnp.asarray(seeds), jnp.int32(n),
                                      jnp.asarray(nbrs), cap, n_node)
    args = (torch.from_numpy(seeds), torch.tensor(n, dtype=torch.int32),
            torch.from_numpy(nbrs), cap)
    t = thash.unique_and_remap_direct(*args, n_node)
    assert_same(j, t)
    for a, b in zip(thash.unique_and_remap(*args), t):
        assert torch.equal(a, b)
    if case == "overflow":
        assert bool(t[3]) and int(t[1]) == cap


# --- the port's own generator ---------------------------------------------

def _star(deg):
    """Vertex 0 with neighbours 1..deg, its tables from the port's
    ``build_alias_tables`` (random weights), and those weights normalised,
    recovered from the prefix table."""
    ds = TDataset(name="star", num_node=deg + 1, num_edge=deg, num_class=2,
                  indptr=np.array([0] + [deg] * (deg + 1), np.int64),
                  indices=np.arange(1, deg + 1, dtype=np.int32),
                  feat=np.zeros((deg + 1, 1), np.float32),
                  label=np.zeros(deg + 1, np.int32),
                  train_set=np.zeros(1, np.int32),
                  valid_set=np.zeros(0, np.int32),
                  test_set=np.zeros(0, np.int32))
    t_build_tables(ds, seed=1)
    w = np.asarray(ds.prob_prefix_table, np.float64)
    w = np.concatenate([w[:1], np.diff(w)])
    g = tsamp.CSRGraph(indptr=torch.from_numpy(ds.indptr),
                       indices=torch.from_numpy(ds.indices),
                       prob_table=torch.from_numpy(ds.prob_table),
                       alias_table=torch.from_numpy(ds.alias_table),
                       prob_prefix_table=torch.from_numpy(ds.prob_prefix_table))
    return g, w / w.sum()


@pytest.mark.parametrize("st", ["weighted_khop", "weighted_khop_prefix"])
def test_weighted_picks_follow_the_weights(st):
    """20,000 picks of a degree-8 vertex: each neighbour's share within
    0.02 of its normalised weight (mirror of test_native_samplers.py's
    weight check)."""
    g, p = _star(8)
    nbrs, valid = tsamp.sample_layer(g, torch.zeros(2000, dtype=torch.int32),
                                     10, TSampleType(st),
                                     torch.Generator().manual_seed(0))
    assert bool(valid.all())
    emp = np.bincount(nbrs.numpy(), minlength=9)[1:] / nbrs.shape[0]
    assert np.abs(emp - p).max() < 0.02, (emp, p)


def test_khop1_uniform_with_replacement():
    """800 rows of fanout 3 from one degree-10 vertex: uniform over the
    neighbours (5-sigma band), and rows repeat picks (with replacement)."""
    g = tsamp.CSRGraph(indptr=torch.tensor([0, 10, 10]),
                       indices=torch.arange(10, dtype=torch.int32))
    nbrs, valid = tsamp.sample_layer(g, torch.zeros(800, dtype=torch.int32),
                                     3, TSampleType.KHOP1,
                                     torch.Generator().manual_seed(0))
    assert bool(valid.all())
    rows = nbrs.reshape(800, 3).numpy()
    assert any(len(set(r)) < 3 for r in rows)
    counts = np.bincount(rows.reshape(-1), minlength=10)
    assert np.all(np.abs(counts - 240) < 5 * np.sqrt(240)), counts


FANOUT = 8
DEGS = [3, 20, 200]   # one vertex per hash-dedup regime


@pytest.fixture(scope="module")
def dedup_graph():
    indptr = np.concatenate([[0], np.cumsum(DEGS)]).astype(np.int64)
    E = int(indptr[-1])
    ds = TDataset(name="wdedup", num_node=len(DEGS), num_edge=E, num_class=2,
                  indptr=indptr,
                  indices=np.arange(E, dtype=np.int32) % 1000 + 10,
                  feat=np.zeros((len(DEGS), 1), np.float32),
                  label=np.zeros(len(DEGS), np.int32),
                  train_set=np.arange(len(DEGS), dtype=np.int32),
                  valid_set=np.zeros(0, np.int32),
                  test_set=np.zeros(0, np.int32))
    t_build_tables(ds, seed=3)
    g = tsamp.CSRGraph(indptr=torch.from_numpy(indptr),
                       indices=torch.from_numpy(ds.indices),
                       prob_table=torch.from_numpy(ds.prob_table),
                       alias_table=torch.from_numpy(ds.alias_table),
                       prob_prefix_table=torch.from_numpy(ds.prob_prefix_table))
    w = np.asarray(ds.prob_prefix_table, np.float64).copy()
    for v in range(len(DEGS)):
        o, e = int(indptr[v]), int(indptr[v + 1])
        w[o + 1:e] = np.diff(w[o:e])
    return g, indptr, w


def _dedup_counts(g, indptr, trials):
    """Per vertex, how often each slot was picked in ``trials`` hash-dedup
    draws on the port's generator; picks distinct, take-all kept whole."""
    inputs = torch.arange(len(DEGS), dtype=torch.int32).repeat(trials)
    out, _ = tsamp.sample_layer(g, inputs, FANOUT,
                                TSampleType.WEIGHTED_KHOP_HASH_DEDUP,
                                torch.Generator().manual_seed(0))
    out = out.numpy().reshape(trials, len(DEGS), FANOUT)
    counts = [np.zeros(d) for d in DEGS]
    for v, d in enumerate(DEGS):
        o = int(indptr[v])
        for t in range(trials):
            live = out[t, v][out[t, v] >= 0]
            assert len(set(live.tolist())) == len(live), "duplicate pick"
            assert len(live) == min(d, FANOUT), (v, t, live)
            np.add.at(counts[v], live - 10 - o, 1)
    return counts


def _golden_counts(indptr, w, trials, seed):
    """The source sampler's semantics: alias draws, rejecting repeats,
    until FANOUT distinct picks (take-all when deg <= FANOUT)."""
    rng = np.random.default_rng(seed)
    counts = [np.zeros(d) for d in DEGS]
    for v, d in enumerate(DEGS):
        o = int(indptr[v])
        p = w[o:o + d] / w[o:o + d].sum()
        if d <= FANOUT:
            counts[v][:] = trials
            continue
        for _ in range(trials):
            picked = set()
            while len(picked) < FANOUT:
                picked.add(int(rng.choice(d, p=p)))
            for j in picked:
                counts[v][j] += 1
    return counts


def test_hash_dedup_distribution_matches_golden(dedup_graph):
    """Mirror of test_weighted_hash_dedup.py: per weight-quintile inclusion
    mass within a 5-sigma band of the rejection loop's."""
    g, indptr, w = dedup_graph
    trials = 1200
    ours = _dedup_counts(g, indptr, trials)
    gold = _golden_counts(indptr, w, trials, seed=11)
    for v, d in enumerate(DEGS):
        if d <= FANOUT:
            continue
        o = int(indptr[v])
        order = np.argsort(w[o:o + d])
        for b in range(5):
            sl = order[b * d // 5:(b + 1) * d // 5]
            a, c = ours[v][sl].sum(), gold[v][sl].sum()
            assert abs(a - c) < 5 * np.sqrt(max(c, 1.0) * 2) + 0.02 * trials, (
                v, b, a, c)


def test_gumbel_branch_prefers_heavy_neighbors(dedup_graph):
    g, indptr, w = dedup_graph
    ours = _dedup_counts(g, indptr, 400)
    v, d = 1, DEGS[1]
    o = int(indptr[v])
    heavy, light = np.argmax(w[o:o + d]), np.argmin(w[o:o + d])
    assert ours[v][heavy] > ours[v][light]
