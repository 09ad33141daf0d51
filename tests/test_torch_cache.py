"""The port's feature caches against the JAX package's: the host gather, the
miss/hit split and the combine of the static cache, every ranking policy,
presampling with the reference's uniforms injected, and the dynamic
previous-batch cache over a sequence of batches. Ids, ranks, slots, counts
and rankings are exact; combined features are bit-equal in float32 and
bfloat16 (the combine only moves values). The policy ordering of
tests/test_policy_ordering.py is mirrored on the port's own generator."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fgnn_tpu import native
from fgnn_tpu.cache import dynamic as jdyn
from fgnn_tpu.cache import manager as jman
from fgnn_tpu.cache import policy as jpolicy
from fgnn_tpu.cache import presample as jpre
from fgnn_tpu.config import CachePolicy as JPolicy
from fgnn_tpu.config import RunConfig, SampleType
from fgnn_tpu.data import make_synthetic_dataset
from fgnn_tpu.ops import padding as jpadding
from fgnn_tpu.ops import sampling as jsamp
from fgnn_tpu.ops.extract import host_gather as jhost_gather
from fgnn_tpu.parallel.shuffler import EpochShuffler as JShuffler
from fgnn_tpu_torch.cache import dynamic as tdyn
from fgnn_tpu_torch.cache import manager as tman
from fgnn_tpu_torch.cache import policy as tpolicy
from fgnn_tpu_torch.cache import presample as tpre
from fgnn_tpu_torch.config import CachePolicy as TPolicy
from fgnn_tpu_torch.config import SampleType as TSampleType
from fgnn_tpu_torch.engine import OneChipEngine
from fgnn_tpu_torch.ops import sampling as tsamp
from fgnn_tpu_torch.ops.extract import HostFeatures, host_gather, host_table
from fgnn_tpu_torch.ops.padding import make_plan
from fgnn_tpu_torch.ops.reference_impl import calibrate_caps
from fgnn_tpu_torch.parallel.shuffler import EpochShuffler
from torch_parity import jax_uniforms, port_cfg, port_ds, to_numpy

torch.set_num_threads(2)


def feat_table(num_node, dim, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (num_node, dim)).astype(np.float32)


# --- host gather and bf16 staging ----------------------------------------

@pytest.mark.parametrize("mod", [0, 37])
def test_host_gather_matches_reference(mod):
    feat = feat_table(200, 8)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 200, 500).astype(np.int32)
    ids[rng.random(500) < 0.2] = -1
    t = host_gather(host_table(feat), torch.from_numpy(ids), mod)
    np.testing.assert_array_equal(t.numpy(), jhost_gather(feat, ids, mod=mod))
    # n_real: rows past it are zero, as native.gather_f32's partial gather
    t = host_gather(host_table(feat), torch.from_numpy(ids), n_real=300)
    np.testing.assert_array_equal(
        t.numpy(), native.gather_f32(feat, ids, n_real=300))
    out = torch.full((600, 8), 7.0)
    host_gather(host_table(feat), torch.from_numpy(ids), out=out)
    np.testing.assert_array_equal(out[:500].numpy(), jhost_gather(feat, ids))
    assert bool((out[500:] == 7.0).all())


def test_bf16_staging_rounds_like_ml_dtypes():
    """float32 -> bfloat16 staging rounds to nearest even, as ml_dtypes
    (the reference's host conversion) does: ties both ways, the largest
    finite values, subnormals, infinities and signed zeros."""
    rng = np.random.default_rng(2)
    bits = np.concatenate([
        rng.integers(0, 2**32, 20000, dtype=np.uint64).astype(np.uint32),
        np.array([0x3F808000, 0x3F818000, 0x3F80C000, 0x3F817FFF, 0x7F7FFFFF,
                  0xFF7FFFFF, 0x7F7F8000, 0x00008000, 0x00018000, 0x00000001,
                  0x7F800000, 0xFF800000, 0x00000000, 0x80000000],
                 dtype=np.uint32)])
    x = bits.view(np.float32)
    x = x[~np.isnan(x)]
    want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(got.view(np.uint16), want)


def test_host_features_fetch_and_load_on_the_cpu():
    feat = feat_table(300, 6)
    host = HostFeatures(feat, torch.device("cpu"))
    ids = torch.tensor([5, -1, 7, 299, 0, -1], dtype=torch.int32)
    rows, counts, ready = host.load(host.fetch(ids, torch.tensor([3, 9],
                                                dtype=torch.int32)),
                                    torch.float32)
    assert ready is None and counts == [3, 9]
    np.testing.assert_array_equal(rows.numpy(), jhost_gather(feat, ids.numpy()[:3]))
    rows, _, _ = host.load(host.fetch(ids, torch.tensor([6], dtype=torch.int32)),
                           torch.bfloat16, compact=False)
    assert rows.dtype == torch.bfloat16 and rows.shape == (6, 6)
    np.testing.assert_array_equal(
        rows.view(torch.int16).numpy().view(np.uint16),
        jhost_gather(feat, ids.numpy()).astype(ml_dtypes.bfloat16).view(np.uint16))
    c = host.counters()
    assert c["gather_rows"] == 9 and c["gather_bytes"] == 9 * 6 * 4
    assert c["upload_bytes"] == 0 and c["gather_s"] >= 0.0


# --- static cache: split and combine --------------------------------------

def split_cases():
    """tests/test_cache.py's cases: a 30% cache with padding, a bucket
    larger than the real ids, a 0% and a 100% cache; plus duplicate ids."""
    rng = np.random.default_rng(0)
    ids1 = np.concatenate([rng.choice(200, 40, replace=False),
                           np.full(8, -1)]).astype(np.int32)
    ids2 = np.full(5000, -1, np.int32)
    ids2[:300] = rng.choice(50_000, 300, replace=False)
    ids3 = np.array([3, 10, -1], np.int32)
    ids4 = np.array([4, 4, -1, 9, 4, 120, -1, 9], np.int32)
    return [("30% with padding", 200, 0.3, ids1),
            ("bucket", 50_000, 0.5, ids2),
            ("0%", 50, 0.0, ids3), ("100%", 50, 1.0, ids3),
            ("duplicates", 200, 0.3, ids4)]


CASES = split_cases()


def caches(num_node, pct, dtype, seed=0):
    feat = feat_table(num_node, 8, seed)
    ranking = np.random.default_rng(seed + 5).permutation(num_node).astype(np.int32)
    jc = jman.FeatureCache(feat, ranking, pct, num_node,
                           dtype=jnp.bfloat16 if dtype == "bfloat16" else None)
    tc = tman.FeatureCache(HostFeatures(feat, torch.device("cpu")), ranking,
                           pct, num_node,
                           dtype=torch.bfloat16 if dtype == "bfloat16" else None)
    return feat, jc, tc


def as_f32(t):
    return to_numpy(t).astype(np.float32)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_miss_cache_index_is_exact(case):
    _, num_node, pct, ids = case
    _, jc, tc = caches(num_node, pct, "float32")
    np.testing.assert_array_equal(to_numpy(tc.cache_table),
                                  np.asarray(jc.cache_table))
    j = jc.get_miss_cache_index(jnp.asarray(ids))
    t = tc.get_miss_cache_index(torch.from_numpy(ids))
    for f in ("miss_ids", "rank", "hit", "slot", "num_miss", "num_hit"):
        a, b = np.asarray(getattr(j, f)), to_numpy(getattr(t, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    n = int(t.num_miss)
    np.testing.assert_array_equal(to_numpy(t.miss_ids)[:n],
                                  ids[to_numpy(t.order)[:n]])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_combine_is_bit_equal(case, dtype):
    """The port's combine (row gather over the cache + index_copy_ of
    exactly num_miss uploaded rows) against the reference's combine of its
    bucketed upload, and against the plain version: equal on every row
    (padding rows zero in all three)."""
    _, num_node, pct, ids = case
    feat, jc, tc = caches(num_node, pct, dtype)
    j = jc.get_miss_cache_index(jnp.asarray(ids))
    jmiss, jn = jc.upload_miss(j)
    jout = np.asarray(jc.combine(j, jmiss)).astype(np.float32)
    t = tc.get_miss_cache_index(torch.from_numpy(ids))
    rows, n_miss, n_hit = tc.upload_miss(t)
    assert (n_miss, n_hit) == (jn, int(j.num_hit)) and rows.shape[0] == jn
    tout = tc.combine(t, rows, n_miss)
    assert tout.dtype == (torch.bfloat16 if dtype == "bfloat16"
                          else torch.float32)
    np.testing.assert_array_equal(as_f32(tout), jout)
    np.testing.assert_array_equal(
        as_f32(tman.combine_reference(tc.cache_data, t, rows)), jout)
    np.testing.assert_array_equal(
        as_f32(tc.host_extract_miss(t.miss_ids, n_miss)),
        np.asarray(jc.host_extract_miss(np.asarray(j.miss_ids), jn)
                   ).astype(np.float32))
    valid = ids >= 0
    want = feat[np.maximum(ids, 0)]
    if dtype == "bfloat16":
        want = want.astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(as_f32(tout)[valid], want[valid])


def test_short_feature_table_needs_empty_feat():
    feat = feat_table(50, 4)
    with pytest.raises(ValueError, match="empty_feat"):
        tman.FeatureCache(HostFeatures(feat, torch.device("cpu")),
                          np.arange(100, dtype=np.int32), 0.5, 100)
    c = tman.FeatureCache(HostFeatures(feat, torch.device("cpu"), mod=50),
                          np.arange(100, dtype=np.int32), 0.5, 100)
    np.testing.assert_array_equal(to_numpy(c.cache_data)[:50], feat)


# --- rankings ---------------------------------------------------------------

@pytest.fixture(scope="module")
def skewed():
    return make_synthetic_dataset(num_node=3000, avg_degree=10, feat_dim=8,
                                  num_class=4, seed=7, neighbor_skew=6.0,
                                  neighbor_pref=0.5)


@pytest.mark.parametrize("policy", ["DEGREE", "DEGREE_HOP", "HEURISTIC",
                                    "RANDOM", "FAKE_OPTIMAL"])
def test_build_ranking_is_exact(skewed, policy):
    freq = np.random.default_rng(3).integers(0, 50, skewed.num_node)
    j = jpolicy.build_ranking(skewed, getattr(JPolicy, policy), seed=4,
                              access_freq=freq)
    t = tpolicy.build_ranking(port_ds(skewed), getattr(TPolicy, policy),
                              seed=4, access_freq=freq)
    assert t.dtype == np.int32
    np.testing.assert_array_equal(t, j)


def test_build_ranking_refuses_presample(skewed):
    for p in (TPolicy.PRESAMPLE, TPolicy.PRESAMPLE_STATIC):
        with pytest.raises(ValueError, match="presample"):
            tpolicy.build_ranking(port_ds(skewed), p)


def samplers(ds, batch_size=128, fanouts=(10, 5)):
    """The reference's jitted dedup sampler and the port's, on one plan."""
    indptr, indices = np.asarray(ds.indptr), np.asarray(ds.indices)
    caps = calibrate_caps(indptr, indices, np.asarray(ds.train_set),
                          batch_size, list(reversed(fanouts)))
    plan = make_plan(batch_size, fanouts, ds.num_node,
                     unique_caps=caps)
    jplan = jpadding.make_plan(batch_size, fanouts, ds.num_node,
                               unique_caps=caps)
    jg = jsamp.CSRGraph(indptr=jnp.asarray(indptr.astype(np.int32)),
                        indices=jnp.asarray(indices))
    tg = tsamp.CSRGraph(indptr=torch.from_numpy(indptr.astype(np.int64)),
                        indices=torch.from_numpy(indices))
    jfn = jax.jit(lambda k, s, n: jsamp.multi_layer_sample(
        k, jg, s, n, jplan, SampleType.KHOP0, dedup_last_hop=True))
    tfn = lambda s, n, rand: tsamp.multi_layer_sample(
        tg, s, n, plan, TSampleType.KHOP0, dedup_last_hop=True, rand=rand)
    shapes = tsamp.uniform_shapes(plan, TSampleType.KHOP0, True)
    return plan, jfn, tfn, shapes


def injected(seed, salt, num_step, shapes):
    """The reference presample's draws: hop uniforms of fold_in(key(seed ^
    salt), epoch * num_step + step)."""
    base = jax.random.key(seed ^ salt)
    return lambda e, s: jax_uniforms(jax.random.fold_in(base, e * num_step + s),
                                     shapes)


def test_presample_ranking_is_exact(skewed):
    plan, jfn, tfn, shapes = samplers(skewed)
    args = (skewed.train_set, 128, plan.num_input_cap[0])
    jsh, tsh = JShuffler(*args, base_seed=1), EpochShuffler(*args, base_seed=1)
    j = jpre.presample_ranking(jfn, jsh, skewed.num_node, presample_epoch=2,
                               seed=5)
    t = tpre.presample_ranking(
        tfn, tsh, skewed.num_node, "cpu", presample_epoch=2, seed=5,
        rand=injected(5, tpre.PRESAMPLE_SEED, tsh.num_step, shapes))
    np.testing.assert_array_equal(t, j)
    # the port's own generator gives a ranking of its own, and repeats it
    own = tpre.presample_ranking(tfn, tsh, skewed.num_node, "cpu", seed=5)
    np.testing.assert_array_equal(
        own, tpre.presample_ranking(tfn, tsh, skewed.num_node, "cpu", seed=5))
    assert sorted(own.tolist()) == list(range(skewed.num_node))


def test_presample_static_ranking_is_exact(skewed):
    plan, jfn, tfn, shapes = samplers(skewed)
    args = (skewed.train_set, 128, plan.num_input_cap[0])
    jsh, tsh = JShuffler(*args), EpochShuffler(*args)
    indptr, indices = np.asarray(skewed.indptr), np.asarray(skewed.indices)
    j = jpre.presample_static_ranking(jfn, jsh, indptr, indices,
                                      skewed.num_node, seed=2)
    t = tpre.presample_static_ranking(
        tfn, tsh, indptr, indices, skewed.num_node, "cpu", seed=2,
        rand=injected(2, tpre.PRESAMPLE_STATIC_SEED, tsh.num_step, shapes))
    np.testing.assert_array_equal(t, j)


def test_static_ranking_counts_all_neighbors():
    """Mirror of tests/test_presample_static.py: on a star graph the hub
    ranks first though the 'sampler' never picks it."""
    N = 50
    dst, indptr = [], [0]
    for v in range(N):
        dst += [0, (v + 1) % N]
        indptr.append(len(dst))

    class FakeBatch:
        def __init__(self, ids):
            self.input_nodes = ids

    sh = EpochShuffler(np.arange(1, N, dtype=np.int32), 16, 16)
    ranking = tpre.presample_static_ranking(
        lambda seeds, n, rand: FakeBatch(seeds), sh, np.asarray(indptr),
        np.asarray(dst, np.int32), N, "cpu")
    assert ranking[0] == 0


def test_presample_beats_degree_beats_random():
    """Mirror of tests/test_policy_ordering.py on the port's own generator:
    on a skewed graph at a 15% cache, presample > degree > random, and
    random hits about 15% of accesses."""
    ds = port_ds(make_synthetic_dataset(
        num_node=20_000, avg_degree=10, feat_dim=8, num_class=4,
        train_frac=0.2, seed=3, neighbor_skew=6.0, neighbor_pref=0.5))
    cfg = port_cfg(RunConfig(model="graphsage", fanout=(5, 10),
                             batch_size=512, num_hidden=16,
                             sample_type=SampleType.KHOP0))
    eng = OneChipEngine(cfg, ds, "cpu")
    gen = torch.Generator().manual_seed(11)
    counts = np.zeros(ds.num_node, dtype=np.int64)
    for e in range(2):
        for seeds, n, _ in eng.shuffler.batches(e):
            ids = to_numpy(eng.sample(torch.from_numpy(seeds), n, gen,
                                      True).input_nodes)
            np.add.at(counts, ids[ids >= 0], 1)
    sample_fn = lambda s, n, rand: eng.sample(s, n, rand, True)
    rank_pre = tpre.presample_ranking(sample_fn, eng.shuffler, ds.num_node,
                                      "cpu", seed=0)
    rank_deg = tpolicy.build_ranking(ds, TPolicy.DEGREE, 0)
    rank_rnd = tpolicy.build_ranking(ds, TPolicy.RANDOM, 0)

    def hit_rate(ranking, pct=0.15):
        return counts[ranking[:int(len(ranking) * pct)]].sum() / counts.sum()

    h_pre, h_deg, h_rnd = (hit_rate(r) for r in (rank_pre, rank_deg, rank_rnd))
    assert h_pre > h_deg > h_rnd, (h_pre, h_deg, h_rnd)
    assert abs(h_rnd - 0.15) < 0.1


# --- dynamic cache ----------------------------------------------------------

def id_batches(num_node, cap, seed):
    """A sequence of batches that overlap their predecessor, -1 padded."""
    rng = np.random.default_rng(seed)
    prev = rng.choice(num_node, cap // 2, replace=False)
    out = []
    for k in range(5):
        n = int(rng.integers(cap // 3, cap))
        keep = rng.choice(prev, min(len(prev), n // 2), replace=False)
        new = rng.choice(np.setdiff1d(np.arange(num_node), keep),
                         n - len(keep), replace=False)
        ids = rng.permutation(np.concatenate([keep, new]))
        pad = np.full(cap, -1, np.int32)
        pad[:n] = ids
        if k % 2:
            pad = rng.permutation(pad)   # padding in the middle too
        out.append(pad.astype(np.int32))
        prev = ids
    return out


def test_dynamic_cache_split_and_combine_are_exact():
    num_node, cap = 500, 64
    feat = feat_table(num_node, 8, seed=4)
    jc = jdyn.DynamicFeatureCache(feat, cap)
    tc = tdyn.DynamicFeatureCache(HostFeatures(feat, torch.device("cpu")), cap)
    hits = 0
    for ids in id_batches(num_node, cap, 1):
        js = jc.split_and_advance(jnp.asarray(ids))
        ts = tc.split_and_advance(torch.from_numpy(ids))
        for f in ("hit", "cache_row", "rank", "miss_ids", "num_miss"):
            np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                          to_numpy(getattr(ts, f)), err_msg=f)
        np.testing.assert_array_equal(np.asarray(jc.state.ids_sorted),
                                      to_numpy(tc.state.ids_sorted))
        n = int(ts.num_miss)
        jmiss = jc.gather_miss(np.asarray(js.miss_ids), n)
        tmiss = tc.gather_miss(ts.miss_ids, n)
        np.testing.assert_array_equal(to_numpy(tmiss), jmiss)
        prev = tc.state.feats
        want = to_numpy(tdyn.combine_feats_reference(prev, ts, tmiss[:n]))
        jout = np.asarray(jc.combine(js, jnp.asarray(jmiss)))
        tout = to_numpy(tc.combine(ts, tmiss[:n], n))
        np.testing.assert_array_equal(tout, jout)
        np.testing.assert_array_equal(want, jout)
        valid = ids >= 0
        np.testing.assert_array_equal(tout[valid], feat[ids[valid]])
        assert not tout[~valid].any()
        assert int(ts.num_hit) == jc.last_num_hit
        hits += jc.last_num_hit
    assert hits > 0


def test_dynamic_cache_extract_hits_the_previous_batch():
    """Mirror of tests/test_dynamic_cache.py::test_dynamic_cache_correct_
    and_hits through the port's synchronous extract."""
    rng = np.random.default_rng(0)
    num_node, dim, cap = 500, 8, 64
    feat = rng.standard_normal((num_node, dim)).astype(np.float32)
    cache = tdyn.DynamicFeatureCache(HostFeatures(feat, torch.device("cpu")),
                                     cap)

    def make_ids(ids):
        out = np.full(cap, -1, np.int32)
        out[: len(ids)] = ids
        return torch.from_numpy(out)

    ids1 = rng.choice(num_node, 40, replace=False)
    out1 = cache.extract(make_ids(ids1)).numpy()
    np.testing.assert_array_equal(out1[:40], feat[ids1])
    assert cache.last_num_hit == 0 and cache.last_num_miss == 40
    ids2 = np.concatenate([ids1[:20], rng.choice(
        np.setdiff1d(np.arange(num_node), ids1), 25, replace=False)])
    out2 = cache.extract(make_ids(ids2)).numpy()
    np.testing.assert_array_equal(out2[:45], feat[ids2])
    assert not out2[45:].any()
    assert cache.last_num_hit == 20 and cache.last_num_miss == 25
