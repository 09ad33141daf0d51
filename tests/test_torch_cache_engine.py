"""The port's engine with a host-resident feature table against the JAX
package's: no cache, the static cache ranked by presampling and by degree,
and the dynamic (previous-batch) cache. Both engines keep the table on the
host (``feat_budget=0`` / ``feat_hbm_budget=0``), start from the same
parameters, and the port's sampler gets the reference's uniforms, for
training steps, for evaluation and for the presample.

Tolerances: per-step misses and sampled edges exact; loss within 1e-4 over
three Adam steps (float32 sums in another order); evaluation accuracy
within one test row. The pipelined epochs equal the synchronous ones bit
for bit on the CPU: the pipeline changes when work runs, not what it
computes."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgnn_tpu.config import CachePolicy, RunConfig, SampleType
from fgnn_tpu.data import make_synthetic_dataset
from fgnn_tpu.engine import OneChipEngine as JEngine
from fgnn_tpu.ops.extract import host_gather
from fgnn_tpu_torch.cache.presample import PRESAMPLE_SEED
from fgnn_tpu_torch.engine import EVAL_SEED_OFFSET, OneChipEngine
from fgnn_tpu_torch.models.convert import params_from_flax
from fgnn_tpu_torch.ops.sampling import uniform_shapes
from torch_parity import jax_uniforms, port_cfg, port_ds

torch.set_num_threads(2)

CFG = RunConfig(model="graphsage", fanout=(10, 3), batch_size=128,
                num_hidden=32, sample_type=SampleType.KHOP2, dropout=0.0,
                lr=0.003, compute_dtype="float32")
CASES = {
    "no cache": {},
    "presample 25%": dict(cache_policy=CachePolicy.PRESAMPLE,
                          cache_percentage=0.25),
    "degree 25%": dict(cache_policy=CachePolicy.DEGREE, cache_percentage=0.25),
    "dynamic": dict(cache_policy=CachePolicy.DYNAMIC_CACHE,
                    cache_percentage=0.1),
}


@pytest.fixture(scope="module")
def ds():
    return make_synthetic_dataset(num_node=2000, avg_degree=8, feat_dim=32,
                                  num_class=8, train_frac=0.5, seed=42)


def presample_draws(cfg, jeng, shapes):
    """The reference presample's keys: fold_in(key(seed ^ 0x9E3779B9),
    epoch * num_step + step), each hop's uniforms from it."""
    base = jax.random.key(cfg.seed ^ PRESAMPLE_SEED)
    n = jeng.shuffler.num_step
    return lambda e, s: jax_uniforms(jax.random.fold_in(base, e * n + s),
                                     shapes)


def engines(ds, cfg):
    jeng = JEngine(cfg, ds, feat_hbm_budget=0)
    shapes = uniform_shapes(jeng.plan, None, True)
    teng = OneChipEngine(port_cfg(cfg), port_ds(ds), "cpu", feat_budget=0,
                         presample_rand=presample_draws(cfg, jeng, shapes))
    assert not jeng.feat_on_device and not teng.feat_on_device
    assert teng.dedup_last_hop
    assert (teng.cache is None) == (jeng.cache is None)
    assert (teng.dyn_cache is None) == (jeng.dyn_cache is None)
    if jeng.cache is not None:
        np.testing.assert_array_equal(teng.cache.cache_table.numpy(),
                                      np.asarray(jeng.cache.cache_table))
    teng.model.load_state_dict(params_from_flax(jeng.state.params))
    return jeng, teng, shapes


def reference_step(jeng, ds, key, seeds, n):
    """One step of the reference's split path (engine.py:812-960):
    (loss, misses, sampled edges)."""
    batch = jeng.sample_jit(key, jnp.asarray(seeds), jnp.int32(n))
    if jeng.dyn_cache is not None:
        feats = jeng.dyn_cache.extract(batch.input_nodes)
        miss = jeng.dyn_cache.last_num_miss
    elif jeng.cache is not None:
        index = jeng.cache.get_miss_cache_index(batch.input_nodes)
        miss_t, miss = jeng.cache.upload_miss(index)
        feats = jeng.cache.combine(index, miss_t)
    else:
        feats = jnp.asarray(host_gather(ds.feat, np.asarray(batch.input_nodes)))
        miss = int(batch.num_input)
    jeng.state, loss, _ = jeng.train_jit(jeng.state, key, batch, feats)
    edges = int(sum(int(jnp.sum(b.mask)) for b in batch.blocks))
    return float(loss), miss, edges


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_host_resident_engine_matches_reference(ds, case):
    cfg = CFG.replace(**CASES[case])
    jeng, teng, shapes = engines(ds, cfg)

    # evaluate first, from the shared parameters: the host path, no cache
    base = jax.random.key(cfg.seed + EVAL_SEED_OFFSET)
    acc = teng.evaluate(rand=lambda step: jax_uniforms(
        jax.random.fold_in(base, step), shapes))
    assert abs(acc - jeng.evaluate()) <= 1.0 / len(ds.test_set)

    seeds_all, nums_all = jeng.shuffler.epoch_arrays(0)
    for i in range(3):
        key = jax.random.fold_in(jax.random.key(0), i)
        jl, jmiss, jedges = reference_step(jeng, ds, key, seeds_all[i],
                                           nums_all[i])
        tl, _, tedges, tovf = teng.step(torch.from_numpy(seeds_all[i]),
                                        int(nums_all[i]),
                                        jax_uniforms(key, shapes))
        assert teng.last_rows[0] == jmiss, (i, teng.last_rows, jmiss)
        assert int(tedges) == jedges and not bool(tovf)
        assert abs(float(tl) - jl) < 1e-4, (i, float(tl), jl)
        if case == "no cache":
            assert teng.last_rows[0] == teng.last_rows[1]
        else:
            assert teng.last_rows[0] < teng.last_rows[1] or i == 0


@pytest.mark.parametrize("case", ["presample 25%", "dynamic"])
def test_pipelined_epochs_equal_synchronous_ones(ds, case):
    """Mirror of tests/test_dynamic_cache.py::test_dyncache_pipelined_bit_
    identical, for both cache kinds, dropout on: the same losses,
    accuracies, edges, miss and feature bytes, and parameters."""
    def run(pipeline):
        cfg = port_cfg(CFG.replace(dropout=0.5, pipeline=pipeline,
                                   **CASES[case]))
        eng = OneChipEngine(cfg, port_ds(ds), "cpu", feat_budget=0)
        assert eng.pipelined == pipeline
        return eng, eng.run_epochs(0, 2)

    pipe, rp = run(True)
    sync, rs = run(False)
    for a, b in zip(rp, rs):
        assert {k: v for k, v in a.items() if k != "epoch_time"} == \
            {k: v for k, v in b.items() if k != "epoch_time"}
        assert 0 < a["miss_bytes"] < a["feature_bytes"]
    for (name, p), q in zip(pipe.model.named_parameters(),
                            sync.model.parameters()):
        assert torch.equal(p, q), name
    if case == "dynamic":
        assert torch.equal(pipe.dyn_cache.state.feats, sync.dyn_cache.state.feats)


def test_pipelined_epoch_under_a_short_switch_interval(ds):
    """The worker thread shares the loader's staging slots and counters
    with the training thread: with the interpreter switching threads every
    microsecond, the pipelined epoch still equals the synchronous one and
    the loader counts every miss row once."""
    def run(pipeline):
        cfg = port_cfg(CFG.replace(pipeline=pipeline, **CASES["dynamic"]))
        eng = OneChipEngine(cfg, port_ds(ds), "cpu", feat_budget=0)
        return eng, eng.run_epoch(0)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pipe, rp = run(True)
    finally:
        sys.setswitchinterval(interval)
    _, rs = run(False)
    assert rp["loss"] == rs["loss"] and rp["miss_bytes"] == rs["miss_bytes"]
    c = pipe.host_feat.counters()
    assert c["gather_bytes"] == rp["miss_bytes"] > 0   # f32 rows, as counted


def test_cached_epochs_train_and_report_hit_rates(ds):
    """bf16 compute: the static cache and the miss staging are bf16
    (2-byte rows in the counters), the dynamic cache float32; losses fall
    and the cache halves the host traffic or better."""
    out = {}
    for name in ("no cache", "presample 25%", "dynamic"):
        cfg = port_cfg(CFG.replace(compute_dtype="bfloat16", **CASES[name]))
        eng = OneChipEngine(cfg, port_ds(ds), "cpu", feat_budget=0)
        r0, r1 = eng.run_epochs(0, 2)
        assert np.isfinite(r0["loss"]) and r1["loss"] < r0["loss"]
        assert not eng.last_overflowed
        itemsize = 2 if name == "presample 25%" else 4
        assert r0["feature_bytes"] % (ds.feat_dim * itemsize) == 0
        out[name] = 1 - r1["miss_bytes"] / r1["feature_bytes"]
    assert out["no cache"] == 0.0
    assert out["presample 25%"] > 0.25 and out["dynamic"] > 0.25, out
