"""The whole slice: the port's OneChipEngine against the JAX package's on
a small graph, step by step, from the same parameters and with the JAX
engine's own uniforms injected into the port's sampler. GraphSAGE runs the
tiered no-dedup last hop, GCN three dedup hops with src out-degrees. The
helpers also serve the PinSAGE and GAT engine tests.

Tolerances: plans, per-step edges and overflow flags exact; loss within
1e-4 over three Adam steps (float32 sums in another order); evaluation
accuracy within one test row."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgnn_tpu.config import RunConfig, SampleType
from fgnn_tpu.data import make_synthetic_dataset
from fgnn_tpu.data.synthetic import build_alias_tables
from fgnn_tpu.engine import OneChipEngine as JEngine
from fgnn_tpu_torch.engine import OneChipEngine
from fgnn_tpu_torch.models.convert import params_from_flax
from torch_parity import jax_uniforms, jax_walk_uniforms, port_cfg, port_ds

torch.set_num_threads(2)

CFG = RunConfig(model="graphsage", fanout=(10, 3), batch_size=128,
                num_hidden=32, sample_type=SampleType.KHOP2, dropout=0.0,
                lr=0.003, compute_dtype="float32")
GCN_CFG = CFG.replace(model="gcn", fanout=(2, 3, 4), num_hidden=16)


@pytest.fixture(scope="module")
def ds():
    return make_synthetic_dataset(num_node=2000, avg_degree=8, feat_dim=32,
                                  num_class=8, train_frac=0.5, seed=42)


def port_engine(cfg, ds, **kw):
    """The port's engine on the CPU for a reference config and dataset."""
    return OneChipEngine(port_cfg(cfg), port_ds(ds), "cpu", **kw)


def jax_draws(cfg):
    """The reference's per-hop uniforms for the engine's sampler."""
    if cfg.sample_type == SampleType.RANDOM_WALK:
        return jax_walk_uniforms
    return functools.partial(jax_uniforms, sample_type=cfg.sample_type)


def engines(ds, cfg):
    """The reference engine and the port's, from the same parameters, with
    the same plan and the reference's last-hop rule: only GCN dedups its
    last hop; only the no-dedup last hop of the uniform samplers without
    replacement is tiered."""
    jeng = JEngine(cfg, ds)
    teng = port_engine(cfg, ds)
    assert dataclasses.asdict(teng.plan) == dataclasses.asdict(jeng.plan)
    gcn = cfg.model == "gcn"
    uniform = cfg.sample_type in (SampleType.KHOP0, SampleType.KHOP2)
    assert (teng.plan.tier_layout is None) == (gcn or not uniform)
    assert teng.dedup_last_hop == teng.with_out_degrees == gcn
    teng.model.load_state_dict(params_from_flax(jeng.state.params))
    return jeng, teng


def steps_match_reference(ds, cfg):
    """Per step: sampled_edges and the overflow flag equal, loss to 1e-4
    (float32 sums in another order, compounded over three Adam steps)."""
    jeng, teng = engines(ds, cfg)
    shapes = teng.uniform_shapes(teng.dedup_last_hop)
    seeds_all, nums_all = jeng.shuffler.epoch_arrays(0)
    state = jeng.state
    for i in range(3):
        key = jax.random.fold_in(jax.random.key(0), i)
        state, jl, _, jn, jo = jeng.fused_step(
            state, key, jnp.asarray(seeds_all[i]), jnp.int32(nums_all[i]))
        tl, _, tn, to = teng.step(torch.from_numpy(seeds_all[i]),
                                  int(nums_all[i]),
                                  jax_draws(cfg)(key, shapes))
        assert int(tn) == int(jn), i
        assert bool(to) == bool(jo) is False
        assert abs(float(tl) - float(jl)) < 1e-4, (i, float(tl), float(jl))


def test_engine_steps_match_reference(ds):
    steps_match_reference(ds, CFG)


def test_gcn_engine_steps_match_reference(ds):
    """GCN: no tier layout, last-hop dedup and src out-degrees, 3 layers."""
    steps_match_reference(ds, GCN_CFG)


def evaluate_matches_reference(ds, cfg):
    """The reference's evaluation: the test set, last-hop dedup for every
    model, its own key per step; injected here as uniforms."""
    jeng, teng = engines(ds, cfg)
    base = jax.random.key(cfg.seed + 12345)
    shapes = teng.uniform_shapes(True)
    gen_state = teng.sample_gen.get_state()
    acc = teng.evaluate(
        rand=lambda step: jax_draws(cfg)(jax.random.fold_in(base, step),
                                         shapes))
    assert abs(acc - jeng.evaluate()) <= 1.0 / len(ds.test_set)
    assert 0.0 < acc < 1.0
    assert torch.equal(teng.sample_gen.get_state(), gen_state)
    # its own generator: evaluation repeats exactly and moves no training
    # generator
    assert teng.evaluate() == teng.evaluate()
    assert torch.equal(teng.sample_gen.get_state(), gen_state)


@pytest.mark.parametrize("cfg", [CFG, GCN_CFG], ids=["graphsage", "gcn"])
def test_evaluate_matches_reference(ds, cfg):
    evaluate_matches_reference(ds, cfg)


def test_run_epochs_equals_run_epoch_calls(ds):
    """Two epochs in one run_epochs call against two run_epoch calls from
    the same state (dropout on): identical losses, accuracies, edges and
    parameters; only epoch_time differs."""
    cfg = GCN_CFG.replace(dropout=0.5)
    a = port_engine(cfg, ds)
    b = port_engine(cfg, ds)
    ra = a.run_epochs(0, 2)
    rb = [b.run_epoch(0), b.run_epoch(1)]
    for x, y in zip(ra, rb):
        assert {k: v for k, v in x.items() if k != "epoch_time"} == \
            {k: v for k, v in y.items() if k != "epoch_time"}
    assert ra[0]["epoch_time"] == ra[1]["epoch_time"] > 0
    assert [r["epoch"] for r in ra] == [0, 1]
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name


def test_run_epoch_reports_the_reference_keys(ds):
    eng = port_engine(CFG.replace(dropout=0.5), ds)
    r0, r1 = eng.run_epoch(0), eng.run_epoch(1)
    assert set(r0) == {"epoch", "epoch_time", "loss", "acc", "num_step",
                       "sampled_edges"}
    assert r0["num_step"] == eng.shuffler.num_step == 8
    assert np.isfinite(r0["loss"]) and r1["loss"] < r0["loss"]
    assert r0["sampled_edges"] > 0 and not eng.last_overflowed


def test_feature_table_over_budget_raises(ds):
    """A table over the device budget no longer raises: it stays in host
    memory (the reference's ``feat_on_device`` rule), every hop dedups, and
    every input row of an uncached epoch comes from the host."""
    eng = port_engine(CFG, ds, feat_budget=1024)
    assert not eng.feat_on_device and eng.feat_dev is None
    assert eng.dedup_last_hop and eng.cache is None and eng.dyn_cache is None
    r = eng.run_epoch(0)
    assert np.isfinite(r["loss"]) and r["sampled_edges"] > 0
    assert r["miss_bytes"] == r["feature_bytes"] > 0
    # on the device (no budget on the CPU) the cache setting is ignored
    eng = port_engine(CFG.replace(cache_percentage=0.1), ds)
    assert eng.feat_on_device and eng.cache is None


@pytest.fixture(scope="module")
def wds():
    """The engine tests' graph with the weighted samplers' tables."""
    ds = make_synthetic_dataset(num_node=2000, avg_degree=8, feat_dim=32,
                                num_class=8, train_frac=0.5, seed=42)
    build_alias_tables(ds, seed=0)
    return ds


@pytest.mark.parametrize("sample_type", [
    SampleType.KHOP1, SampleType.WEIGHTED_KHOP,
    SampleType.WEIGHTED_KHOP_PREFIX, SampleType.WEIGHTED_KHOP_HASH_DEDUP],
    ids=lambda st: st.value)
def test_other_samplers_engine_steps_match_reference(wds, sample_type):
    """KHOP1 and the weighted samplers: the plain no-dedup last hop, caps
    calibrated as the reference does (with replacement for KHOP1)."""
    steps_match_reference(wds, CFG.replace(sample_type=sample_type))


def test_weighted_sampler_without_tables_raises(ds):
    """The reference fails inside its sampler; the port names the missing
    tables when the engine is built."""
    with pytest.raises(ValueError, match="build_alias_tables"):
        port_engine(CFG.replace(sample_type=SampleType.WEIGHTED_KHOP), ds)


def test_empty_feat_dataset_gathers_modulo_the_table():
    """Empty-feat mode (a small fake table indexed modulo its rows) runs
    through mock_gather, as the reference engine does."""
    ds = make_synthetic_dataset(num_node=2000, avg_degree=8, feat_dim=16,
                                num_class=4, train_frac=0.2, seed=1,
                                empty_feat_rows=100)
    assert ds.empty_feat
    r = port_engine(CFG, ds).run_epoch(0)
    assert np.isfinite(r["loss"]) and r["sampled_edges"] > 0


def test_empty_feat_evaluate_reads_modulo_the_table():
    """evaluate() on an empty-feat dataset reads the fake table modulo its
    rows, as training does (the reference's evaluate reads it with
    device_gather and gets NaN rows past its end): finite, and equal to
    evaluate() from the same parameters over a full table whose row i is
    the fake table's row i % 100."""
    ds = make_synthetic_dataset(num_node=2000, avg_degree=8, feat_dim=16,
                                num_class=4, train_frac=0.2, seed=1,
                                empty_feat_rows=100)
    full = dataclasses.replace(
        ds, feat=np.asarray(ds.feat)[np.arange(ds.num_node) % 100],
        empty_feat=False)
    mock, real = port_engine(CFG, ds), port_engine(CFG, full)
    mock.run_epoch(0)
    real.model.load_state_dict(mock.model.state_dict())
    acc = mock.evaluate()
    assert np.isfinite(acc) and 0.0 < acc < 1.0
    assert acc == real.evaluate()
