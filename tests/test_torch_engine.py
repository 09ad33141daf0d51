"""The whole slice: the port's OneChipEngine against the JAX package's on
a small graph, step by step, from the same parameters and with the JAX
engine's own uniforms injected into the port's sampler. GraphSAGE runs the
tiered no-dedup last hop, GCN three dedup hops with src out-degrees. The
helpers also serve the PinSAGE and GAT engine tests.

Tolerances: plans, per-step edges and overflow flags exact; loss within
1e-4 over three Adam steps (float32 sums in another order); evaluation
accuracy within one test row."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgnn_tpu.config import RunConfig, SampleType
from fgnn_tpu.data import make_synthetic_dataset
from fgnn_tpu.engine import OneChipEngine as JEngine
from fgnn_tpu_torch.engine import OneChipEngine
from fgnn_tpu_torch.models.convert import params_from_flax
from torch_parity import jax_uniforms, jax_walk_uniforms

torch.set_num_threads(2)

CFG = RunConfig(model="graphsage", fanout=(10, 3), batch_size=128,
                num_hidden=32, sample_type=SampleType.KHOP2, dropout=0.0,
                lr=0.003, compute_dtype="float32")
GCN_CFG = CFG.replace(model="gcn", fanout=(2, 3, 4), num_hidden=16)


@pytest.fixture(scope="module")
def ds():
    return make_synthetic_dataset(num_node=2000, avg_degree=8, feat_dim=32,
                                  num_class=8, train_frac=0.5, seed=42)


def jax_draws(cfg):
    """The reference's per-hop uniforms for the engine's sampler."""
    if cfg.sample_type == SampleType.RANDOM_WALK:
        return jax_walk_uniforms
    return jax_uniforms


def engines(ds, cfg):
    """The reference engine and the port's, from the same parameters, with
    the same plan and the reference's last-hop rule: only GCN dedups its
    last hop; only the uniform samplers' no-dedup last hop is tiered."""
    jeng = JEngine(cfg, ds)
    teng = OneChipEngine(cfg, ds, "cpu")
    assert dataclasses.asdict(teng.plan) == dataclasses.asdict(jeng.plan)
    gcn = cfg.model == "gcn"
    walk = cfg.sample_type == SampleType.RANDOM_WALK
    assert (teng.plan.tier_layout is None) == (gcn or walk)
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
    a = OneChipEngine(cfg, ds, "cpu")
    b = OneChipEngine(cfg, ds, "cpu")
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
    eng = OneChipEngine(CFG.replace(dropout=0.5), ds, "cpu")
    r0, r1 = eng.run_epoch(0), eng.run_epoch(1)
    assert set(r0) == {"epoch", "epoch_time", "loss", "acc", "num_step",
                       "sampled_edges"}
    assert r0["num_step"] == eng.shuffler.num_step == 8
    assert np.isfinite(r0["loss"]) and r1["loss"] < r0["loss"]
    assert r0["sampled_edges"] > 0 and not eng.last_overflowed


def test_feature_table_over_budget_raises(ds):
    with pytest.raises(ValueError, match="budget"):
        OneChipEngine(CFG, ds, "cpu", feat_budget=1024)


@pytest.mark.parametrize("kw", [{"sample_type": SampleType.KHOP1},
                                {"cache_percentage": 0.1},
                                {"sample_type": SampleType.WEIGHTED_KHOP}])
def test_unported_configurations_raise(ds, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        OneChipEngine(CFG.replace(**kw), ds, "cpu")


def test_empty_feat_dataset_gathers_modulo_the_table():
    """Empty-feat mode (a small fake table indexed modulo its rows) runs
    through mock_gather, as the reference engine does."""
    ds = make_synthetic_dataset(num_node=2000, avg_degree=8, feat_dim=16,
                                num_class=4, train_frac=0.2, seed=1,
                                empty_feat_rows=100)
    assert ds.empty_feat
    r = OneChipEngine(CFG, ds, "cpu").run_epoch(0)
    assert np.isfinite(r["loss"]) and r["sampled_edges"] > 0
