"""The whole slice: the port's OneChipEngine against the JAX package's on
a small graph, step by step, from the same parameters and with the JAX
engine's own uniforms injected into the port's sampler."""
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
from fgnn_tpu_torch.ops.sampling import uniform_shapes
from torch_parity import jax_uniforms

torch.set_num_threads(2)

CFG = RunConfig(model="graphsage", fanout=(10, 3), batch_size=128,
                num_hidden=32, sample_type=SampleType.KHOP2, dropout=0.0,
                lr=0.003, compute_dtype="float32")


@pytest.fixture(scope="module")
def ds():
    return make_synthetic_dataset(num_node=2000, avg_degree=8, feat_dim=32,
                                  num_class=8, train_frac=0.5, seed=42)


def test_engine_steps_match_reference(ds):
    """Per step: sampled_edges and the overflow flag equal, loss to 1e-4
    (float32 sums in another order, compounded over three Adam steps)."""
    jeng = JEngine(CFG, ds)
    teng = OneChipEngine(CFG, ds, "cpu")
    assert dataclasses.asdict(teng.plan) == dataclasses.asdict(jeng.plan)
    assert teng.plan.tier_layout is not None, "the tiered hop must engage"
    teng.model.load_state_dict(params_from_flax(jeng.state.params))
    shapes = uniform_shapes(teng.plan, CFG.sample_type, teng.dedup_last_hop)
    seeds_all, nums_all = jeng.shuffler.epoch_arrays(0)
    state = jeng.state
    for i in range(3):
        key = jax.random.fold_in(jax.random.key(0), i)
        state, jl, _, jn, jo = jeng.fused_step(
            state, key, jnp.asarray(seeds_all[i]), jnp.int32(nums_all[i]))
        tl, _, tn, to = teng.step(torch.from_numpy(seeds_all[i]),
                                  int(nums_all[i]), jax_uniforms(key, shapes))
        assert int(tn) == int(jn), i
        assert bool(to) == bool(jo) is False
        assert abs(float(tl) - float(jl)) < 1e-4, (i, float(tl), float(jl))


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
                                {"model": "gcn"}])
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
