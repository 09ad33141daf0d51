"""arch5: the port's FactoredEngine against the JAX package's on a small
graph. The reference runs on the virtual CPU devices tests/conftest.py sets
up, the port on ``["cpu"] * (S + T)``; both start from the same parameters
(``params_from_flax``) and the port's samplers draw the reference's
uniforms (``rand_fn``), so every batch and every group is the reference's.

Tolerances: shuffler seeds, counts and step ids, sampled edges, overflow
flags, cache tables and miss bytes exact; the epoch's loss, the parameters
after it and evaluation within 1e-4 (float32 sums in another order over
the epoch's Adam steps). The pipelined cache epoch equals the serial one
bit for bit: the pipeline changes when work runs, not what it computes."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgnn_tpu.config import CachePolicy, RunConfig, SampleType
from fgnn_tpu.data import make_synthetic_dataset
from fgnn_tpu.parallel import shuffler as jshuffler
from fgnn_tpu.parallel.factored import FactoredEngine as JFactored
from fgnn_tpu.utils.profiler import Profiler as JProfiler
from fgnn_tpu_torch.cache.presample import PRESAMPLE_SEED
from fgnn_tpu_torch.models.convert import params_from_flax
from fgnn_tpu_torch.ops.sampling import uniform_shapes
from fgnn_tpu_torch.parallel import factored as tfactored
from fgnn_tpu_torch.parallel import shuffler as tshuffler
from fgnn_tpu_torch.parallel.factored import FactoredEngine
from fgnn_tpu_torch.utils.profiler import Profiler
from torch_parity import (ReferenceDraws, params_close, port_cfg, port_ds,
                          reference_eval_draws)

torch.set_num_threads(2)

CFG = RunConfig(model="graphsage", fanout=(10, 3), batch_size=128,
                num_hidden=32, sample_type=SampleType.KHOP2, dropout=0.0,
                lr=0.003, compute_dtype="float32")
TOL = 1e-4


@pytest.fixture(scope="module")
def ds():
    return make_synthetic_dataset(num_node=2000, avg_degree=8, feat_dim=32,
                                  num_class=8, train_frac=0.5, seed=42)


# -- the shufflers ----------------------------------------------------------
@pytest.mark.parametrize("kind", ["DistShuffler", "AlignedDistShuffler"])
@pytest.mark.parametrize("n,batch,workers", [
    (1000, 128, 1), (1000, 128, 2), (1000, 128, 3), (1000, 100, 4),
    (130, 64, 4), (7, 8, 2)])
def test_dist_shufflers_match_reference(kind, n, batch, workers):
    """Every worker's seeds, counts and global step ids, and the step
    counts, equal the reference's, over two epochs."""
    train = np.random.default_rng(n).permutation(5 * n)[:n].astype(np.int32)
    cap = batch + 3
    for w in range(workers):
        j = getattr(jshuffler, kind)(train, batch, cap, w, workers,
                                     base_seed=5)
        t = getattr(tshuffler, kind)(train, batch, cap, w, workers,
                                     base_seed=5)
        assert (t.num_step, t.num_local_step) == (j.num_step,
                                                  j.num_local_step)
        for epoch in (0, 1):
            jb, tb = list(j.batches(epoch)), list(t.batches(epoch))
            assert len(jb) == len(tb) == t.num_local_step
            for (js, jn, jstep), (ts, tn, tstep) in zip(jb, tb):
                np.testing.assert_array_equal(ts, js)
                assert (tn, tstep) == (jn, jstep)


# -- the engine against the reference ----------------------------------------
def engines(ds, cfg):
    """The reference engine on S + T virtual devices and the port's on
    ["cpu"] * (S + T), from the reference's parameters, drawing the
    reference's uniforms."""
    n = cfg.num_sample_worker + cfg.num_train_worker
    jeng = JFactored(cfg, ds, devices=jax.devices()[:n])
    draws = ReferenceDraws(cfg.seed, cfg.sample_type)
    teng = FactoredEngine(port_cfg(cfg), port_ds(ds), ["cpu"] * n,
                          rand_fn=draws)
    draws.bind(teng, True)
    assert dataclasses.asdict(teng.plan) == dataclasses.asdict(jeng.plan)
    assert teng.num_step == jeng.num_step
    teng.model.load_state_dict(params_from_flax(jeng.state.params))
    return jeng, teng


def reference_edges(jeng, ds, cfg, epoch):
    """The edges of the reference's batches of an epoch: each global step
    sampled with its training key (the same whatever S and T are)."""
    sh = jshuffler.EpochShuffler(ds.train_set, cfg.batch_size,
                                 jeng.plan.num_input_cap[0],
                                 base_seed=cfg.seed)
    base = jax.random.key(cfg.seed)
    total = 0
    for seeds, n, step in sh.batches(epoch):
        b = jeng.single_sample(
            jax.random.fold_in(base, epoch * jeng.num_step + step),
            jnp.asarray(seeds), jnp.int32(n))
        assert not bool(b.overflowed)
        total += sum(int(blk.mask.sum()) for blk in b.blocks)
    return total


@pytest.fixture(scope="module")
def epoch_runs(ds):
    """``run(S, T)``: both engines at (S, T) after epoch 0, with the
    epoch's results and the reference's overflow count, made once a module
    (the reference's compiles are most of a test's time)."""
    runs = {}

    def run(S, T):
        if (S, T) not in runs:
            cfg = CFG.replace(num_sample_worker=S, num_train_worker=T)
            jeng, teng = engines(ds, cfg)
            JProfiler.reset()
            jr = jeng.run_epoch(0)
            ovf = JProfiler.get().get_epoch_value(0, "epoch_cap_overflow")
            runs[S, T] = (cfg, jeng, teng, jr, teng.run_epoch(0), ovf)
        return runs[S, T]

    return run


@pytest.mark.parametrize("S,T", [(1, 1), (1, 2), (2, 2), (1, 3)])
def test_factored_epoch_matches_reference(ds, epoch_runs, S, T):
    """One epoch at each (S, T): the loss and the parameters after it
    within 1e-4, the sampled edges and the overflow flag exact. The groups
    fill in the reference's wave/drain order."""
    cfg, jeng, teng, jr, tr, ovf = epoch_runs(S, T)
    assert abs(tr["loss"] - jr["loss"]) < TOL, (tr["loss"], jr["loss"])
    assert abs(tr["acc"] - jr["acc"]) < TOL
    params_close(jeng.state.params, teng.model, TOL)
    assert tr["sampled_edges"] == reference_edges(jeng, ds, cfg, 0)
    assert not teng.last_overflowed
    assert ovf == 0.0
    assert tr["num_step"] == jr["num_step"] == 8


def test_factored_cache_mode_matches_reference(ds):
    """Host-resident features behind a PRESAMPLE 25% cache, the
    sampler-side miss index crossing with the batch (S=2, T=2): the
    presample's ranking and the miss bytes exact, the loss and parameters
    within 1e-4 of the reference, pipelined and serial epochs bit-equal."""
    cfg = CFG.replace(num_sample_worker=2, num_train_worker=2,
                      cache_policy=CachePolicy.PRESAMPLE,
                      cache_percentage=0.25)
    jeng = JFactored(cfg, ds, devices=jax.devices()[:4], feat_on_trainer=False)
    # the reference counts its init batch's misses into epoch 0
    JProfiler.reset()
    # the presample's keys: fold_in(key(seed ^ 0x9E3779B9), epoch *
    # num_step + step) over the whole train set, dedup shapes of the plan
    presample = ReferenceDraws(cfg.seed ^ PRESAMPLE_SEED, cfg.sample_type,
                               stride=jeng.num_step)
    presample.shapes = uniform_shapes(jeng.plan, None, True)

    def port(pipeline):
        draws = ReferenceDraws(cfg.seed, cfg.sample_type)
        eng = FactoredEngine(port_cfg(cfg.replace(pipeline=pipeline)),
                             port_ds(ds), ["cpu"] * 4, feat_on_trainer=False,
                             rand_fn=draws, presample_rand=presample)
        draws.bind(eng, True)
        return eng

    pipe, serial = port(True), port(False)
    np.testing.assert_array_equal(pipe.cache.cache_table.numpy(),
                                  np.asarray(jeng.cache.cache_table))
    for eng in (pipe, serial):
        eng.model.load_state_dict(params_from_flax(jeng.state.params))
    jr = jeng.run_epoch(0)
    rp, rs = pipe.run_epoch(0), serial.run_epoch(0)
    assert rp == {**rs, "epoch_time": rp["epoch_time"]}
    for p, q in zip(pipe.model.parameters(), serial.model.parameters()):
        assert torch.equal(p, q)
    assert abs(rp["loss"] - jr["loss"]) < TOL, (rp["loss"], jr["loss"])
    params_close(jeng.state.params, pipe.model, TOL)
    jprof = JProfiler.get()
    assert rp["miss_bytes"] == jprof.get_epoch_value(0, "epoch_miss_bytes")
    assert rp["feature_bytes"] == jprof.get_epoch_value(
        0, "epoch_feature_bytes")
    assert 0 < rp["miss_bytes"] < rp["feature_bytes"]


def test_pinsage_factored_matches_reference(ds):
    """PinSAGE (random-walk sampling) at S=1, T=1, the reference's golden
    gate b: loss and parameters within 1e-4."""
    cfg = CFG.replace(model="pinsage", sample_type=SampleType.RANDOM_WALK,
                      num_layer_rw=2, num_neighbor=3, num_random_walk=4,
                      random_walk_length=3)
    jeng, teng = engines(ds, cfg)
    jr, tr = jeng.run_epoch(0), teng.run_epoch(0)
    assert abs(tr["loss"] - jr["loss"]) < TOL, (tr["loss"], jr["loss"])
    params_close(jeng.state.params, teng.model, TOL)


def test_factored_evaluate_matches_reference(epoch_runs):
    """evaluate() after epoch 0 at S=1, T=2: sampler 0 samples with
    last-hop dedup under the reference's evaluation keys, trainer 0
    extracts and evaluates; the accuracy within 1e-4, and repeatable on
    the port's own draws."""
    cfg, jeng, teng, _, _, _ = epoch_runs(1, 2)
    acc = teng.evaluate(rand=reference_eval_draws(teng, cfg))
    assert abs(acc - jeng.evaluate()) < TOL
    assert 0.0 < acc < 1.0
    assert teng.evaluate() == teng.evaluate()


# -- behaviour -----------------------------------------------------------------
def tcfg(**kw):
    return port_cfg(CFG).replace(**kw)


def test_checkpoint_resume_equals_uninterrupted_epoch(ds, tmp_path):
    """Saved after epoch 0 and restored into a new engine, epoch 1 equals
    the uninterrupted epoch 1 bit for bit (draws are keyed by epoch and
    step, so no generator state is needed); dropout on."""
    cfg = tcfg(num_train_worker=2, dropout=0.5, ckpt_dir=str(tmp_path),
               ckpt_every=1)
    a = FactoredEngine(cfg, port_ds(ds), ["cpu"] * 3)
    assert a.start_epoch == 0
    a.run_epoch(0)
    b = FactoredEngine(cfg, port_ds(ds), ["cpu"] * 3)
    assert b.start_epoch == 1
    ra, rb = a.run_epoch(1), b.run_epoch(1)
    assert ra["loss"] == rb["loss"] and ra["sampled_edges"] == rb["sampled_edges"]
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)


def _tiny_caps(monkeypatch):
    """Calibrated caps far below what a 128-seed [10, 3] batch produces."""
    monkeypatch.setattr(tfactored, "calibrate_caps",
                        lambda *a, **k: [150, 150])


@pytest.mark.parametrize("sanity", [False, True], ids=["warns", "raises"])
def test_overflow_is_surfaced(ds, monkeypatch, sanity):
    """A clipped batch sets last_overflowed and counts epoch_cap_overflow,
    and raises under the sanity check."""
    _tiny_caps(monkeypatch)
    Profiler.reset()
    eng = FactoredEngine(tcfg(sanity_check=sanity), port_ds(ds), ["cpu"] * 2)
    if sanity:
        with pytest.raises(RuntimeError, match="cap overflow"):
            eng.run_epoch(0)
        return
    r = eng.run_epoch(0)
    assert np.isfinite(r["loss"]) and eng.last_overflowed
    assert Profiler.get().get_epoch_value(0, "epoch_cap_overflow") == 1.0


def test_too_few_devices_raise(ds):
    with pytest.raises(ValueError, match="2 samplers \\+ 2 trainers needs 4"):
        FactoredEngine(tcfg(num_sample_worker=2, num_train_worker=2),
                       port_ds(ds), ["cpu"] * 3)


def test_profiled_epoch_equals_plain_epoch(ds):
    """At profile level 2 each stage ends in a sync and writes its epoch
    items and the graph copy's step item; the epoch is the same bit for
    bit."""
    Profiler.reset()
    plain = FactoredEngine(tcfg(num_train_worker=2), port_ds(ds), ["cpu"] * 3)
    prof_eng = FactoredEngine(tcfg(num_train_worker=2, profile_level=2),
                              port_ds(ds), ["cpu"] * 3)
    r0, r1 = plain.run_epoch(0), prof_eng.run_epoch(0)
    assert r0["loss"] == r1["loss"]
    for p, q in zip(plain.model.parameters(), prof_eng.model.parameters()):
        assert torch.equal(p, q)
    prof = Profiler.get()
    for item in ("epoch_sample_time", "epoch_copy_time",
                 "epoch_extract_time", "epoch_train_time"):
        assert prof.get_epoch_value(0, item) > 0.0, item
    assert prof.has_step_item("L2_graph_copy_time")


def test_host_table_without_cache_raises(ds):
    """Factored mode reads a host-resident table only through a cache."""
    with pytest.raises(ValueError, match="cache"):
        FactoredEngine(tcfg(), port_ds(ds), ["cpu"] * 2, feat_on_trainer=False)
