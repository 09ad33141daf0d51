"""arch6: the port's SGNNEngine against the JAX package's on a small graph.
The reference runs its fused wave on W virtual CPU devices
(tests/conftest.py), the port on ``["cpu"] * W``; both start from the same
parameters and the port's workers draw the reference's uniforms: batch
``step`` of ``epoch`` keyed ``fold_in(key(seed), epoch * 100003 + step)``,
step = local * W + w.

Tolerances: sampled edges and overflow flags exact; the epoch's loss, the
parameters after it and evaluation within 1e-4 (float32 sums in another
order over the epoch's Adam steps). A profiled epoch equals a plain one bit
for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgnn_tpu.config import RunConfig, SampleType
from fgnn_tpu.data import make_synthetic_dataset
from fgnn_tpu.parallel.factored import SGNNEngine as JSGNN
from fgnn_tpu.utils.profiler import Profiler as JProfiler
from fgnn_tpu_torch.models.convert import params_from_flax
from fgnn_tpu_torch.parallel.factored import SGNN_EPOCH_STRIDE, SGNNEngine
from fgnn_tpu_torch.utils.profiler import Profiler
from torch_parity import (ReferenceDraws, params_close, port_cfg, port_ds,
                          reference_eval_draws)

torch.set_num_threads(2)

CFG = RunConfig(model="graphsage", fanout=(10, 3), batch_size=128,
                num_hidden=32, sample_type=SampleType.KHOP2, dropout=0.0,
                lr=0.003, compute_dtype="float32")
GCN_CFG = CFG.replace(model="gcn", fanout=(2, 3, 4), num_hidden=16)
TOL = 1e-4


@pytest.fixture(scope="module")
def ds():
    return make_synthetic_dataset(num_node=2000, avg_degree=8, feat_dim=32,
                                  num_class=8, train_frac=0.5, seed=42)


def engines(ds, cfg):
    W = cfg.num_train_worker
    jeng = JSGNN(cfg, ds, devices=jax.devices()[:W])
    draws = ReferenceDraws(cfg.seed, cfg.sample_type, stride=SGNN_EPOCH_STRIDE)
    teng = SGNNEngine(port_cfg(cfg), port_ds(ds), ["cpu"] * W, rand_fn=draws)
    draws.bind(teng, teng.dedup_last_hop)
    assert teng.dedup_last_hop == jeng._dedup == (cfg.model == "gcn")
    assert teng.plan.tier_layout is None
    teng.model.load_state_dict(params_from_flax(jeng.state.params))
    return jeng, teng


def reference_edges(jeng, epoch):
    """The edges of the reference's batches of an epoch, sampled with its
    training keys and dedup mode."""
    sample = jax.jit(lambda k, s, n: jeng._sample_one(
        jeng.graph, k, s, n, dedup_last_hop=jeng._dedup))
    base = jax.random.key(jeng.cfg.seed)
    total = 0
    for sh in jeng.shufflers:
        for seeds, n, step in sh.batches(epoch):
            b = sample(jax.random.fold_in(base, epoch * SGNN_EPOCH_STRIDE
                                          + step),
                       jnp.asarray(seeds), jnp.int32(n))
            assert not bool(b.overflowed)
            total += sum(int(blk.mask.sum()) for blk in b.blocks)
    return total


@pytest.fixture(scope="module")
def epoch_runs(ds):
    """``run(cfg, W)``: both engines after epoch 0, with the epoch's
    results, the reference's overflow count and its sampled edges, made
    once a module (the reference's compiles are most of a test's time).
    Global step k has the same seeds and key whatever W is (the padding
    steps sample nothing), so the reference's edges are counted once a
    model."""
    runs, edges = {}, {}

    def run(cfg, W):
        key = (cfg.model, W)
        if key not in runs:
            jeng, teng = engines(ds, cfg.replace(num_train_worker=W))
            JProfiler.reset()
            jr = jeng.run_epoch(0)
            ovf = JProfiler.get().get_epoch_value(0, "epoch_cap_overflow")
            if cfg.model not in edges:
                edges[cfg.model] = reference_edges(jeng, 0)
            runs[key] = (jeng, teng, jr, teng.run_epoch(0), ovf,
                         edges[cfg.model])
        return runs[key]

    return run


@pytest.mark.parametrize("cfg", [CFG, GCN_CFG], ids=["graphsage", "gcn"])
@pytest.mark.parametrize("W", [1, 2, 4])
def test_sgnn_epoch_matches_reference(epoch_runs, cfg, W):
    """One epoch: the loss and the parameters within 1e-4, the sampled
    edges and the overflow flag exact. GraphSAGE skips the last hop's
    dedup, GCN keeps it."""
    jeng, teng, jr, tr, ovf, edges = epoch_runs(cfg, W)
    assert abs(tr["loss"] - jr["loss"]) < TOL, (tr["loss"], jr["loss"])
    params_close(jeng.state.params, teng.model, TOL)
    assert tr["num_step"] == jr["num_step"] == teng.num_local_step * W
    assert tr["sampled_edges"] == edges
    assert not teng.last_overflowed
    assert ovf == 0.0


@pytest.mark.parametrize("cfg", [CFG, GCN_CFG], ids=["graphsage", "gcn"])
def test_sgnn_evaluate_matches_reference(epoch_runs, cfg):
    """evaluate() on worker 0 after epoch 0 at W=2, last-hop dedup, the
    reference's evaluation keys: the accuracy within 1e-4."""
    jeng, teng, _, _, _, _ = epoch_runs(cfg, 2)
    acc = teng.evaluate(rand=reference_eval_draws(teng, cfg))
    assert abs(acc - jeng.evaluate()) < TOL
    assert 0.0 < acc < 1.0


def test_profiled_epoch_equals_plain_epoch(ds):
    """At profile level 2 (the reference's de-fused profiled path) each
    stage ends in a sync and writes its epoch and step items; the epoch is
    the same bit for bit, dropout on."""
    cfg = port_cfg(CFG).replace(num_train_worker=2, dropout=0.5)
    Profiler.reset()
    plain = SGNNEngine(cfg, port_ds(ds), ["cpu"] * 2)
    observed = SGNNEngine(cfg.replace(profile_level=2), port_ds(ds),
                          ["cpu"] * 2)
    r0, r1 = plain.run_epoch(0), observed.run_epoch(0)
    assert r0["loss"] == r1["loss"]
    for p, q in zip(plain.model.parameters(), observed.model.parameters()):
        assert torch.equal(p, q)
    prof = Profiler.get()
    for item in ("epoch_sample_time", "epoch_extract_time",
                 "epoch_train_time"):
        assert prof.get_epoch_value(0, item) > 0.0, item
    for item in ("L1_sample_time", "L1_copy_time", "L1_train_time"):
        assert prof.has_step_item(item), item


def test_sgnn_losses_fall_and_resume(ds, tmp_path):
    """Three epochs with dropout on: finite, falling losses; a checkpoint
    after epoch 1 resumes epoch 2 bit for bit."""
    cfg = port_cfg(CFG).replace(num_train_worker=2, dropout=0.5,
                                ckpt_dir=str(tmp_path), ckpt_every=1)
    a = SGNNEngine(cfg, port_ds(ds), ["cpu"] * 2)
    r = [a.run_epoch(e) for e in range(2)]
    b = SGNNEngine(cfg, port_ds(ds), ["cpu"] * 2)
    assert b.start_epoch == 2
    ra, rb = a.run_epoch(2), b.run_epoch(2)
    assert np.isfinite(r[0]["loss"]) and ra["loss"] < r[0]["loss"]
    assert ra["loss"] == rb["loss"]
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)


def test_too_few_devices_raise(ds):
    with pytest.raises(ValueError, match="2 workers needs 2"):
        SGNNEngine(port_cfg(CFG).replace(num_train_worker=2), port_ds(ds),
                   ["cpu"])
