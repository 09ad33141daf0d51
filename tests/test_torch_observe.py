"""Observing the port's engines: the profiler items each path writes at
profile levels 1-3 against the JAX package's on the same configuration, the
invariant that an observed epoch (level 3, trace, node access, sanity
checker) equals an unobserved one bit for bit, node-access counts under
the reference's own draws, the sanity checker against the reference's on
the same batches, the de-fused dedup ops of the level-3 pass, and the env
knobs. Exact throughout: sets, ids and counts compare equal, and the
observed epochs run the same float operations in the same order."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgnn_tpu.config import CachePolicy, RunConfig, SampleType
from fgnn_tpu.data import make_synthetic_dataset
from fgnn_tpu.engine import OneChipEngine as JEngine
from fgnn_tpu.host_engine import HostSamplingEngine as JHostEngine
from fgnn_tpu.ops import hashtable as jhash
from fgnn_tpu.ops.padding import make_plan as jmake_plan
from fgnn_tpu.ops.sampling import CSRGraph as JGraph
from fgnn_tpu.ops.sampling import multi_layer_sample as jsample
from fgnn_tpu.ops.sanity import EpochSanityChecker as JChecker
from fgnn_tpu.utils.profiler import Profiler as JProfiler
from fgnn_tpu_torch.engine import OneChipEngine
from fgnn_tpu_torch.host_engine import HostSamplingEngine
from fgnn_tpu_torch.ops import hashtable as thash
from fgnn_tpu_torch.ops.padding import make_plan
from fgnn_tpu_torch.ops.sanity import EpochSanityChecker
from fgnn_tpu_torch.utils.profiler import Profiler
from torch_parity import batch_to_torch, jax_uniforms, port_cfg, port_ds

torch.set_num_threads(2)

KNOBS = ("FGNN_TPU_DUMP_TRACE", "FGNN_TPU_LOG_NODE_ACCESS",
         "FGNN_TPU_SANITY_CHECK", "FGNN_TPU_PROFILE_LEVEL",
         "FGNN_TPU_FEAT_HBM_BUDGET")
CFG = RunConfig(model="graphsage", fanout=(10, 3), batch_size=256,
                num_hidden=32, sample_type=SampleType.KHOP2, dropout=0.5,
                lr=0.003, compute_dtype="float32")
STATIC = dict(cache_policy=CachePolicy.PRESAMPLE, cache_percentage=0.25)
DYNAMIC = dict(cache_policy=CachePolicy.DYNAMIC_CACHE, cache_percentage=0.1)
# path -> (the config's changes, the table's place: "device", "host" or
# "arch0")
PATHS = {
    "device": ({}, "device"),
    "host": ({}, "host"),
    "static-sync": (dict(STATIC, pipeline=False), "host"),
    "static-pipelined": (dict(STATIC, pipeline=True), "host"),
    "dynamic-sync": (dict(DYNAMIC, pipeline=False), "host"),
    "dynamic-pipelined": (dict(DYNAMIC, pipeline=True), "host"),
    "arch0": ({}, "arch0"),
}
# Items the port writes that the reference does not (ROADMAP.md §C): the
# pipelined static-cache epoch at level 2 or higher splits its host part as
# Table 1 does, the miss gather into epoch_extract_time (the reference
# files the whole host part under epoch_copy_time, so Table 1's Extract
# column of that row reads 0 there).
DELIBERATE = {("static-pipelined", 2): {"epoch_extract_time"},
              ("static-pipelined", 3): {"epoch_extract_time"}}


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    Profiler.reset()
    JProfiler.reset()
    yield
    Profiler.reset()
    JProfiler.reset()


@pytest.fixture(scope="module")
def ds():
    return make_synthetic_dataset(num_node=2000, avg_degree=8, feat_dim=32,
                                  num_class=8, train_frac=0.3, seed=42)


def port_engine(path, ds, **cfg_changes):
    changes, place = PATHS[path]
    cfg = port_cfg(CFG.replace(**changes, **cfg_changes))
    if place == "arch0":
        return HostSamplingEngine(cfg, port_ds(ds), "cpu")
    return OneChipEngine(cfg, port_ds(ds), "cpu",
                         feat_budget=0 if place == "host" else None)


def written(prof):
    """The step and epoch items a profiler holds a value of."""
    return ({k for k, v in prof._step.items() if v}
            | {k for k, v in prof._epoch.items() if v})


@pytest.fixture(scope="module")
def reference(ds):
    """``engine(path)``: the reference engine of the path's kind. One of
    each kind serves every level and pipeline setting and the node-access
    test, so its jitted programs compile once."""
    engines = {}

    def engine(path):
        changes, place = PATHS[path]
        kind = path.split("-")[0]
        if kind not in engines:
            cfg = CFG.replace(**changes)
            engines[kind] = (JHostEngine(cfg, ds) if place == "arch0" else
                             JEngine(cfg, ds) if place == "device" else
                             JEngine(cfg, ds, feat_hbm_budget=0))
        return engines[kind]

    return engine


def reference_items(reference, path, level):
    """The items a reference epoch of ``path`` writes at ``level``."""
    eng = reference(path)
    eng.cfg = CFG.replace(**PATHS[path][0], profile_level=level)
    JProfiler.reset()
    JProfiler.get().level = level
    eng.run_epoch(0)
    return written(JProfiler.get())


@pytest.mark.parametrize("path", list(PATHS))
def test_items_written_equal_the_reference(ds, reference, path):
    """For each path at levels 1, 2 and 3, with no per-step observer: the
    set of step and epoch items written equals the reference's, but for
    the differences in DELIBERATE."""
    for level in (1, 2, 3):
        ref = reference_items(reference, path, level)
        Profiler.reset()
        port_engine(path, ds, profile_level=level).run_epoch(0)
        port = written(Profiler.get())
        extra = DELIBERATE.get((path, level), set())
        assert port == ref | extra, (level, port ^ ref)
        assert not extra & ref


def observe(monkeypatch):
    monkeypatch.setenv("FGNN_TPU_DUMP_TRACE", "1")
    monkeypatch.setenv("FGNN_TPU_LOG_NODE_ACCESS", "1")
    Profiler.reset()


def params(eng):
    return [p.detach().clone() for p in eng.model.parameters()]


@pytest.mark.parametrize("path", list(PATHS))
def test_observed_epochs_equal_unobserved(ds, path, monkeypatch):
    """Level 3 with the trace, node access and the checker on gives the
    epochs of level 1 with nothing on, bit for bit: the same dicts (but
    epoch_time), the same parameters after them."""
    plain = port_engine(path, ds)
    assert plain.sanity is None
    r1 = [plain.run_epoch(e) for e in range(2)]
    observe(monkeypatch)
    eng = port_engine(path, ds, profile_level=3, sanity_check=True)
    assert eng.sanity is not None
    r3 = [eng.run_epoch(e) for e in range(2)]
    strip = lambda rs: [{k: v for k, v in r.items() if k != "epoch_time"}
                        for r in rs]
    assert strip(r3) == strip(r1)
    for p, q in zip(params(eng), params(plain)):
        assert torch.equal(p, q)
    prof = Profiler.get()
    assert prof.node_access_frequency().sum() > 0
    assert len(prof.node_access_similarity()) == 1
    if path != "arch0":   # the reference's arch0 emits no trace either
        lanes = prof.lane_summary()
        assert {"kL0Event_Train_Step", "kL1Event_Sample", "kL1Event_Copy",
                "kL1Event_Train", "kL2Event_Sample_Core"} <= set(lanes)
        steps = 2 * eng.shuffler.num_step
        assert lanes["kL0Event_Train_Step"]["count"] == steps


@pytest.mark.parametrize("path,level", [("device", 2), ("host", 1),
                                        ("static-sync", 1),
                                        ("dynamic-sync", 1)])
def test_stepwise_epoch_equals_a_loop_of_steps(ds, path, level):
    """The stepwise loop (the host-resident paths without the pipeline at
    every level, the device path at level 2) trains what a loop of
    ``step()`` calls on the same batches trains, bit for bit."""
    eng = port_engine(path, ds, profile_level=level)
    r = eng.run_epoch(0)
    ref = port_engine(path, ds)
    stats, nums = [], []
    for seeds, n, _ in ref.shuffler.batches(0):
        stats.append(ref._stats(*ref.step(torch.as_tensor(seeds), n)))
        nums.append(n)
    s = torch.stack(stats)
    w = torch.as_tensor(np.asarray(nums) > 0, dtype=torch.float32)
    assert r["loss"] == float((s[:, 0] * w).sum() / w.sum())
    assert r["acc"] == float((s[:, 1] * w).sum() / w.sum())
    assert r["sampled_edges"] == int(s[:, 2].double().sum())
    for p, q in zip(params(eng), params(ref)):
        assert torch.equal(p, q)


def test_level1_device_path_is_not_stepwise(ds, monkeypatch):
    """Unobserved, the device-resident table dispatches every step with no
    host read (one sync a run_epochs call); FGNN_TPU_PROFILE_LEVEL raises
    the profiler's level but not the path, as in the reference; level 2
    takes the stepwise loop."""
    monkeypatch.setenv("FGNN_TPU_PROFILE_LEVEL", "3")
    Profiler.reset()
    eng = port_engine("device", ds)
    assert Profiler.get().level == 3

    def stepwise(epoch):
        raise AssertionError("the stepwise loop ran")

    monkeypatch.setattr(eng, "_dispatch_epoch_stepwise", stepwise)
    eng.run_epochs(0, 2)
    assert written(Profiler.get()) == {"epoch_total_time"}
    eng = port_engine("device", ds, profile_level=2)
    monkeypatch.setattr(eng, "_dispatch_epoch_stepwise", stepwise)
    with pytest.raises(AssertionError, match="stepwise"):
        eng.run_epoch(0)


def test_node_access_counts_equal_the_reference(ds, reference, monkeypatch,
                                                tmp_path):
    """Two epochs of the device path at level 1 with node access on, the
    port sampling from the reference's keys: the same counts, epoch
    similarity and artifacts, byte for byte. (The counts depend on the
    draws alone, not on the parameters.)"""
    monkeypatch.setenv("FGNN_TPU_LOG_NODE_ACCESS", "1")
    cfg = CFG
    JProfiler.reset()
    jeng = reference("device")
    jeng.cfg = cfg
    for e in range(2):
        jeng.run_epoch(e)
    ref = JProfiler.get()
    assert ref.log_node_access

    Profiler.reset()
    teng = OneChipEngine(port_cfg(cfg), port_ds(ds), "cpu")
    shapes = teng.uniform_shapes(teng.dedup_last_hop)
    base, calls = jax.random.key(cfg.seed), iter(range(10 ** 6))
    sample = teng.sample

    def injected(seeds, n, rand, dedup_last_hop):
        key = jax.random.fold_in(base, next(calls))   # epoch * num_step + step
        return sample(seeds, n, jax_uniforms(key, shapes), dedup_last_hop)

    monkeypatch.setattr(teng, "sample", injected)
    for e in range(2):
        teng.run_epoch(e)
    port = Profiler.get()
    counts = port.node_access_frequency()
    assert ({int(i): int(counts[i]) for i in np.nonzero(counts)[0]}
            == dict(ref.node_access_frequency()))
    assert port.node_access_similarity() == ref.node_access_similarity()
    ref.report_node_access(str(tmp_path / "ref"), ds.num_node)
    port.report_node_access(str(tmp_path / "port"), ds.num_node)
    for suffix in ("_ranking.bin", "_access.json"):
        assert ((tmp_path / f"port{suffix}").read_bytes()
                == (tmp_path / f"ref{suffix}").read_bytes())


# --- the sanity checker --------------------------------------------------------

@pytest.fixture(scope="module")
def checked_batch(ds):
    """A reference batch of 32 seeds over two dedup hops, its plan, and the
    port's plan."""
    g = JGraph(indptr=jnp.asarray(ds.indptr), indices=jnp.asarray(ds.indices))
    plan = jmake_plan(32, [3, 5], ds.num_node)
    seeds = jnp.full((plan.num_input_cap[0],), -1, jnp.int32).at[:32].set(
        ds.train_set[:32])
    batch = jax.jit(lambda k, s, n: jsample(k, g, s, n, plan,
                                            SampleType.KHOP0))(
        jax.random.key(0), seeds, jnp.int32(32))
    tplan = make_plan(32, [3, 5], ds.num_node)
    assert dataclasses.asdict(tplan) == dataclasses.asdict(plan)
    return batch, plan, tplan


def corrupt(batch, how):
    if how == "padding in the outputs":
        return batch.replace(output_nodes=batch.output_nodes.at[0].set(-1))
    if how == "input past the graph":
        return batch.replace(input_nodes=batch.input_nodes.at[0].set(10 ** 6))
    blocks = list(batch.blocks)
    bi = {"src past its cap (deepest block)": 0,
          "src past its cap": 1}[how]
    b = blocks[bi]
    cap = (batch.input_nodes.shape[0] if bi == 0 else 10 ** 6)
    first = int(np.nonzero(np.asarray(b.mask))[0][0])
    blocks[bi] = b.replace(src_local=b.src_local.at[first].set(cap))
    return batch.replace(blocks=tuple(blocks))


def test_checker_passes_clean_batches(ds, checked_batch):
    batch, plan, tplan = checked_batch
    JChecker(ds.num_node).check_batch(batch, plan)
    chk = EpochSanityChecker(ds.num_node)
    chk.check_batch(batch_to_torch(batch), tplan)
    chk.reset()
    chk.check_batch(batch_to_torch(batch), tplan)


@pytest.mark.parametrize("how", [
    "seed twice in an epoch", "padding in the outputs",
    "input past the graph", "src past its cap (deepest block)",
    "src past its cap"])
def test_checker_raises_where_the_reference_asserts(ds, checked_batch, how):
    batch, plan, tplan = checked_batch
    jchk, tchk = JChecker(ds.num_node), EpochSanityChecker(ds.num_node)
    if how == "seed twice in an epoch":
        jchk.check_batch(batch, plan)
        tchk.check_batch(batch_to_torch(batch), tplan)
    else:
        batch = corrupt(batch, how)
    with pytest.raises(AssertionError):
        jchk.check_batch(batch, plan)
    with pytest.raises(ValueError, match="sanity check failed"):
        tchk.check_batch(batch_to_torch(batch), tplan)


def test_checker_raises_on_a_padding_slot_with_a_local(ds, checked_batch):
    """The port's own layout check: a slot outside the mask holds -1."""
    batch, _, tplan = checked_batch
    tb = batch_to_torch(batch)
    b = tb.blocks[1]
    pad = int(torch.nonzero(~b.mask)[0])
    b.src_local[pad] = 0
    with pytest.raises(ValueError, match="padding slot"):
        EpochSanityChecker(ds.num_node).check_batch(tb, tplan)


def test_sanity_knob_builds_the_checker(ds, monkeypatch):
    monkeypatch.setenv("FGNN_TPU_SANITY_CHECK", "1")
    assert port_engine("device", ds).sanity is not None
    assert port_engine("arch0", ds).sanity is not None
    assert JEngine(CFG, ds).sanity is not None


# --- the level-3 pass's de-fused dedup -----------------------------------------

@pytest.mark.parametrize("out_cap", [40, 90, 400])
def test_unique_with_seeds_and_lookup_equal_the_reference(out_cap):
    rng = np.random.default_rng(out_cap)
    S = 40
    seeds = np.full(S, -1, np.int32)
    seeds[:30] = rng.choice(500, 30, replace=False)
    nbrs = rng.integers(0, 500, 300).astype(np.int32)
    nbrs[rng.random(300) < 0.2] = -1
    nbrs[:20] = seeds[:20]            # neighbors among the seeds
    ju, jn, jo = jhash.unique_with_seeds(
        jnp.asarray(seeds), jnp.int32(30), jnp.asarray(nbrs), out_cap)
    tu, tn, to = thash.unique_with_seeds(
        torch.from_numpy(seeds), 30, torch.from_numpy(nbrs), out_cap)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    assert int(tn) == int(jn) and bool(to) == bool(jo)
    queries = np.concatenate([nbrs, seeds, [-1, 499, 7]]).astype(np.int32)
    np.testing.assert_array_equal(
        thash.lookup_local_ids(tu, S, torch.from_numpy(queries)).numpy(),
        np.asarray(jhash.lookup_local_ids(ju, S, jnp.asarray(queries))))


# --- the feature budget knob ---------------------------------------------------

def test_feat_hbm_budget_knob_keeps_the_table_on_the_host(ds, monkeypatch):
    """FGNN_TPU_FEAT_HBM_BUDGET=0 puts the table in host memory, as in the
    reference; an explicit feat_budget still wins."""
    monkeypatch.setenv("FGNN_TPU_FEAT_HBM_BUDGET", "0")
    cfg, tds = port_cfg(CFG), port_ds(ds)
    eng = OneChipEngine(cfg, tds, "cpu")
    assert not eng.feat_on_device and eng.feat_dev is None
    assert eng.host_feat is not None and eng.dedup_last_hop
    assert not JEngine(CFG, ds).feat_on_device
    assert OneChipEngine(cfg, tds, "cpu", feat_budget=1 << 40).feat_on_device
    monkeypatch.setenv("FGNN_TPU_FEAT_HBM_BUDGET", str(1 << 40))
    assert OneChipEngine(cfg, tds, "cpu").feat_on_device
    assert OneChipEngine(cfg, tds, "cpu", feat_budget=0).feat_on_device is False
