"""A process per role: the port's multi-process engines and apps over gloo
on this machine's CPU, against one process and against the JAX package.

* Pure parts against the reference: ``host_step_range`` exactly,
  ``initialize_from_env`` without the variables, and the data-parallel
  demo's host-0 ranking, equal to the one the JAX demo computes from
  ``fgnn_tpu``'s own sampler, plan and shuffler.
* Processes against one process: the factored app as 2 processes (S=2 on
  one, T=2 on the other), in cache mode, and as 3 processes (1 sampler, 2
  trainer processes exchanging gradients, dropout on) against the port's
  ``FactoredEngine`` on ``["cpu"] * (S + T)``: losses to 8 decimals and
  parameters bit for bit. That engine is held against the JAX
  ``FactoredEngine`` by tests/test_torch_factored.py. The data-parallel demo
  as 2 processes: equal checksums and losses, a falling loss, and its train
  step run in this process over both processes' waves gives the same
  parameters bit for bit.
* The deliberate difference: arch5's table stays on the trainers by the
  port's budget, not the reference's 6 GB of float32.

Every group of processes starts together in one fixture, on ports picked
free, each child with a timeout and killed when a peer fails; the
collectives' own timeout is ``FGNN_TPU_DIST_TIMEOUT``."""
import argparse
import contextlib
import os
import re
import sys

import numpy as np
import pytest
import torch

from fgnn_tpu.parallel import multihost as jmh
from fgnn_tpu_torch.examples import train_multihost as demo_app
from fgnn_tpu_torch.examples.train_factored_multihost import (app_config,
                                                              app_dataset)
from fgnn_tpu_torch.parallel import multihost as mh
from fgnn_tpu_torch.parallel.factored import (FactoredEngine,
                                              resolve_feat_on_trainer)
from fgnn_tpu_torch.parallel.factored_multihost import MultihostFactoredEngine

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODES = 8000
TIMEOUT = 240
RESULT = re.compile(r"test_result:([^=]+)=(\S+)")


def start(module, rank_args, env=None):
    """One process a rank of ``python -m fgnn_tpu_torch.examples.<module>``,
    all started now on a free port."""
    return mh.start_ranks(
        [[sys.executable, "-m", f"fgnn_tpu_torch.examples.{module}", *args]
         for args in rank_args],
        env={"FGNN_TPU_DIST_TIMEOUT": "120", "OMP_NUM_THREADS": "1",
             "PYTHONPATH": REPO, **(env or {})}, cwd=REPO)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every multi-process run of this file, started together."""
    tmp = tmp_path_factory.mktemp("multihost")
    smoke = ["--smoke", "--synthetic-nodes", str(NODES)]
    two = ["--devices", "cpu,cpu"]
    groups = {
        "factored": start("train_factored_multihost", [
            smoke + two + ["--save-params", str(tmp / "factored")]] * 2),
        "cache": start("train_factored_multihost", [
            smoke + two + ["--num-epoch", "1", "--cache-percentage", "0.2",
                           "--save-params", str(tmp / "cache")]] * 2,
            env={"FGNN_TPU_FEAT_HBM_BUDGET": "0"}),
        "three": start("train_factored_multihost", [
            smoke + ["--dropout", "0.5",
                     "--save-params", str(tmp / "three")]] * 3),
        "demo": start("train_multihost", [
            smoke + ["--save-params", str(tmp / "demo")]] * 2),
        "refused": start("train_factored_multihost", [smoke] * 2,
                         env={"FGNN_TPU_FEAT_HBM_BUDGET": "1"}),
    }
    done = {name: mh.wait_ranks(procs, TIMEOUT)
            for name, procs in groups.items()}
    return tmp, done


def outputs(runs, name, ok=True):
    tmp, done = runs
    res = done[name]
    if ok:
        for i, (rc, text) in enumerate(res):
            assert rc == 0, f"{name} rank {i} exited {rc}:\n{text[-3000:]}"
    return tmp, [dict(RESULT.findall(text)) for _, text in res], res


def config(cache=0.0, dropout=0.0):
    """The factored app's configuration at its defaults."""
    return app_config(argparse.Namespace(batch_size=128, num_hidden=32,
                                         cache_percentage=cache,
                                         dropout=dropout))


@contextlib.contextmanager
def one_thread():
    """One intra-op thread, as the children run: with more, the CPU's
    matrix products may split their sums by how many threads the load
    leaves them, and the bits move."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def one_process(S, T, epochs, cache=0.0, dropout=0.0, **kw):
    """The port's single-process FactoredEngine on S + T CPU devices, the
    app's configuration; its epoch losses at 8 decimals and parameters."""
    cfg = config(cache, dropout).replace(num_sample_worker=S,
                                         num_train_worker=T)
    with one_thread():
        eng = FactoredEngine(cfg, app_dataset(NODES), ["cpu"] * (S + T),
                             **kw)
        losses = [f"{eng.run_epoch(e)['loss']:.8f}" for e in range(epochs)]
    return losses, eng.model.state_dict()


def assert_same(name, got, saved, losses, state):
    for e, loss in enumerate(losses):
        assert got[f"epoch{e}_loss"] == loss, (name, e, got, losses)
    sd = torch.load(saved)
    assert sd.keys() == state.keys()
    for k, v in state.items():
        assert torch.equal(sd[k], v), f"{name}: parameter {k} differs"


# -- pure parts against the reference ------------------------------------------
@pytest.mark.parametrize("hosts", [1, 2, 3, 4, 7, 16])
def test_host_step_range_matches_reference(hosts):
    for num_step in (0, 1, 5, 16, 17, 100, 1001):
        for host in range(hosts):
            assert mh.host_step_range(num_step, host, hosts) == \
                jmh.host_step_range(num_step, host, hosts)


def test_initialize_from_env_is_false_without_the_variables(monkeypatch):
    for k in ("FGNN_TPU_COORDINATOR", "FGNN_TPU_NUM_PROCESSES",
              "FGNN_TPU_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert mh.initialize_from_env() is False
    assert not torch.distributed.is_initialized()


def reference_ranking(num_node):
    """The JAX demo's host-0 ranking (examples/train_multihost.py:98-110),
    built from fgnn_tpu's sampler, caps, plan and shuffler."""
    from fgnn_tpu.data import make_synthetic_dataset
    from fgnn_tpu.host_engine import np_multi_layer_sample
    from fgnn_tpu.ops.padding import make_plan
    from fgnn_tpu.ops.reference_impl import calibrate_caps
    from fgnn_tpu.parallel.shuffler import DistShuffler

    ds = make_synthetic_dataset(num_node=num_node, avg_degree=10, feat_dim=32,
                                num_class=8, seed=5)
    indptr, indices = np.asarray(ds.indptr), np.asarray(ds.indices)
    caps = calibrate_caps(indptr, indices, np.asarray(ds.train_set), 128,
                          [4, 4], num_probe=2, seed=0)
    plan = make_plan(128, (4, 4), ds.num_node, unique_caps=caps)
    rng = np.random.default_rng(0)
    shuf = DistShuffler(np.asarray(ds.train_set), 128, plan.num_input_cap[0],
                        0, 1, base_seed=0)
    freq = np.zeros(ds.num_node, np.int64)
    for seeds, n, _ in shuf.batches(0):
        b = np_multi_layer_sample(rng, indptr, indices, seeds, n, plan)
        ids = np.asarray(b.input_nodes)
        np.add.at(freq, ids[ids >= 0], 1)
    return np.argsort(-freq, kind="stable").astype(np.int32)


def test_demo_ranking_equals_the_jax_demos(runs):
    cfg, ds, plan = demo_app.demo_setup(NODES)
    got = demo_app.host0_ranking(cfg, ds, plan,
                                 np.random.default_rng(cfg.seed))
    ref = reference_ranking(NODES)
    np.testing.assert_array_equal(got, ref)
    # and the processes printed the checksum of that ranking
    _, vals, _ = outputs(runs, "demo")
    for v in vals:
        assert v["ranking_checksum"] == str(int(ref[:100].sum()))


def test_collectives_in_a_one_rank_group(monkeypatch):
    """initialize_from_env with the variables (twice), then the helpers in a
    world of one: the ranking presample equals the port's own, the mesh
    lists this process's devices, a broadcast returns its input."""
    from fgnn_tpu_torch.cache.presample import presample_ranking
    from fgnn_tpu_torch.parallel.shuffler import EpochShuffler

    monkeypatch.setenv("FGNN_TPU_COORDINATOR",
                       f"127.0.0.1:{mh.free_port()}")
    monkeypatch.setenv("FGNN_TPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("FGNN_TPU_PROCESS_ID", "0")
    monkeypatch.setenv("FGNN_TPU_DIST_TIMEOUT", "60")
    try:
        assert mh.initialize_from_env() and mh.initialize_from_env()
        assert mh.global_data_mesh(["cpu", "cpu"]) == [
            (0, torch.device("cpu"))] * 2
        x = np.arange(7, dtype=np.int32)
        np.testing.assert_array_equal(mh.broadcast_from_host0(x), x)
        mh.barrier("test")
        assert mh.host_step_range(10) == (0, 10)
        cfg = config(cache=0.2)
        eng = FactoredEngine(cfg, app_dataset(2000), ["cpu"] * 2,
                             feat_on_trainer=False)
        cpu = torch.device("cpu")
        fn = lambda seeds, n, rand: eng.sample(cpu, seeds, n, rand, True)
        boot = lambda: EpochShuffler(eng.ds.train_set, cfg.batch_size,
                                     eng.plan.num_input_cap[0])
        np.testing.assert_array_equal(
            mh.presample_ranking_multihost(fn, boot(), 2000, cpu),
            presample_ranking(fn, boot(), 2000, cpu))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def test_engine_without_devices_raises_where_there_is_no_card(monkeypatch):
    """No card and no device named: the engine raises, in a one-rank gloo
    group, instead of running on the CPU; ``default_device`` too."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setenv("FGNN_TPU_COORDINATOR",
                       f"127.0.0.1:{mh.free_port()}")
    monkeypatch.setenv("FGNN_TPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("FGNN_TPU_PROCESS_ID", "0")
    monkeypatch.setenv("FGNN_TPU_DIST_TIMEOUT", "60")
    try:
        assert mh.initialize_from_env()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mh.default_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MultihostFactoredEngine(config(), app_dataset(2000))
        group, route = mh.exchange_group([0], mh.rank_devices(["cpu"]))
        assert route == "host"
        images = [torch.arange(32, dtype=torch.uint8)]
        assert torch.equal(mh.gather_images(images, 32, group, [1]),
                           images[0])
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def test_processes_report_their_gradient_route(runs):
    """Two trainer processes on the CPU exchange through host memory; one
    trainer process exchanges nothing; the demo's ranks on the CPU go
    through host memory too."""
    _, three, _ = outputs(runs, "three")
    assert [v["grad_route"] for v in three] == ["host"] * 3
    _, two, _ = outputs(runs, "factored")
    assert [v["grad_route"] for v in two] == ["None"] * 2
    _, demo, _ = outputs(runs, "demo")
    assert [v["grad_route"] for v in demo] == ["host"] * 2


def test_byte_codec_round_trips_a_wave():
    """A batch and its miss index through the byte image: the same tensors,
    dtypes and static fields, the images of two batches end to end."""
    from fgnn_tpu_torch.cache.manager import miss_cache_index
    from fgnn_tpu_torch.parallel.factored import step_generator

    cfg, ds = config(cache=0.2), app_dataset(2000)
    eng = FactoredEngine(cfg.replace(num_sample_worker=1), ds, ["cpu"] * 2,
                         feat_on_trainer=False)
    items = []
    for seeds, n, step in list(eng.shufflers[0].batches(0))[:2]:
        b = eng.sample(torch.device("cpu"), torch.as_tensor(seeds), n,
                       step_generator(torch.device("cpu"), 0, step), True)
        items.append((b, miss_cache_index(eng.cache.cache_table,
                                          b.input_nodes)))
    codec = mh.ByteCodec(mh.skeleton(items[0]))
    wave = torch.cat([codec.pack(x) for x in items])
    assert wave.numel() == 2 * codec.nbytes
    for i, x in enumerate(items):
        y = codec.unpack(wave[i * codec.nbytes:(i + 1) * codec.nbytes])
        a, b = mh._leaves(x, []), mh._leaves(y, [])
        assert len(a) == len(b) > 10
        for s, t in zip(a, b):
            assert s.dtype == t.dtype and torch.equal(s, t)
        assert y[0].blocks[0].slots_per_dst == x[0].blocks[0].slots_per_dst


def test_engine_needs_torch_distributed():
    with pytest.raises(RuntimeError, match="torch.distributed"):
        MultihostFactoredEngine(config(), app_dataset(2000))


def test_evaluate_raises_the_references_error():
    eng = object.__new__(MultihostFactoredEngine)
    with pytest.raises(NotImplementedError, match="multihost factored"):
        eng.evaluate()


# -- processes against one process ----------------------------------------------
def test_two_processes_equal_one_process(runs):
    """Rank 0 samples on ["cpu", "cpu"] (S=2), rank 1 trains on ["cpu",
    "cpu"] (T=2): the port's FactoredEngine S=2, T=2 bit for bit."""
    tmp, vals, _ = outputs(runs, "factored")
    assert "epoch0_loss" not in vals[0]
    losses, state = one_process(2, 2, 2)
    assert_same("2 processes", vals[1], tmp / "factored" / "params.pt",
                losses, state)


def test_two_processes_cache_mode_equal_one_process(runs):
    """PRESAMPLE 20% with the table in host memory: rank 0 ranks and ships
    each batch's miss index, rank 1 builds the cache."""
    tmp, vals, _ = outputs(runs, "cache")
    losses, state = one_process(2, 2, 1, cache=0.2, feat_on_trainer=False)
    assert_same("cache mode", vals[1], tmp / "cache" / "params.pt", losses,
                state)


def test_three_processes_exchange_gradients_as_one_process(runs):
    """1 sampler + 2 trainer processes (dropout 0.5): the gradients cross
    by all_gather and are summed in logical order on each trainer; both
    trainers print the same, and equal FactoredEngine S=1, T=2."""
    tmp, vals, _ = outputs(runs, "three")
    assert vals[1] == vals[2]
    losses, state = one_process(1, 2, 2, dropout=0.5)
    assert_same("3 processes", vals[1], tmp / "three" / "params.pt", losses,
                state)


def test_budget_below_the_table_refuses_without_a_cache(runs):
    """With FGNN_TPU_FEAT_HBM_BUDGET under the table's bytes and no cache,
    every rank refuses at init (the reference would keep its table, under
    6 GB of float32, on the trainer)."""
    _, _, res = outputs(runs, "refused", ok=False)
    assert len(res) == 2
    for rc, text in res:
        assert rc not in (0, None) and "through a cache" in text, text[-2000:]


@pytest.mark.parametrize("side", ["at", "under"])
def test_feat_on_trainer_follows_the_port_budget(side, monkeypatch):
    """The port's rule, on both sides of the table's bytes; the reference's
    (table f32 bytes <= 6 GB, fgnn_tpu/parallel/factored_multihost.py:245)
    says True on both."""
    cfg, ds = config(), app_dataset(2000)
    table = ds.feat.shape[0] * ds.feat.shape[1] * 4
    assert table <= (6 << 30)
    monkeypatch.setenv("FGNN_TPU_FEAT_HBM_BUDGET",
                       str(table if side == "at" else table - 1))
    cpu = torch.device("cpu")
    if side == "at":
        assert resolve_feat_on_trainer(cfg, ds, None, cpu) is True
    else:
        with pytest.raises(ValueError, match="through a cache"):
            resolve_feat_on_trainer(cfg, ds, None, cpu)
        cached = cfg.replace(cache_percentage=0.1)
        assert resolve_feat_on_trainer(cached, ds, None, cpu) is False


def test_data_parallel_demo_processes_agree(runs):
    _, vals, _ = outputs(runs, "demo")
    for key in ("ranking_checksum", "param_checksum", "epoch0_loss",
                "epoch1_loss"):
        assert vals[0][key] == vals[1][key], key
    assert float(vals[0]["epoch1_loss"]) < float(vals[0]["epoch0_loss"])


def test_demo_train_step_in_one_process_equals_two(runs):
    """Both ranks' waves (rank 0's rng after its presample, rank 1's fresh)
    through the demo's train step in this process: the parameters the two
    processes saved, bit for bit."""
    tmp, _, _ = outputs(runs, "demo")
    cfg, ds, plan = demo_app.demo_setup(NODES)
    rngs = [np.random.default_rng(cfg.seed + h) for h in range(2)]
    demo_app.host0_ranking(cfg, ds, plan, rngs[0])
    demo = demo_app.Demo(cfg, ds, plan, torch.device("cpu"))
    shuf = demo_app.demo_shuffler(cfg, ds, plan)
    W = 2
    with one_thread():
        train_demo(cfg, ds, plan, demo, shuf, rngs, W)
    for h in range(W):
        sd = torch.load(tmp / "demo" / f"params_rank{h}.pt")
        for k, v in demo.model.state_dict().items():
            assert torch.equal(sd[k], v), f"rank {h}: parameter {k} differs"


def train_demo(cfg, ds, plan, demo, shuf, rngs, W):
    """Two epochs of the demo's waves, every rank's slots in this process."""
    for epoch in range(2):
        perm = shuf.epoch_permutation(epoch)
        for wv in range(-(-shuf.num_step // W)):
            wsum = demo_app.wave_weight(len(perm), wv, W, cfg.batch_size)
            images = []
            for h in range(W):
                slots = demo_app.wave_slots(perm, wv, h, 1, W,
                                            cfg.batch_size,
                                            plan.num_input_cap[0])
                wave = demo_app.local_wave(cfg, ds, plan, rngs[h], slots,
                                           demo.device)
                images += demo.images(epoch, wave, wsum)
            demo_app.train_step(demo.model, demo.optimizer,
                                torch.cat(images), demo.codec_box[0], wsum,
                                demo.device)
