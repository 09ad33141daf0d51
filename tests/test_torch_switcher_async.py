"""The balance switcher and the async trainers (arch5's variants), the
session's multi-device paths and the app on arch5 and arch6.

The switcher's tail reserve comes from timings, so its epochs are held to
their mechanics (the forced tail trains on all S + T devices) rather than
to the reference's numbers; its policy function is held to the
reference's exactly. The async engine at ``async_sync_every=1`` is held to
the reference's within 1e-4 in loss and in the replica-averaged
parameters, and to what tests/test_switcher_async.py checks of it: finite,
falling losses, an accuracy in [0, 1], and replicas that evaluate()
leaves as they were."""
import copy
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import fgnn_tpu_torch.session as sam
from fgnn_tpu.config import RunConfig, SampleType
from fgnn_tpu.data import make_synthetic_dataset
from fgnn_tpu.parallel import switcher as jswitcher
from fgnn_tpu.parallel.async_dp import AsyncFactoredEngine as JAsync
from fgnn_tpu_torch.config import CachePolicy
from fgnn_tpu_torch.models.convert import params_from_flax
from fgnn_tpu_torch.parallel import switcher as tswitcher
from fgnn_tpu_torch.parallel.async_dp import AsyncFactoredEngine
from fgnn_tpu_torch.parallel.factored import FactoredEngine, SGNNEngine
from fgnn_tpu_torch.parallel.switcher import SwitcherEngine
from fgnn_tpu_torch.utils.profiler import Profiler
from torch_parity import ReferenceDraws, params_close, port_cfg, port_ds

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = RunConfig(model="graphsage", fanout=(4, 4), batch_size=64,
                num_hidden=32, sample_type=SampleType.KHOP0, dropout=0.0,
                lr=0.01, num_sample_worker=2, num_train_worker=2,
                compute_dtype="float32")
TOL = 1e-4


@pytest.fixture(scope="module")
def ds():
    return make_synthetic_dataset(num_node=2000, avg_degree=8, feat_dim=32,
                                  num_class=8, seed=42)


def tcfg(**kw):
    return port_cfg(CFG).replace(**kw)


@pytest.mark.parametrize("t_wave,num_waves,g_t,g_full,T,W,num_step,force", [
    (0.01, 4, 0.02, 0.02, 1, 3, 8, False),    # backlog pays
    (0.01, 4, 0.02, 0.05, 1, 3, 8, False),    # the full group is slower
    (0.01, 4, 0.02, 0.05, 1, 3, 8, True),     # ... forced
    (0.10, 8, 0.01, 0.01, 2, 4, 16, False),   # training keeps pace
    (0.10, 8, 0.01, 0.03, 2, 4, 16, False),   # ... and the tail declines
    (0.10, 8, 0.01, 0.03, 2, 4, 3, True),     # a minimal tail past the epoch
    (0.00, 1, 0.50, 0.40, 3, 5, 7, False),
])
def test_tail_reserve_policy_matches_reference(t_wave, num_waves, g_t,
                                               g_full, T, W, num_step, force):
    args = (t_wave, num_waves, g_t, g_full, T, W, num_step)
    assert (tswitcher.tail_reserve_policy(*args, force=force)
            == jswitcher.tail_reserve_policy(*args, force=force))


def test_switcher_forced_tail_trains_on_all_devices(ds, monkeypatch):
    """FGNN_TPU_SWITCHER_FORCE=1 engages the tail: with S=2, T=1 its groups
    are 3 wide over the trainer then the samplers, a replica each; the
    calibration probe leaves the model as it found it."""
    monkeypatch.setenv("FGNN_TPU_SWITCHER_FORCE", "1")
    cfg = tcfg(num_sample_worker=2, num_train_worker=1, have_switcher=True,
               batch_size=32)
    eng = SwitcherEngine(cfg, port_ds(ds), ["cpu"] * 3)
    assert eng.num_full == 3
    widths = []
    orig = eng._train_group

    def spy(group, width, devices):
        widths.append((width, len(group), eng._in_tail))
        return orig(group, width, devices)

    eng._train_group = spy
    before = copy.deepcopy(eng.model.state_dict())
    reserve = eng._calibrate_tail_reserve()
    for k, v in eng.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    eng._tail_reserve_batches = reserve
    widths.clear()
    r = eng.run_epoch(0)
    assert np.isfinite(r["loss"]) and reserve >= 1
    tail = [w for w in widths if w[2]]
    assert tail and all(w[0] == 3 for w in tail)
    assert sum(n for _, n, _ in tail) == eng.tail_batches == reserve
    assert sum(n for _, n, _ in widths) == eng.num_step
    assert len(eng.replicas) == 3


def test_switcher_own_cache(ds):
    """switch_cache_percentage builds a second, smaller cache from the same
    ranking, which the tail's groups read (DoSwitchCacheFeatureCopy
    analog); two epochs train."""
    cfg = tcfg(have_switcher=True, switch_cache_percentage=0.1,
               cache_policy=CachePolicy.PRESAMPLE, cache_percentage=0.2)
    eng = SwitcherEngine(cfg, port_ds(ds), ["cpu"] * 4, feat_on_trainer=False)
    assert eng.switch_cache is not None
    assert eng.switch_cache.num_cache < eng.cache.num_cache
    r0, r1 = eng.run_epoch(0), eng.run_epoch(1)
    assert np.isfinite(r0["loss"]) and r1["loss"] < r0["loss"]


def test_async_engine_matches_reference(ds):
    """async_sync_every=1, S=1, T=2: the epoch loss and the replica-averaged
    parameters within 1e-4 of the reference's; then the reference test's
    checks: finite, falling losses over a second epoch, finite consolidated
    parameters, an accuracy in [0, 1], replicas untouched by evaluate()."""
    cfg = CFG.replace(num_sample_worker=1, async_train=True,
                      async_sync_every=1)
    jeng = JAsync(cfg, ds, devices=jax.devices()[:3])
    draws = ReferenceDraws(cfg.seed, cfg.sample_type)
    teng = AsyncFactoredEngine(port_cfg(cfg), port_ds(ds), ["cpu"] * 3,
                               rand_fn=draws)
    draws.bind(teng, True)
    params = params_from_flax(jax.tree.map(lambda x: x[0], jeng.state.params))
    for m in teng.replicas.values():
        m.load_state_dict(params)
    r0, j0 = teng.run_epoch(0), jeng.run_epoch(0)
    assert abs(r0["loss"] - j0["loss"]) < TOL, (r0["loss"], j0["loss"])
    cons = teng.consolidated_state()
    teng.model.load_state_dict(cons)   # the replicas are equal at sync 1
    params_close(jeng.consolidated_state().params, teng.model, TOL)
    r1 = teng.run_epoch(1)
    assert np.isfinite(r0["loss"]) and r1["loss"] < r0["loss"]
    assert all(torch.isfinite(v).all()
               for v in teng.consolidated_state().values())
    held = [copy.deepcopy(m.state_dict()) for m in teng.replicas.values()]
    assert 0.0 <= teng.evaluate() <= 1.0
    for m, h in zip(teng.replicas.values(), held):
        for k, v in m.state_dict().items():
            assert torch.equal(v, h[k])


def test_async_replicas_drift_between_syncs(ds):
    """async_sync_every=2: after an odd number of groups the replicas
    differ (no per-group reduce); after the averaging they are equal."""
    eng = AsyncFactoredEngine(tcfg(num_sample_worker=1, async_train=True,
                                   async_sync_every=2),
                              port_ds(ds), ["cpu"] * 3)
    eng._stats = []
    pending = []
    seeds = list(eng.shufflers[0].batches(0))[:2]
    for s, n, _ in seeds:
        b = eng.sample(torch.device("cpu"), torch.as_tensor(s), n,
                       torch.Generator().manual_seed(n), True)
        pending.append((b, None))
    eng._train_group(pending, 2, eng._group_devices(2))
    a, b = (list(m.parameters()) for m in (eng.replicas[0], eng.replicas[1]))
    assert any(not torch.equal(p, q) for p, q in zip(a, b))
    eng._train_group(pending, 2, eng._group_devices(2))
    assert all(torch.equal(p, q) for p, q in zip(a, b))


# -- the session and the app ----------------------------------------------------
@pytest.mark.parametrize("arch,extra,cls", [
    ("arch5", {}, FactoredEngine),
    ("arch5", {"async_train": True}, AsyncFactoredEngine),
    ("arch5", "switch", SwitcherEngine),
    ("arch6", {}, SGNNEngine),
])
def test_session_builds_multi_device_engines(arch, extra, cls):
    """The reference's dispatch (fgnn_tpu/session.py:109-138): arch5 to the
    switcher after switch_init, else the async engine with async_train,
    else FactoredEngine; arch6 to SGNNEngine. ``ctx`` is the device list;
    an epoch runs, and the stepwise sample_once names run_epoch."""
    sam._reset_for_tests()
    Profiler.reset()
    sam.config(dict(dataset="synthetic", synthetic_nodes=2000,
                    model="graphsage", arch=arch, fanout=(4, 4),
                    batch_size=256, num_hidden=16, num_epoch=1,
                    sample_type="khop0", num_sample_worker=1,
                    num_train_worker=2, compute_dtype="float32",
                    **(extra if isinstance(extra, dict) else {})))
    sam.data_init()
    if extra == "switch":
        sam.switch_init(0, "cpu", 0.1)
        assert sam._session.cfg.have_switcher
        assert sam._session.cfg.switch_cache_percentage == 0.1
    sam.sample_init(0, ["cpu"] * 3)
    sam.train_init(0, ["cpu"] * 3)
    eng = sam._session.engine
    assert type(eng) is cls
    assert np.isfinite(eng.run_epoch(0)["loss"])
    assert sam.steps_per_epoch() > 0
    with pytest.raises(TypeError, match="run_epoch"):
        sam.sample_once()
    sam.shutdown()


APP_RUNS = [
    ("arch5", ["--devices", "cpu,cpu"]),
    ("arch6", ["--num-train-worker", "2"]),
]


@pytest.fixture(scope="module")
def app_procs(tmp_path_factory):
    """The app's runs of APP_RUNS, started together at first use (each one
    mostly imports torch), by arch."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("FGNN_TPU_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = {arch: subprocess.Popen(
        [sys.executable, "-m", "fgnn_tpu_torch.examples.train_gnn",
         "--device", "cpu", "--arch", arch, "--synthetic-nodes", "3000",
         "--num-epoch", "3", "--fanout", "5", "5", "--batch-size", "256",
         "--num-hidden", "16", "--lr", "0.01", *extra],
        cwd=tmp_path_factory.mktemp(arch), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for arch, extra in APP_RUNS}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.mark.parametrize("arch,extra", APP_RUNS)
def test_app_runs_multi_device_archs(app_procs, arch, extra):
    """``python -m fgnn_tpu_torch.examples.train_gnn --arch arch5 --devices
    cpu,cpu --device cpu`` (and arch6 on --device's CPU twice) on a tiny
    graph, three epochs: rc 0, the role devices, a falling loss and the
    result lines."""
    out, err = app_procs[arch].communicate(timeout=600)
    assert app_procs[arch].returncode == 0, err
    lines = out.splitlines()
    assert "test_result:devices=cpu,cpu" in lines
    losses = [float(ln.split("Loss ")[1].split()[0]) for ln in lines
              if ln.startswith("Epoch ")]
    assert len(losses) == 3 and losses[2] < losses[0]
    for key in ("epoch_time", "first_epoch_loss", "num_step"):
        assert any(ln.startswith(f"test_result:{key}=") for ln in lines), key
