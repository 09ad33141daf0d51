"""Checkpoints (``fgnn_tpu_torch/train/checkpoint.py`` and the engine's
``ckpt_dir`` / ``ckpt_every``): the manager's round trip, keep-3 and atomic
writes, and an engine rebuilt from a checkpoint resuming where the saved one
stopped. The reference keys its draws by (epoch, step); the port's
generators carry state, so the payload holds them and a resumed epoch is
bit-equal to the uninterrupted one."""
import os

import numpy as np
import pytest
import torch

from fgnn_tpu_torch.config import CachePolicy, RunConfig, SampleType
from fgnn_tpu_torch.data import make_synthetic_dataset
from fgnn_tpu_torch.engine import OneChipEngine
from fgnn_tpu_torch.train.checkpoint import CheckpointManager
from fgnn_tpu_torch.utils.profiler import Profiler

torch.set_num_threads(2)

CFG = RunConfig(model="graphsage", fanout=(4, 4), batch_size=128,
                num_hidden=32, sample_type=SampleType.KHOP0, dropout=0.5,
                lr=0.01, compute_dtype="float32")


@pytest.fixture(scope="module")
def ds():
    return make_synthetic_dataset(num_node=2000, avg_degree=8, feat_dim=16,
                                  num_class=4, seed=3)


@pytest.fixture(autouse=True)
def no_observers(monkeypatch):
    for k in ("FGNN_TPU_DUMP_TRACE", "FGNN_TPU_LOG_NODE_ACCESS",
              "FGNN_TPU_SANITY_CHECK", "FGNN_TPU_FEAT_HBM_BUDGET"):
        monkeypatch.delenv(k, raising=False)
    Profiler.reset()


def test_manager_round_trip_and_keep_three(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.available and mgr.latest_epoch() is None
    assert mgr.restore() is None
    states = {e: {"w": torch.randn(3, 4, generator=torch.Generator()
                                   .manual_seed(e)),
                  "gen": torch.Generator().manual_seed(e).get_state(),
                  "step": e * 10}
              for e in range(5)}
    for e in range(5):
        mgr.save(e, states[e])
    assert mgr.epochs() == [2, 3, 4] and mgr.latest_epoch() == 4
    assert sorted(os.listdir(mgr.directory)) == [
        "epoch_00000002.pt", "epoch_00000003.pt", "epoch_00000004.pt"]
    state, epoch = mgr.restore()
    assert epoch == 4 and state["epoch"] == 4 and state["step"] == 40
    assert torch.equal(state["w"], states[4]["w"])
    assert torch.equal(state["gen"], states[4]["gen"])
    # a second manager over the directory sees the same files
    assert CheckpointManager(mgr.directory, max_to_keep=1).latest_epoch() == 4


class NotATensor:
    pass


def test_restore_loads_weights_only(tmp_path):
    """A payload holding an arbitrary object does not load."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, {"obj": NotATensor()})
    with pytest.raises(Exception, match="[Ww]eights only"):
        mgr.restore()


def engine(cfg, ds, path):
    return OneChipEngine(cfg, ds, "cpu",
                         feat_budget=0 if path == "host-cache" else None)


@pytest.mark.parametrize("path", ["device", "host-cache"])
def test_resumed_epoch_equals_the_uninterrupted_one(ds, tmp_path, path):
    cfg = CFG.replace(ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=1)
    if path == "host-cache":
        cfg = cfg.replace(cache_policy=CachePolicy.PRESAMPLE,
                          cache_percentage=0.2)
    a = engine(cfg, ds, path)
    assert a.ckpt is not None and a.start_epoch == 0
    a.run_epoch(0)
    assert a.ckpt.latest_epoch() == 0
    b = engine(cfg, ds, path)
    assert b.start_epoch == 1
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
    assert torch.equal(a.sample_gen.get_state(), b.sample_gen.get_state())
    assert torch.equal(a.dropout_gen.get_state(), b.dropout_gen.get_state())
    ra, rb = a.run_epoch(1), b.run_epoch(b.start_epoch)
    assert ({k: v for k, v in ra.items() if k != "epoch_time"}
            == {k: v for k, v in rb.items() if k != "epoch_time"})
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
    # both saved epoch 1; a third engine resumes at 2
    assert engine(cfg, ds, path).start_epoch == 2


def test_run_epochs_saves_the_last_epoch_of_a_window(ds, tmp_path):
    """As the reference's run_epochs: a window that crosses a multiple of
    ckpt_every saves its last epoch; one that does not saves nothing."""
    cfg = CFG.replace(ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=2)
    eng = OneChipEngine(cfg, ds, "cpu")
    eng.run_epochs(0, 1)
    assert eng.ckpt.latest_epoch() is None
    eng.run_epochs(1, 2)              # epoch 1 crosses, epoch 2 ends it
    assert eng.ckpt.epochs() == [2]
    assert np.isfinite(eng.run_epoch(3)["loss"])
    assert eng.ckpt.epochs() == [2, 3]


def test_no_ckpt_dir_saves_nothing(ds):
    eng = OneChipEngine(CFG.replace(ckpt_every=1), ds, "cpu")
    assert eng.ckpt is None and eng.start_epoch == 0
    eng.run_epoch(0)
