"""The port's session API (``fgnn_tpu_torch/session.py``): the port of
tests/test_session.py and of test_profile_levels.py's
``test_init_items_real``, a session-driven epoch against ``run_epoch``
(the same batches, features, dropout masks and updates: parameters bit
for bit), and the multi-device archs refusing too few devices."""
import numpy as np
import pytest
import torch

import fgnn_tpu_torch.session as sam
from fgnn_tpu_torch.config import CachePolicy
from fgnn_tpu_torch.data import make_synthetic_dataset
from fgnn_tpu_torch.engine import OneChipEngine
from fgnn_tpu_torch.train.loop import masked_cross_entropy, train_step
from fgnn_tpu_torch.utils.profiler import Profiler

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ds():
    return make_synthetic_dataset(num_node=2000, avg_degree=8, feat_dim=32,
                                  num_class=8, seed=42)


@pytest.fixture(autouse=True)
def fresh_session(monkeypatch):
    for k in ("FGNN_TPU_DUMP_TRACE", "FGNN_TPU_LOG_NODE_ACCESS",
              "FGNN_TPU_SANITY_CHECK", "FGNN_TPU_FEAT_HBM_BUDGET"):
        monkeypatch.delenv(k, raising=False)
    Profiler.reset()
    sam._reset_for_tests()
    yield
    sam._reset_for_tests()
    Profiler.reset()


def test_session_stepwise_loop(ds):
    """tests/test_session.py on the port: sample ahead, take a batch, its
    blocks, features and labels, a forward pass and a finite loss."""
    sam.config({
        "model": "graphsage", "fanout": [4, 4], "batch_size": 64,
        "num_hidden": 32, "sample_type": "khop0", "arch": 1,
        "dropout": 0.0, "dataset": "synthetic",
    })
    sam._session.ds = ds
    sam.sample_init(0, "cpu")

    sam.extract_start(2)
    key = sam.get_next_batch()
    blocks, feats, labels = sam.get_blocks(key, 2)
    assert len(blocks) == 2
    assert feats.shape[0] == sam.get_graph_input_nodes(key).shape[0]
    assert int(sam.num_class()) == ds.num_class
    assert sam.feat_dim() == ds.feat_dim and sam.num_epoch() == 10

    eng = sam._session.engine
    eng.model.eval()
    with torch.no_grad():
        logits = eng.model(sam.get_batch(key), feats, eng.dst_caps)
    loss, _ = masked_cross_entropy(logits[:64], labels[:64])
    assert np.isfinite(float(loss))
    assert sam.get_graph_num_src(key, 0) > 0
    assert sam.get_graph_num_dst(key, 1) == 64
    sam.release_batch(key)

    key2 = sam.get_next_batch()
    assert key2 != key
    # get_blocks logs the conversion (kLogL1ConvertTime)
    assert Profiler.get().get_step_value(key, "L1_convert_time") > 0.0
    sam.shutdown()


def test_init_items_real():
    """init_load_dataset and init_copy are the wall clock of the load and
    the device placement, not constants, on arch1."""
    sam.config({"model": "graphsage", "fanout": (3, 5), "batch_size": 64,
                "num_hidden": 32, "sample_type": "khop0", "num_epoch": 1,
                "dataset": "synthetic", "synthetic_nodes": 2000, "arch": 1})
    sam.data_init()
    prof = Profiler.get()
    assert prof.get_init_value("init_load_dataset") > 0.0
    sam.sample_init(0, "cpu")
    assert prof.get_init_value("init_copy") > 0.0
    assert prof.get_init_value("init_other") > 0.0
    assert "init_copy=" in sam.report_init()
    sam.shutdown()


CFG = {"model": "graphsage", "fanout": [10, 3], "batch_size": 128,
       "num_hidden": 32, "sample_type": "khop2", "arch": 1, "dropout": 0.5,
       "lr": 0.003, "compute_dtype": "float32"}


@pytest.mark.parametrize("path", ["device", "host-cache"])
def test_session_epoch_equals_run_epoch(ds, path):
    """An epoch driven through the session (sample_once, get_next_batch,
    get_blocks, the app's train_step with the engine's dropout generator)
    trains on what run_epoch trains on: the same parameters after it, bit
    for bit, and the same mean loss."""
    sam.config(CFG)
    sam._session.ds = ds
    if path == "host-cache":
        # the host table through a presample cache
        sam._session.cfg = sam._session.cfg.replace(
            cache_policy=CachePolicy.PRESAMPLE, cache_percentage=0.2)
        budget = 0
    else:
        budget = None
    cfg = sam._session.cfg
    sam._session.engine = OneChipEngine(cfg, ds, "cpu", feat_budget=budget)
    ref = OneChipEngine(cfg, ds, "cpu", feat_budget=budget)
    eng = sam._session.engine
    losses = []
    for _ in range(sam.steps_per_epoch()):
        sam.sample_once()
        key = sam.get_next_batch()
        _, feats, labels = sam.get_blocks(key, 2)
        loss, _ = train_step(eng.model, eng.optimizer, sam.get_batch(key),
                             feats, labels, eng.dst_caps, cfg.batch_size,
                             generator=eng.dropout_gen)
        losses.append(loss)
        sam.release_batch(key)
    r = ref.run_epoch(0)
    assert abs(float(torch.stack(losses).mean()) - r["loss"]) < 1e-6
    for (name, p), q in zip(eng.model.named_parameters(),
                            ref.model.parameters()):
        assert torch.equal(p, q), name
    # the next sample_once starts epoch 1
    sam.sample_once()
    assert sam.get_next_batch() == sam.steps_per_epoch()


@pytest.mark.parametrize("arch", ["arch5", "arch6"])
def test_multi_device_archs_name_a16(ds, arch):
    """The multi-device archs (ROADMAP A16, ported since) take their role
    devices as ``ctx`` and refuse too few, naming the counts;
    ``switch_init`` comes before the engine is built."""
    sam.config({**CFG, "arch": arch, "num_train_worker": 2})
    sam._session.ds = ds
    with pytest.raises(ValueError, match="needs .* devices and 1 were given"):
        sam.sample_init(0, ["cpu"])
    sam.sample_init(0, "cpu")
    with pytest.raises(RuntimeError, match="switch_init must precede"):
        sam.switch_init(0, "cpu", 0.1)


def test_stepwise_api_needs_the_one_device_engine(ds):
    sam.config({**CFG, "arch": 0})
    sam._session.ds = ds
    sam.sample_init(0, "cpu")
    with pytest.raises(TypeError, match="arch0"):
        sam.sample_once()


def test_load_subtensor_reads_tables_and_host_arrays(ds):
    ids = torch.tensor([5, -1, 0, 1999], dtype=torch.int32)
    table = torch.as_tensor(np.asarray(ds.feat))
    want = table[ids.clamp(min=0).long()] * (ids >= 0)[:, None]
    assert torch.equal(sam.load_subtensor(table, ids), want)
    assert torch.equal(sam.load_subtensor(np.asarray(ds.feat), ids), want)
