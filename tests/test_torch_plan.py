"""Host planning and batch order: the port's NumPy copies must give the
JAX package's plans and seed arrays exactly, so batches line up one for
one between the frameworks."""
import numpy as np
import pytest
import torch

from fgnn_tpu.data import make_synthetic_dataset
from fgnn_tpu.ops import padding as jpadding
from fgnn_tpu.ops import reference_impl as jref
from fgnn_tpu.parallel import shuffler as jshuffler
from fgnn_tpu_torch.ops import padding as tpadding
from fgnn_tpu_torch.ops import reference_impl as tref
from fgnn_tpu_torch.parallel import shuffler as tshuffler

torch.set_num_threads(2)

TIERS = (4, 6, 8, 10, 12, 14, 16, 20)


@pytest.fixture(scope="module")
def ds():
    return make_synthetic_dataset(num_node=4000, avg_degree=12, feat_dim=8,
                                  num_class=4, train_frac=0.3, seed=5)


@pytest.fixture(autouse=True)
def _no_env_overrides(monkeypatch):
    # the reference reads these; the port has no environment knobs
    monkeypatch.delenv("FGNN_TPU_ALLOC_SCALE", raising=False)
    monkeypatch.delenv("FGNN_TPU_CAP_BUCKET", raising=False)


@pytest.mark.parametrize("fanouts", [(25, 10), (10, 3), (5, 10, 15)])
def test_calibrate_and_plan_identical(ds, fanouts):
    fan_sampling = list(reversed(fanouts))
    args = (np.asarray(ds.indptr), np.asarray(ds.indices),
            np.asarray(ds.train_set), 256, fan_sampling)
    jcaps, jtiers = jref.calibrate_caps(*args, seed=3, tier_candidates=TIERS)
    tcaps, ttiers = tref.calibrate_caps(*args, seed=3, tier_candidates=TIERS)
    assert jcaps == tcaps and jtiers == ttiers
    assert (jref.calibrate_caps(*args, seed=4)
            == tref.calibrate_caps(*args, seed=4))
    for kw in ({}, {"unique_caps": jcaps},
               {"unique_caps": jcaps, "tier_stats": jtiers},
               {"unique_caps": [c for c, _ in jcaps], "scale": 1.5}):
        jp = jpadding.make_plan(256, fanouts, ds.num_node, **kw)
        tp = tpadding.make_plan(256, fanouts, ds.num_node, **kw)
        assert dataclasses_equal(jp, tp), (jp, tp)


def dataclasses_equal(a, b):
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)


def test_main_path_plan_has_tiers(ds):
    args = (np.asarray(ds.indptr), np.asarray(ds.indices),
            np.asarray(ds.train_set), 256, [10, 25])
    caps, tiers = tref.calibrate_caps(*args, tier_candidates=TIERS)
    plan = tpadding.make_plan(256, (25, 10), ds.num_node, unique_caps=caps,
                              tier_stats=tiers)
    assert plan.tier_layout is not None
    assert sum(c for c, _ in plan.tier_layout) == plan.num_input_cap[-1]
    assert plan.num_edge_cap[-1] == sum(c * w for c, w in plan.tier_layout)


@pytest.mark.parametrize("epoch", [0, 3])
def test_epoch_shuffler_identical(ds, epoch):
    kw = dict(train_set=ds.train_set, batch_size=256, seed_cap=384,
              base_seed=7)
    js, ts = jshuffler.EpochShuffler(**kw), tshuffler.EpochShuffler(**kw)
    assert js.num_step == ts.num_step
    for a, b in zip(js.epoch_arrays(epoch), ts.epoch_arrays(epoch)):
        np.testing.assert_array_equal(a, b)
    for (sa, na, ka), (sb, nb, kb) in zip(js.batches(epoch), ts.batches(epoch)):
        np.testing.assert_array_equal(sa, sb)
        assert (na, ka) == (nb, kb)
    jd = jshuffler.EpochShuffler(**kw, drop_last=True)
    td = tshuffler.EpochShuffler(**kw, drop_last=True)
    assert jd.num_step == td.num_step
