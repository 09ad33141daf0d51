"""The port's own host modules against the JAX package's: configuration,
constants, the synthetic generator and the on-disk dataset format. The
port keeps copies of them (it imports nothing of fgnn_tpu), so these hold
the copies to the originals exactly: equal fields, defaults, enum values
and constants, and bit-equal arrays."""
import dataclasses
import enum
import os

import numpy as np
import pytest

import fgnn_tpu.constants as jconstants
from fgnn_tpu import config as jconfig
from fgnn_tpu.data import loader as jloader
from fgnn_tpu.data import synthetic as jsynthetic
from fgnn_tpu_torch import config as tconfig
from fgnn_tpu_torch import constants as tconstants
from fgnn_tpu_torch.data import loader as tloader
from fgnn_tpu_torch.data import synthetic as tsynthetic
from fgnn_tpu_torch.utils import Timer, get_logger
from torch_parity import port_cfg, port_ds


def plain(v):
    return v.value if isinstance(v, enum.Enum) else v


def as_values(cfg):
    return {f.name: plain(getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


def test_constants_are_equal():
    names = [n for n in dir(jconstants) if n.isupper()]
    assert names == [n for n in dir(tconstants) if n.isupper()]
    for n in names:
        assert getattr(tconstants, n) == getattr(jconstants, n), n


@pytest.mark.parametrize("name", ["SampleType", "CachePolicy", "RunArch"])
def test_enums_have_the_reference_members(name):
    j, t = getattr(jconfig, name), getattr(tconfig, name)
    assert [(m.name, m.value) for m in j] == [(m.name, m.value) for m in t]
    if name == "SampleType":
        assert [m.is_khop for m in j] == [m.is_khop for m in t]


def test_run_config_fields_and_defaults_are_equal():
    jf = dataclasses.fields(jconfig.RunConfig)
    tf = dataclasses.fields(tconfig.RunConfig)
    assert [f.name for f in jf] == [f.name for f in tf]
    assert as_values(jconfig.RunConfig()) == as_values(tconfig.RunConfig())
    j, t = jconfig.RunConfig(), tconfig.RunConfig()
    for prop in ("num_layer", "num_fanout", "use_cache"):
        assert getattr(j, prop) == getattr(t, prop), prop


@pytest.mark.parametrize("d", [
    {},
    {"arch": "arch2", "sample_type": "khop0", "fanout": [5, 10, 15],
     "cache_policy": "pre_sample", "cache_percentage": 0.1},
    {"arch": 4, "cache_policy": "dynamic_cache", "cache_percentage": 0.2,
     "model": "gcn", "pipeline": False},
    {"sample_type": "random_walk", "num_layer_rw": 2, "num_neighbor": 3,
     "model": "pinsage", "compute_dtype": "float32"},
])
def test_from_dict_equals_the_reference(d):
    j, t = jconfig.RunConfig.from_dict(d), tconfig.RunConfig.from_dict(d)
    assert as_values(j) == as_values(t)
    assert as_values(t.replace(seed=3)) == as_values(j.replace(seed=3))
    assert as_values(port_cfg(j)) == as_values(j)
    assert isinstance(port_cfg(j).sample_type, tconfig.SampleType)


def test_from_dict_rejects_what_the_reference_rejects():
    with pytest.raises(KeyError):
        tconfig.RunConfig.from_dict({"no_such_key": 1})
    with pytest.raises(ValueError):
        tconfig.RunConfig.from_dict({"cache_percentage": 1.5})
    with pytest.raises(ValueError):
        tconfig.RunConfig(fanout=()).validate()


def test_env_helpers(monkeypatch):
    monkeypatch.setenv("FGNN_TORCH_TEST_FLAG", "off")
    monkeypatch.setenv("FGNN_TORCH_TEST_INT", "7")
    for mod in (jconfig, tconfig):
        assert mod.env_flag("FGNN_TORCH_TEST_FLAG", True) is False
        assert mod.env_int("FGNN_TORCH_TEST_INT") == 7
        assert mod.env_int("FGNN_TORCH_TEST_MISSING", 3) == 3


DATASET_ARGS = [
    dict(num_node=3000, avg_degree=8, feat_dim=16, num_class=4, seed=1),
    dict(num_node=5000, avg_degree=10, feat_dim=8, num_class=4,
         train_frac=0.2, seed=3, neighbor_skew=6.0, neighbor_pref=0.5),
    dict(num_node=4000, avg_degree=6, feat_dim=8, num_class=3, seed=5,
         neighbor_lognormal_sigma=3.0),
    dict(num_node=2000, avg_degree=8, feat_dim=16, num_class=4, seed=1,
         empty_feat_rows=100),
    # the papers100M tools' law: lognormal targets and a mock table
    dict(num_node=6000, avg_degree=14, feat_dim=8, num_class=7, seed=2,
         train_frac=0.01, neighbor_skew=6.0, neighbor_lognormal_sigma=3.0,
         empty_feat_rows=256),
]


def assert_datasets_equal(j, t):
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("kw", DATASET_ARGS,
                         ids=["plain", "skew-pref", "lognormal", "empty-feat",
                              "lognormal-empty-feat"])
def test_make_synthetic_dataset_is_bit_equal(kw):
    j = jsynthetic.make_synthetic_dataset(**kw)
    t = tsynthetic.make_synthetic_dataset(**kw)
    assert_datasets_equal(j, t)
    assert t.feat_mod == j.feat_mod and t.feat_dim == j.feat_dim
    np.testing.assert_array_equal(t.degrees(), j.degrees())
    assert_datasets_equal(j, port_ds(j))


def test_build_alias_tables_is_bit_equal():
    kw = dict(num_node=300, avg_degree=6, feat_dim=4, num_class=2, seed=9)
    j = jsynthetic.make_synthetic_dataset(**kw)
    t = tsynthetic.make_synthetic_dataset(**kw)
    jsynthetic.build_alias_tables(j, seed=4)
    tsynthetic.build_alias_tables(t, seed=4)
    assert t.prob_table is not None
    assert_datasets_equal(j, t)


def test_validate_rejects_a_truncated_feature_table():
    t = tsynthetic.make_synthetic_dataset(num_node=200, avg_degree=4,
                                          feat_dim=4, num_class=2)
    t.feat = t.feat[:100]
    with pytest.raises(ValueError, match="truncated"):
        t.validate()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_load_dataset_reads_the_reference_format(tmp_path, writer):
    """A dataset written by either package's write_dataset loads through
    the port's mmap loader exactly as through the reference's, and both
    writers produce the same files."""
    kw = dict(num_node=1500, avg_degree=7, feat_dim=12, num_class=5, seed=2,
              name="tiny")
    ds = jsynthetic.make_synthetic_dataset(**kw)
    jsynthetic.build_alias_tables(ds)
    root = str(tmp_path)
    if writer == "reference":
        d = jsynthetic.write_dataset(ds, root)
    else:
        d = tsynthetic.write_dataset(port_ds(ds), root)
        other = jsynthetic.write_dataset(ds, str(tmp_path / "ref"))
        for f in sorted(os.listdir(other)):
            with open(os.path.join(other, f), "rb") as a, \
                    open(os.path.join(d, f), "rb") as b:
                assert a.read() == b.read(), f
    j = jloader.load_dataset("tiny", root=root)
    t = tloader.load_dataset("tiny", root=root)
    assert isinstance(t.feat, np.memmap)
    assert_datasets_equal(j, t)
    assert tloader.parse_meta(os.path.join(d, tconstants.META_FILE)) == \
        jloader.parse_meta(os.path.join(d, jconstants.META_FILE))
    ranking = np.random.default_rng(0).permutation(1500).astype(np.uint32)
    ranking.tofile(os.path.join(d, tconstants.CACHE_BY_DEGREE_FILE))
    np.testing.assert_array_equal(
        tloader.load_cache_ranking("tiny", tconstants.CACHE_BY_DEGREE_FILE,
                                   root=root),
        jloader.load_cache_ranking("tiny", jconstants.CACHE_BY_DEGREE_FILE,
                                   root=root))
    # empty-feat mode: a fake table indexed modulo
    e = tloader.load_dataset("tiny", root=root, empty_feat=8)
    je = jloader.load_dataset("tiny", root=root, empty_feat=8)
    assert e.empty_feat == je.empty_feat and e.feat.shape == je.feat.shape


def test_logger_and_timer():
    log = get_logger("fgnn_tpu_torch.test")
    assert log is get_logger("fgnn_tpu_torch.test") and len(log.handlers) == 1
    t = Timer()
    assert 0.0 <= t.passed() < 60.0 and Timer.now_us() > 0
