"""The port's profiler (``fgnn_tpu_torch/utils/profiler.py``) against the JAX
package's: the item and lane lists, the writers and their level gating, the
readers and averages, the node-access artifacts (byte for byte, ties
included), the Chrome trace and the result lines, on the same calls drawn
from a NumPy seed. Exact: both keep Python floats and ints."""
import json

import numpy as np
import pytest
import torch

from fgnn_tpu.utils import logging as jlogging
from fgnn_tpu.utils import profiler as jprof
from fgnn_tpu_torch.utils import logging as tlogging
from fgnn_tpu_torch.utils import profiler as tprof


def test_item_and_lane_lists_equal_the_reference():
    assert tprof.STEP_ITEMS == jprof.STEP_ITEMS
    assert tprof.EPOCH_ITEMS == jprof.EPOCH_ITEMS
    assert tprof.INIT_ITEMS == jprof.INIT_ITEMS
    assert tprof.TRACE_ITEMS == jprof.TRACE_ITEMS
    assert len(tprof.TRACE_ITEMS) == 19


def both(level):
    return jprof.Profiler(level=level), tprof.Profiler(level=level)


def random_calls(seed, n=300):
    """A stream of writer calls over every item family."""
    rng = np.random.default_rng(seed)
    items = tprof.STEP_ITEMS
    calls = []
    for _ in range(n):
        kind = rng.integers(4)
        value = float(rng.random())
        if kind == 0:
            calls.append(("log_step", int(rng.integers(40)),
                          items[rng.integers(len(items))], value))
        elif kind == 1:
            calls.append(("log_step_add", int(rng.integers(40)),
                          items[rng.integers(len(items))], value))
        elif kind == 2:
            calls.append(("log_epoch_add", int(rng.integers(4)),
                          tprof.EPOCH_ITEMS[rng.integers(12)], value))
        else:
            calls.append(("log_init", tprof.INIT_ITEMS[rng.integers(6)],
                          value))
    return calls


@pytest.mark.parametrize("level", [1, 2, 3])
def test_writers_gating_and_readers_agree(level):
    jp, tp = both(level)
    for p in (jp, tp):
        p.set_num_step(10)
        for name, *args in random_calls(level):
            getattr(p, name)(*args)
    assert tp.num_step == jp.num_step == 10
    assert tp.step_key(3, 4) == jp.step_key(3, 4) == 34
    for item in tprof.STEP_ITEMS:
        assert tp.has_step_item(item) == jp.has_step_item(item), item
        for key in range(40):
            assert tp.get_step_value(key, item) == jp.get_step_value(key, item)
        for skip in (True, False):
            assert tp.step_average(item, skip) == jp.step_average(item, skip)
    for item in tprof.EPOCH_ITEMS:
        for e in range(4):
            assert tp.get_epoch_value(e, item) == jp.get_epoch_value(e, item)
        for skip in (True, False):
            assert tp.epoch_average(item, skip) == jp.epoch_average(item, skip)
    for item in tprof.INIT_ITEMS:
        assert tp.get_init_value(item) == jp.get_init_value(item)
    assert tp.report_step_average(1, 2) == jp.report_step_average(1, 2)
    assert tp.report_init() == jp.report_init()
    # the gating itself: nothing above the level is kept
    assert tp.has_step_item("L3_remap_unique_time") == (level >= 3)
    assert tp.has_step_item("L2_extract_time") == (level >= 2)


def access_stream(seed, epochs=3, batches=5):
    """Batches of node ids with -1 padding and many tied counts; the first
    batch touches high ids before low ones, so first access and id order
    differ."""
    rng = np.random.default_rng(seed)
    out = [[np.array([90, 7, 90, 55, 3, -1, 7, 120], np.int32)]]
    for _ in range(epochs):
        out.append([np.where(rng.random(60) < 0.1, -1,
                             rng.integers(0, 150, 60)).astype(np.int32)
                    for _ in range(batches)])
    return out


def log_accesses(p, stream):
    p.log_node_access = True
    for epoch in stream:
        p.begin_node_access_epoch()
        for batch in epoch:
            p.log_node_access_batch(batch)


@pytest.mark.parametrize("seed", [0, 1])
def test_node_access_artifacts_byte_equal(tmp_path, seed):
    jp, tp = both(1)
    stream = access_stream(seed)
    log_accesses(jp, stream)
    log_accesses(tp, stream)
    counts = tp.node_access_frequency()
    ref = jp.node_access_frequency()
    assert {int(i): int(counts[i]) for i in np.nonzero(counts)[0]} == dict(ref)
    assert tp.node_access_similarity() == jp.node_access_similarity()
    for points in (5, 21, 101):
        assert (tp.optimal_cache_hit_curve(150, points)
                == jp.optimal_cache_hit_curve(150, points))
    # Counter.most_common breaks ties by first access
    np.testing.assert_array_equal(tp.node_access_ranking(),
                                  [n for n, _ in ref.most_common()])
    jp.report_node_access(str(tmp_path / "ref"), 150)
    tp.report_node_access(str(tmp_path / "port"), 150)
    for suffix in ("_ranking.bin", "_access.json"):
        assert ((tmp_path / f"port{suffix}").read_bytes()
                == (tmp_path / f"ref{suffix}").read_bytes()), suffix


def test_node_access_off_counts_nothing():
    tp = tprof.Profiler(level=1)
    tp.log_node_access = False
    tp.begin_node_access_epoch()
    tp.log_node_access_batch(np.arange(10))
    assert tp.node_access_frequency().sum() == 0
    assert tp.node_access_similarity() == []


def test_dump_trace_and_lane_summary_equal(tmp_path):
    jp, tp = both(1)
    names = list(tprof.TRACE_ITEMS) + ["wave_sample", "wave_train"]
    for p in (jp, tp):
        t = 0.0
        for i in range(50):
            name = names[(i * 5) % len(names)]
            p.trace_event(i // 5, name, t, t + 10.0 * (1 + i % 3))
            t += 15.0
    jp.dump_trace(str(tmp_path / "ref.json"))
    tp.dump_trace(str(tmp_path / "port.json"))
    ref = json.loads((tmp_path / "ref.json").read_text())
    port = json.loads((tmp_path / "port.json").read_text())
    assert port == ref
    lanes = [e["args"]["name"] for e in port["traceEvents"] if e["ph"] == "M"]
    # the reference lanes in order, then the others by first appearance
    assert lanes == tprof.TRACE_ITEMS + ["wave_train", "wave_sample"]
    assert tp.lane_summary() == jp.lane_summary()


def test_trace_scope_opens_a_torch_profiler_range(monkeypatch):
    """With a trace on, a span is also a record_function range named after
    its lane; with it off, span() records nothing."""
    from torch.profiler import ProfilerActivity, profile

    tp = tprof.Profiler(level=1)
    monkeypatch.delenv("FGNN_TPU_DUMP_TRACE", raising=False)
    with tp.span(0, "kL1Event_Sample"):
        pass
    assert tp.lane_summary() == {}
    monkeypatch.setenv("FGNN_TPU_DUMP_TRACE", "1")
    assert tp.trace_enabled
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tp.span(7, "kL1Event_Sample"):
            torch.ones(4).sum()
    assert "kL1Event_Sample" in {e.name for e in prof.events()}
    (event,) = tp._trace
    assert event["key"] == 7 and event["dur"] >= 0


def test_env_knobs_read_as_the_reference(monkeypatch):
    monkeypatch.setenv("FGNN_TPU_PROFILE_LEVEL", "3")
    monkeypatch.setenv("FGNN_TPU_LOG_NODE_ACCESS", "1")
    monkeypatch.setenv("FGNN_TPU_DUMP_TRACE", "1")
    jp, tp = jprof.Profiler(), tprof.Profiler()
    assert tp.level == jp.level == 3
    assert tp.log_node_access and jp.log_node_access
    assert tp.trace_enabled and jp.trace_enabled
    monkeypatch.delenv("FGNN_TPU_PROFILE_LEVEL")
    monkeypatch.delenv("FGNN_TPU_LOG_NODE_ACCESS")
    jp, tp = jprof.Profiler(), tprof.Profiler()
    assert tp.level == jp.level == 1
    assert not tp.log_node_access and not jp.log_node_access


def test_singleton_get_and_reset():
    tprof.Profiler.reset()
    p = tprof.Profiler.get()
    assert tprof.Profiler.get() is p
    tprof.Profiler.reset()
    assert tprof.Profiler.get() is not p


def test_result_lines_equal_the_reference(capsys):
    for mod in (jlogging, tlogging):
        mod.log_config("model", "graphsage")
        mod.log_test_result("epoch_time", "0.4321")
    ref, port = capsys.readouterr().out.split("config:model", 2)[1:]
    assert ref == port
