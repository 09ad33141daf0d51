"""The papers100M- and uk-union-scale tools against the reference's
``tools/papers100m_rehearsal.py``, ``exp/table1/run_papers100m.py`` and
``tools/ukunion_rehearsal.py``, at small sizes on the CPU.

The generators write the reference's files byte for byte (the reference's
runs in a process of its own; the uk-union one under ``python -O`` with its
size constants patched, so its own code runs with its ``> 2**31`` assert
stripped). The loaded datasets, the engines' configurations and the
feature-budget environment equal the reference's, with the engines
recorded. The Table-1 driver starts the reference's children with the
reference's arguments and merges earlier rows as the reference does. The
reference modules are executed with ``jax.config.update`` held, so their
compile-cache settings do not reach this process."""
import argparse
import dataclasses
import enum
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fgnn_tpu_torch.exp import table1_papers100m as t1p
from fgnn_tpu_torch.tools import papers100m_rehearsal as reh
from fgnn_tpu_torch.tools import ukunion_rehearsal as uk
from torch_parity import port_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODES = 20000
FILES = ("indptr.npy", "indices.npy", "feat.npy", "label.npy")
BUDGET = "FGNN_TPU_FEAT_HBM_BUDGET"


def load_reference(rel, monkeypatch):
    import jax

    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location(
        "ref_" + os.path.basename(rel)[:-3], os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def plain(cfg):
    return {f.name: (v.value if isinstance(v, enum.Enum) else v)
            for f in dataclasses.fields(cfg) for v in [getattr(cfg, f.name)]}


def assert_datasets_equal(j, t):
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.fixture
def budget_env(monkeypatch):
    """Whatever the code under test does to the feature-budget variable is
    undone after the test."""
    monkeypatch.setenv(BUDGET, "-1")
    monkeypatch.delenv(BUDGET)
    monkeypatch.setenv("FGNN_TPU_PERSTEP_FUSED", "0")
    monkeypatch.delenv("FGNN_TPU_PERSTEP_FUSED")


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """``--gen-only`` at NODES nodes: the reference tool's cache (its own
    process) and the port's."""
    root = tmp_path_factory.mktemp("p100m")
    ref, port = str(root / "ref"), str(root / "port")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tools", "papers100m_rehearsal.py"),
         "--num-node", str(NODES), "--gen-only", "--cache-dir", ref],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=REPO)
    assert reh.main(["--num-node", str(NODES), "--gen-only",
                     "--cache-dir", port]) == 0
    out, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, out
    return ref, port


def test_gen_only_files_equal_the_reference(caches):
    ref, port = caches
    name = reh.stamp(NODES)
    assert name == f"n{NODES}_d14_s6.0_l3.0_seed0"
    assert os.listdir(ref) == os.listdir(port) == [name]
    for f in FILES:
        with open(os.path.join(ref, name, f), "rb") as a, \
                open(os.path.join(port, name, f), "rb") as b:
            assert a.read() == b.read(), f


class Captured(Exception):
    pass


def capture_engine(monkeypatch, target, seen):
    """Replace the engine class at ``target`` by one that records its
    arguments and the feature-budget variable, then stops the tool."""
    def engine(cfg, ds, *device, **kw):
        seen.append((cfg, ds, os.environ.get(BUDGET)))
        raise Captured
    monkeypatch.setattr(target, engine)


@pytest.mark.parametrize("mode", ["hbm", "cache"])
def test_loaded_dataset_and_config_equal_the_reference(caches, mode,
                                                       monkeypatch,
                                                       budget_env):
    ref_dir, port_dir = caches
    argv = ["--num-node", str(NODES), "--mode", mode, "--train-frac", "0.02"]
    mod = load_reference("tools/papers100m_rehearsal.py", monkeypatch)
    ref, port = [], []
    capture_engine(monkeypatch, "fgnn_tpu.engine.OneChipEngine", ref)
    capture_engine(monkeypatch, "fgnn_tpu_torch.engine.OneChipEngine", port)
    monkeypatch.setattr("sys.argv", ["papers100m_rehearsal.py", *argv,
                                     "--cache-dir", ref_dir])
    with pytest.raises(Captured):
        mod.main()
    monkeypatch.delenv(BUDGET, raising=False)
    with pytest.raises(Captured):
        reh.main(argv + ["--cache-dir", port_dir, "--device", "cpu"])
    (jcfg, jds, jbudget), (tcfg, tds, tbudget) = ref[0], port[0]
    assert plain(tcfg) == plain(port_cfg(jcfg))
    assert tbudget == jbudget == (None if mode == "hbm" else "0")
    assert isinstance(tds.indices, np.memmap)
    assert_datasets_equal(jds, tds)
    assert len(tds.train_set) == int(NODES * 0.02)


@pytest.mark.parametrize("frac", [0.01, 0.0005])
def test_table1_loader_equals_the_reference(caches, frac, monkeypatch):
    ref_dir, port_dir = caches
    mod = load_reference("exp/table1/run_papers100m.py", monkeypatch)
    assert_datasets_equal(mod.load_p100m(ref_dir, NODES, frac),
                          t1p.load_p100m(port_dir, NODES, frac))


def test_table1_loader_names_the_generator(tmp_path):
    with pytest.raises(FileNotFoundError, match="--gen-only"):
        t1p.load_p100m(str(tmp_path), NODES, 0.01)


@pytest.mark.parametrize("mode", ["hbm", "cache"])
def test_modes_run_to_their_result_on_the_cpu(caches, mode, capsys,
                                              budget_env):
    assert reh.main(["--num-node", str(NODES), "--mode", mode,
                     "--num-epoch", "2", "--cache-dir", caches[1],
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[result] median steady epoch" in out
    if mode == "cache":
        rates = [float(ln.split("hit rate ")[1].split("%")[0])
                 for ln in out.splitlines() if "cache hit rate" in ln]
        assert len(rates) == 2 and all(0 < r <= 100 for r in rates)


@pytest.mark.parametrize("broken", [False, True])
@pytest.mark.parametrize("mode", ["hbm", "cache"])
def test_check_step_holds_the_path_gather(caches, mode, broken, monkeypatch):
    """``--check-step``'s check passes on each mode's gather as it is, and
    fails on a mock gather that leaves the padding rows unzeroed or a
    combine that drops the uploaded misses."""
    from fgnn_tpu_torch.cache.manager import FeatureCache
    from fgnn_tpu_torch.engine import OneChipEngine
    from fgnn_tpu_torch.ops.extract import mock_gather

    ds = reh.load_cached(os.path.join(caches[1], reh.stamp(NODES)), NODES,
                         0.01)
    # a table shorter than the graph, read modulo its rows
    ds = dataclasses.replace(ds, feat=ds.feat[:5000], empty_feat=True)
    eng = OneChipEngine(reh.engine_config(mode), ds, "cpu",
                        feat_budget=0 if mode == "cache" else None)
    if broken:
        if mode == "hbm":
            eng.feat_gather = lambda t, ids: mock_gather(t, ids.clamp(min=0))
        else:
            combine = FeatureCache.combine
            monkeypatch.setattr(FeatureCache, "combine",
                                lambda self, index, rows, miss:
                                combine(self, index, rows, 0))
        with pytest.raises(RuntimeError, match="differs from its plain"):
            reh.check_step(eng)
    else:
        what, err = reh.check_step(eng)
        assert err == 0.0
        assert what.startswith("mock gather over a [5000, 128]" if mode == "hbm"
                               else "cache combine over [3000, 128]")


def test_scale_runs_checks_and_records_the_rehearsal_on_the_cpu(tmp_path):
    from fgnn_tpu_torch.tools import scale_runs

    out = tmp_path / "out"
    assert scale_runs.main([
        "--steps", "p100m_gen", "p100m_hbm", "p100m_cache", "--num-node",
        str(NODES), "--device", "cpu", "--data-root", str(tmp_path / "data"),
        "--out-dir", str(out)]) == 0
    with open(out / "summary.json") as f:
        steps = json.load(f)["steps"]
    assert list(steps) == ["p100m_gen", "p100m_hbm", "p100m_cache"]
    assert all(r["rc"] == 0 and r["peak_rss_gib"] > 0 for r in steps.values())
    for name in ("p100m_hbm", "p100m_cache"):
        assert "bit-equal to its plain version" in steps[name]["check"]
        assert len(steps[name]["epochs"]) == 3
    assert all(0 < e["hit_rate"] <= 1 for e in steps["p100m_cache"]["epochs"])


# --- the Table-1 driver ------------------------------------------------------

def strip(argv, first):
    """``argv`` past its program part, without the options the port and
    the reference name differently."""
    out, skip = [], False
    for a in argv[first:]:
        if skip:
            skip = False
        elif a in ("--device", "--out-dir", "--out-prefix"):
            skip = True
        else:
            out.append(a)
    return out


def record_children(monkeypatch, calls):
    def run(argv, *a, **kw):
        calls.append((list(argv), a, kw))
        return subprocess.CompletedProcess(argv, 0)
    monkeypatch.setattr(subprocess, "run", run)


@pytest.mark.parametrize("extra", [
    [],
    ["--skip-stages", "--model", "gcn"],
    ["--model", "pinsage", "--rows", "hbm", "dev", "--num-epoch", "2",
     "--cache-percentage", "0.2", "--train-frac", "0.02"],
])
def test_children_equal_the_reference(extra, tmp_path, monkeypatch):
    mod = load_reference("exp/table1/run_papers100m.py", monkeypatch)
    ref, port = [], []
    record_children(monkeypatch, ref)
    monkeypatch.setattr("sys.argv", [
        "run_papers100m.py", "--cache-dir", str(tmp_path), "--out-prefix",
        str(tmp_path / "ref" / "t"), *extra])
    mod.main()
    record_children(monkeypatch, port)
    assert t1p.main(["--device", "cpu", "--cache-dir", str(tmp_path),
                     "--out-dir", str(tmp_path / "port"), *extra]) == 0
    assert len(port) == len(ref) > 1
    for (ra, rargs, rkw), (pa, pargs, pkw) in zip(ref, port):
        assert pa[:3] == [sys.executable, "-m",
                          "fgnn_tpu_torch.exp.table1_papers100m"]
        assert strip(pa, 3) == strip(ra, 2)
        assert (pargs, pkw) == (rargs, rkw)
        assert pa[pa.index("--device") + 1] == "cpu"


def test_a_failed_child_fails_the_driver(tmp_path, monkeypatch):
    monkeypatch.setattr(subprocess, "run",
                        lambda argv, *a, **k: subprocess.CompletedProcess(
                            argv, 3 if "stages" in argv else 0))
    assert t1p.main(["--device", "cpu", "--cache-dir", str(tmp_path),
                     "--out-dir", str(tmp_path / "o")]) == 1


class FakeEngine:
    """An engine that records its build and returns fixed epochs."""

    def __init__(self, seen, kind, fail_level2=None):
        self.seen, self.kind, self.fail = seen, kind, fail_level2

    def __call__(self, cfg, ds, *device):
        self.seen.append((self.kind, cfg, os.environ.get(BUDGET)))
        if self.fail is not None and cfg.profile_level == 2:
            raise self.fail
        return self

    def run_epoch(self, e):
        return {"epoch_time": 1.0 + e, "loss": 2.0, "sampled_edges": 10}


def patch_engines(monkeypatch, seen, prefix, fail_level2=None):
    # host_engine first: its class body reads engine.OneChipEngine
    monkeypatch.setattr(f"{prefix}.host_engine.HostSamplingEngine",
                        FakeEngine(seen, "arch0", fail_level2))
    monkeypatch.setattr(f"{prefix}.engine.OneChipEngine",
                        FakeEngine(seen, "arch1", fail_level2))


def row_args(model):
    return argparse.Namespace(
        model=model, fanout=[5, 10, 15] if model == "gcn" else [25, 10],
        batch_size=8000, cache_percentage=0.1, num_epoch=3,
        skip_stages=False, phase="both", device="cpu")


@pytest.mark.parametrize("model", ["graphsage", "gcn", "pinsage"])
def test_row_configs_equal_the_reference(model, monkeypatch, budget_env):
    mod = load_reference("exp/table1/run_papers100m.py", monkeypatch)
    ref, port = [], []
    patch_engines(monkeypatch, ref, "fgnn_tpu")
    patch_engines(monkeypatch, port, "fgnn_tpu_torch")
    for row in t1p.ROWS:
        r = mod.run_row(row, None, row_args(model))
        t = t1p.run_row(row, None, row_args(model))
        assert t == r
    assert len(port) == len(ref) == 2 * len(t1p.ROWS)
    for (rk, rc, rb), (tk, tc, tb) in zip(ref, port):
        assert (tk, tb) == (rk, rb)
        assert plain(tc) == plain(port_cfg(rc))


def test_stage_pass_keeps_the_headline_only_on_out_of_memory(monkeypatch,
                                                             budget_env):
    seen = []
    patch_engines(monkeypatch, seen, "fgnn_tpu_torch",
                  torch.cuda.OutOfMemoryError("no room"))
    out = t1p.run_row("hbm", None, row_args("graphsage"))
    assert out["epoch_time"] == 2.5 and "sample_time" not in out
    patch_engines(monkeypatch, seen, "fgnn_tpu_torch", ValueError("bug"))
    with pytest.raises(ValueError):
        t1p.run_row("hbm", None, row_args("graphsage"))


def test_prior_rows_merge_as_the_reference_merges(tmp_path, monkeypatch,
                                                  budget_env):
    """The same calls through both drivers, one row each: a row with equal
    parameters is merged, a stale one dropped; the tables' rows are the
    same."""
    mod = load_reference("exp/table1/run_papers100m.py", monkeypatch)
    patch_engines(monkeypatch, [], "fgnn_tpu")
    patch_engines(monkeypatch, [], "fgnn_tpu_torch")
    monkeypatch.setattr(mod, "load_p100m", lambda *a, **k: None)
    monkeypatch.setattr(t1p, "load_p100m", lambda *a, **k: None)
    monkeypatch.setattr("exp.common.runner.tunnel_meta", lambda: {})
    calls = [["--rows", "hbm"], ["--rows", "cache"],
             ["--rows", "hbm", "--batch-size", "4000"],
             ["--rows", "cache", "--model", "gcn"],
             ["--rows", "cache", "--cache-percentage", "0.2"],
             ["--rows", "dev", "--num-node", "5000"]]
    for argv in calls:
        monkeypatch.setattr("sys.argv", [
            "run_papers100m.py", "--out-prefix", str(tmp_path / "ref" / "t"),
            "--skip-stages", *argv])
        os.makedirs(tmp_path / "ref", exist_ok=True)
        mod.main()
        assert t1p.main(["--device", "cpu", "--out-dir",
                         str(tmp_path / "port"), "--skip-stages", *argv]) == 0
    with open(tmp_path / "ref" / "t.json") as f:
        ref = json.load(f)
    with open(tmp_path / "port" / "table1_papers100m.json") as f:
        port = json.load(f)
    assert port["results"] == ref["results"]
    assert [r["system"] for r in port["results"]] == [
        "dev-sample", "dev-sample+cache", "dev-sample+cache",
        "dev-sample+hbm-feat"]
    table = (tmp_path / "port" / "table1_papers100m.dat").read_text()
    head = [ln for ln in table.splitlines() if ln.startswith("#")]
    assert head[0].startswith("# card=") and "host_memory" in table
    assert head[-1] == f"# NOTE: {t1p.NOTE}"
    assert table.splitlines()[len(head)].split("\t") == t1p.COLUMNS


# --- uk-union ----------------------------------------------------------------

UK_SMALL = dict(num_node=5000, target_edges=100_000)


def test_ukunion_generate_equals_the_reference(tmp_path):
    ref, port = tmp_path / "ref", tmp_path / "port"
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('ref_uk', sys.argv[1])\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        f"m.NUM_NODE = {UK_SMALL['num_node']}\n"
        f"m.TARGET_EDGES = {UK_SMALL['target_edges']}\n"
        "m.generate(sys.argv[2])\n")
    r = subprocess.run(
        [sys.executable, "-O", "-c", code,
         os.path.join(REPO, "tools", "ukunion_rehearsal.py"), str(ref)],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    n = uk.generate(str(port), **UK_SMALL)
    assert sorted(os.listdir(ref)) == sorted(os.listdir(port)) == [
        "DONE", "indices.npy", "indptr.npy"]
    for f in os.listdir(ref):
        assert (ref / f).read_bytes() == (port / f).read_bytes(), f
    assert (port / "DONE").read_text() == f"{UK_SMALL['num_node']} {n}\n"
    assert np.load(port / "indptr.npy").dtype == np.int64
    assert uk.generate(str(port), **UK_SMALL) == n   # DONE: not again


def test_ukunion_cli_needs_more_than_2_31_edges(tmp_path, monkeypatch):
    monkeypatch.setattr(uk, "generate", lambda d: 2**31)
    with pytest.raises(ValueError, match="2\\^31"):
        uk.main(["--gen-only", "--dir", str(tmp_path)])


UK_CAPTURE = """
import dataclasses, enum, importlib.util, json, sys
import numpy as np
import fgnn_tpu.host_engine as he
spec = importlib.util.spec_from_file_location("ref_uk", sys.argv[1])
m = importlib.util.module_from_spec(spec)
spec.loader.exec_module(m)
m.NUM_NODE = int(sys.argv[3])
def capture(cfg, ds, *a, **k):
    fields = {f.name: getattr(ds, f.name) for f in dataclasses.fields(ds)}
    np.savez(sys.argv[4], **{k: v for k, v in fields.items()
                             if isinstance(v, np.ndarray)})
    plain = lambda v: v.value if isinstance(v, enum.Enum) else v
    with open(sys.argv[5], "w") as f:
        json.dump({"cfg": {f.name: plain(getattr(cfg, f.name))
                           for f in dataclasses.fields(cfg)},
                   "ds": {k: v for k, v in fields.items()
                          if not isinstance(v, np.ndarray)}}, f)
    raise SystemExit(0)
he.HostSamplingEngine = capture
m.run_epoch(sys.argv[2], 256, 512, 1)
"""


def test_ukunion_dataset_equals_the_reference(tmp_path, monkeypatch):
    """The reference's run_epoch (under ``-O``: its ``> 2**31`` assert
    stripped, the node count patched) and the port's build the same
    Dataset and RunConfig over the same files."""
    from fgnn_tpu_torch.config import RunConfig

    d = tmp_path / "ds"
    uk.generate(str(d), **UK_SMALL)
    arrays, meta = tmp_path / "ref.npz", tmp_path / "ref.json"
    r = subprocess.run(
        [sys.executable, "-O", "-c", UK_CAPTURE,
         os.path.join(REPO, "tools", "ukunion_rehearsal.py"), str(d),
         str(UK_SMALL["num_node"]), str(arrays), str(meta)],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr
    port = []
    capture_engine(monkeypatch,
                   "fgnn_tpu_torch.host_engine.HostSamplingEngine", port)
    with pytest.raises(Captured):
        uk.run_epoch(str(d), 256, 512, 1, "cpu",
                     num_node=UK_SMALL["num_node"])
    tcfg, tds, _ = port[0]
    with open(meta) as f:
        ref = json.load(f)
    assert plain(tcfg) == plain(RunConfig.from_dict(ref["cfg"]))
    assert isinstance(tds.indices, np.memmap)
    with np.load(arrays) as npz:
        for f in dataclasses.fields(tds):
            v = getattr(tds, f.name)
            if f.name in npz.files:
                assert v.dtype == npz[f.name].dtype, f.name
                np.testing.assert_array_equal(v, npz[f.name], err_msg=f.name)
            else:
                assert v == ref["ds"][f.name], f.name


def test_ukunion_runs_an_arch0_epoch_on_the_cpu(tmp_path, capsys):
    uk.generate(str(tmp_path), **UK_SMALL)
    out = uk.run_epoch(str(tmp_path), 256, 512, 1, "cpu",
                       num_node=UK_SMALL["num_node"], feat_rows=1000)
    assert len(out) == 1 and np.isfinite(out[0]["loss"])
    text = capsys.readouterr().out
    assert "test_result:epoch0_loss=" in text
    edges = int(np.load(tmp_path / "indptr.npy")[-1])
    assert f"test_result:num_edge={edges}" in text.splitlines()
