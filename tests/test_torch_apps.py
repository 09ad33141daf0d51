"""The port's apps and experiment runner (``fgnn_tpu_torch/examples``,
``fgnn_tpu_torch/exp``): ``train_gnn --device cpu`` as a subprocess against
the reference app on the same arguments and environment (its ``config:``
and ``test_result:`` keys a superset of the reference's; the same
node-access and trace artifacts); in this process, the multi-device archs
exiting non-zero on too few devices, the default device refusing a machine without a card, the
per-model wrappers and the arch7 app; and the runner's parsing and tables
against the reference runner's."""
import argparse
import json
import os
import runpy
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import fgnn_tpu_torch.session as sam
from exp.common import runner as jrunner
from fgnn_tpu_torch.examples import train_arch7, train_gnn
from fgnn_tpu_torch.exp import runner as trunner
from fgnn_tpu_torch.exp import table1

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a host-resident table through a presample cache at profile level 2, with
# node access and the trace: every key family the app prints
ARGS = ["--arch", "arch1", "--model", "graphsage", "--fanout", "5", "5",
        "--batch-size", "256", "--num-hidden", "16", "--synthetic-nodes",
        "3000", "--num-epoch", "2", "--cache-percentage", "0.2",
        "--profile-level", "2"]
ENV = {"FGNN_TPU_FEAT_HBM_BUDGET": "0", "FGNN_TPU_LOG_NODE_ACCESS": "1",
       "FGNN_TPU_DUMP_TRACE": "1"}


def app_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("FGNN_TPU_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def run(cmd, cwd, **env):
    return subprocess.run([sys.executable, *cmd], cwd=cwd, env=app_env(**env),
                          capture_output=True, text=True, timeout=600)


def in_process(main, args, capsys):
    """An app's ``main(args)`` in this process (the other tests run the app
    as ``python -m``): its exit code, stdout and stderr."""
    code = main(list(args))
    out = capsys.readouterr()
    return code, out.out, out.err


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference app and the port's on ARGS and ENV, each a process in
    a directory of its own (they write node_* files and trace.json there),
    both at once."""
    ref_dir = tmp_path_factory.mktemp("reference")
    port_dir = tmp_path_factory.mktemp("port")
    with ThreadPoolExecutor(max_workers=2) as pool:
        ref = pool.submit(run, [os.path.join(REPO, "examples", "train_gnn.py"),
                                *ARGS], ref_dir, JAX_PLATFORMS="cpu", **ENV)
        port = pool.submit(trunner.run_app, ["--device", "cpu", *ARGS],
                           str(port_dir), "app", env=ENV, timeout=600)
        ref, port = ref.result(), port.result()
    assert ref.returncode == 0, ref.stderr[-3000:]
    assert port.returncode == 0, open(port.log_path).read()[-3000:]
    return ref_dir, jrunner.parse_log(ref.stdout), port_dir, port


def test_app_keys_are_a_superset_of_the_reference(runs):
    _, ref, _, port = runs
    ref_results = {k for k in ref if not k.startswith("config:")}
    ref_config = {k[7:] for k in ref if k.startswith("config:")}
    assert ref_results <= set(port.values), ref_results - set(port.values)
    assert ref_config <= set(port.config), ref_config - set(port.config)
    for key in ("cache_hit_rate", "miss_mb", "L2_cache_get_index_time",
                "L2_shuffle_time", "init:presample", "init:build_cache"):
        assert key in port.values, key
    assert port.config["arch"] == "1" and port.config["profile_level"] == "2"
    hit = float(port.values["cache_hit_rate"])
    assert 0.0 < hit < 1.0 and float(port.values["epoch_time"]) > 0.0
    assert float(port.values["sample_time"]) > 0.0


def test_app_writes_the_reference_artifacts(runs):
    ref_dir, _, port_dir, port = runs
    with open(port.log_path) as f:
        text = f.read()
    assert text.count("| Loss ") == 2 and "Epoch 00001 | Time" in text
    for d in (ref_dir, port_dir):
        assert os.path.getsize(d / "node_ranking.bin") > 0
    ref_access = json.loads((ref_dir / "node_access.json").read_text())
    port_access = json.loads((port_dir / "node_access.json").read_text())
    assert set(port_access) == set(ref_access)
    assert 0 < port_access["num_touched"] <= 3000
    ref_trace = json.loads((ref_dir / "trace.json").read_text())
    port_trace = json.loads((port_dir / "trace.json").read_text())
    meta = lambda t: [e["args"]["name"] for e in t["traceEvents"]
                      if e["ph"] == "M"]
    assert meta(port_trace)[:19] == meta(ref_trace)[:19]
    lanes = {e["name"] for e in port_trace["traceEvents"] if e["ph"] == "X"}
    assert {"kL0Event_Train_Step", "kL1Event_Sample",
            "kL3Event_Copy_CacheCopy_ExtractMiss"} <= lanes


@pytest.mark.parametrize("arch", ["arch5", "arch6"])
def test_multi_device_arch_exits_non_zero_naming_a16(arch, capsys):
    """The multi-device archs (ROADMAP A16, ported since) exit non-zero on
    fewer role devices than they need, naming both counts, before loading
    anything: they never drop to fewer roles."""
    code, out, err = in_process(train_gnn.main, [
        "--device", "cpu", "--arch", arch, "--num-train-worker", "2",
        "--devices", "cpu", "--synthetic-nodes", "1000"], capsys)
    need = 3 if arch == "arch5" else 2
    assert code != 0
    assert f"{arch} needs {need} devices and 1 were given" in err
    assert "test_result:" not in out


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks a machine without a card")
def test_app_defaults_to_the_card(capsys):
    """Without --device the app asks for the card, and on a machine with
    none it stops; it never falls back to the CPU."""
    for main, args in ((train_gnn.main, ["--arch", "arch1"]),
                       (train_arch7.main, [])):
        code, out, err = in_process(main, args + ["--synthetic-nodes", "1000"],
                                    capsys)
        assert code == 1 and "--device cpu" in err
        assert "test_result:" not in out


@pytest.mark.parametrize("model", ["graphsage", "gcn", "pinsage", "gat"])
def test_per_model_wrappers(model, monkeypatch, capsys):
    """``python -m fgnn_tpu_torch.examples.train_<model>``, run here."""
    name = f"fgnn_tpu_torch.examples.train_{model}"
    monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setattr(sys, "argv", [name, "--device", "cpu",
                                      "--validate-configs"])
    with pytest.raises(SystemExit) as done:
        runpy.run_module(name, run_name="__main__")
    assert done.value.code == 0
    out = trunner.parse_log(capsys.readouterr().out)
    assert out["config:model"] == model
    sample = {"gcn": "khop2", "graphsage": "khop0", "pinsage": "random_walk",
              "gat": "khop2"}[model]
    assert out["config:sample_type"] == sample


def test_arch7_app_samples_through_the_session(capsys):
    sam._reset_for_tests()
    code, out, _ = in_process(train_arch7.main, [
        "--device", "cpu", "--synthetic-nodes", "3000", "--batch-size", "256",
        "--num-epoch", "2", "--fanout", "5", "5"], capsys)
    assert code == 0
    losses = [float(line.rsplit("Loss ", 1)[1])
              for line in out.splitlines() if "| Loss " in line]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert float(trunner.parse_log(out)["epoch_time"]) > 0.0


REFERENCE_TEXTS = [
    "config:model=gcn\nnoise\ntest_result:epoch_time=0.42\n",
    """
config:model=graphsage
config:arch=arch5
Epoch 00001 | Time 1.0
test_result:epoch_time=1.2345
test_result:cache_hit_rate=0.98
noise line
""",
]


@pytest.mark.parametrize("text", REFERENCE_TEXTS)
def test_parse_log_equals_the_reference(text):
    assert trunner.parse_log(text) == jrunner.parse_log(text)


def test_tables_equal_the_reference(tmp_path):
    results = [
        trunner.RunResult({"system": "a", "model": "gcn"},
                          {"epoch_time": "0.5", "sample_time": "0.1"}, 0,
                          "a.log"),
        trunner.RunResult({"system": "b"}, {"epoch_time": "0.7"}, 1,
                          "b.log"),
    ]
    meta = trunner.card_meta()
    assert set(meta) == {"card", "host_cpu", "host_cores", "host_memory"}
    assert int(meta["host_cores"]) >= 1
    assert float(meta["host_memory"].split()[0]) > 0
    cols = ["system", "sample_time", "epoch_time", "model"]
    for mod, name in ((trunner, "port"), (jrunner, "ref")):
        mod.write_table(results, cols, str(tmp_path / f"{name}.dat"),
                        meta=meta)
        mod.write_json(results, str(tmp_path / f"{name}.json"), meta=meta)
    for suffix in (".dat", ".json"):
        assert ((tmp_path / f"port{suffix}").read_bytes()
                == (tmp_path / f"ref{suffix}").read_bytes())
    assert "b\tX\t0.7\tX" in (tmp_path / "port.dat").read_text()


def test_table1_rows_are_the_reference_rows():
    """The five rows, their arguments and environments, as the reference's
    exp/table1/run.py builds them; the port adds only --device."""
    ns = argparse.Namespace(device="cpu", model="graphsage",
                            dataset="synthetic", synthetic_nodes=200_000,
                            num_epoch=4, batch_size=8000,
                            cache_percentage=0.2)
    rows = table1.rows(ns)
    assert [t for t, _, _ in rows] == [
        "host-sample", "host-sample+cache", "dev-sample", "dev-sample+cache",
        "dev-sample+hbm-feat"]
    host_feat = {"FGNN_TPU_FEAT_HBM_BUDGET": "0"}
    assert [env for _, _, env in rows] == [{}, {}, host_feat, host_feat, {}]
    for tag, argv, _ in rows:
        assert argv[:2] == ["--device", "cpu"]
        assert argv[argv.index("--fanout") + 1:][:3] == ["5", "10", "15"]
        assert ("--cache-percentage" in argv) == tag.endswith("+cache")
        arch = argv[argv.index("--arch") + 1]
        assert arch == ("arch0" if tag.startswith("host") else "arch1")


@pytest.mark.parametrize("text, expected", [
    ("processor\t: 0\nvendor_id\t: GenuineIntel\ncpu family\t: 6\n"
     "model\t\t: 143\nmodel name\t: Intel(R) Xeon(R) Platinum 8480+\n\n"
     "processor\t: 1\nmodel name\t: other\n",
     "Intel(R) Xeon(R) Platinum 8480+"),
    ("processor\t: 0\nvendor_id\t: GenuineIntel\ncpu family\t: 6\n"
     "model\t\t: 207\nmodel name\t: unknown\n",
     "unknown (GenuineIntel family 6 model 207)"),
])
def test_host_cpu_reads_cpuinfo(text, expected, tmp_path, monkeypatch):
    """The table header's CPU model: cpuinfo's model name, or where a
    container calls it unknown (and lscpu does too), the vendor, family
    and model numbers."""
    path = tmp_path / "cpuinfo"
    path.write_text(text)
    monkeypatch.setenv("PATH", str(tmp_path))   # no lscpu
    assert trunner.host_cpu(str(path)) == expected
