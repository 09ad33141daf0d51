"""The port's arch5/arch6 experiment runners against the reference's
``exp/<name>/run.py``.

Each reference script runs here with its ``run_app`` recording the calls
(nothing runs), and the port's runner likewise: the rows, their order, app
arguments, environments, timeouts and row labels are the reference's; the
port adds only ``--device`` and ``--devices`` (and drops the TPU-calibrated
``pred_epoch_time``). fig16a builds its engines in process: its
configurations equal the reference's. Then fig14 runs end to end on the CPU
at n = 2 on a 2000-node graph and writes its table."""
import importlib.util
import json
import os

import pytest

from exp.common import runner as ref_runner
from fgnn_tpu_torch.exp import fig13, fig14, fig15, fig16a, fig17a, table4
from fgnn_tpu_torch.exp import runner as port_runner
from fgnn_tpu_torch.exp import table5
from torch_parity import port_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = {"fig13": fig13, "fig14": fig14, "fig15": fig15, "fig17a": fig17a,
        "table4": table4, "table5": table5}


def load_reference(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", os.path.join(REPO, "exp", name, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def strip_devices(args):
    out, skip = [], False
    for a in args:
        if skip:
            skip = False
        elif a in ("--device", "--devices"):
            skip = True
        else:
            out.append(a)
    return out


def recorder(calls, result_cls, script):
    """A ``run_app`` that records (tag, app arguments, environment, timeout)
    and returns a result whose labels the runner then sets; a traced run
    gets an empty trace."""
    def run_app(app_args, log_dir, tag, env=None, timeout=1800, **_):
        args = list(app_args)
        if script:
            assert args[0] == "examples/train_gnn.py"
            args = args[1:]
        env = dict(env or {})
        if "FGNN_TPU_TRACE_PATH" in env:
            with open(env["FGNN_TPU_TRACE_PATH"], "w") as f:
                json.dump({"traceEvents": []}, f)
            env["FGNN_TPU_TRACE_PATH"] = os.path.basename(
                env["FGNN_TPU_TRACE_PATH"])
        r = result_cls(config={}, values={"epoch_time": "1.0"},
                       returncode=0, log_path="")
        calls.append((tag, strip_devices(args), env, timeout, r))
        return r
    return run_app


def record_reference(name, tmp_path, monkeypatch):
    mod = load_reference(name)
    calls = []
    monkeypatch.setattr(mod, "run_app",
                        recorder(calls, ref_runner.RunResult, True))
    monkeypatch.setattr(mod, "HERE", str(tmp_path))
    if hasattr(mod, "annotate_prediction"):
        monkeypatch.setattr(mod, "annotate_prediction", lambda *a, **k: None)
    monkeypatch.setattr("sys.argv", [f"{name}/run.py"])
    mod.main()
    return calls


def record_port(name, tmp_path, monkeypatch, argv=()):
    mod = PORT[name]
    calls = []
    monkeypatch.setattr(mod, "run_app",
                        recorder(calls, port_runner.RunResult, False))
    mod.main(["--device", "cpu", "--out-dir", str(tmp_path / "port"),
              *argv])
    return calls


@pytest.mark.parametrize("name", sorted(PORT))
def test_rows_are_the_reference_rows(name, tmp_path, monkeypatch):
    ref = record_reference(name, tmp_path, monkeypatch)
    port = record_port(name, tmp_path, monkeypatch)
    assert len(port) == len(ref) > 0
    for (rt, ra, re_, rto, rr), (pt, pa, pe, pto, pr) in zip(ref, port):
        assert (pt, pa, pe, pto) == (rt, ra, re_, rto)
        assert pr.config == rr.config, pt


@pytest.mark.parametrize("name", sorted(PORT))
def test_rows_name_the_role_devices(name, tmp_path, monkeypatch):
    """Every multi-device row names its role devices, as many as its
    workers, repeating the CPU here; the rows' arguments lead with
    --device."""
    calls = []
    monkeypatch.setattr(PORT[name], "run_app",
                        lambda app_args, *a, **k: calls.append(app_args)
                        or port_runner.RunResult({}, {}, 0, ""))
    monkeypatch.setattr(PORT[name], "write_lanes", lambda *a: 0,
                        raising=False)
    PORT[name].main(["--device", "cpu", "--out-dir", str(tmp_path)])
    for app_args in calls:
        assert app_args[:2] == ["--device", "cpu"]
        if "--devices" not in app_args:
            assert "arch5" not in app_args and "arch6" not in app_args
            continue
        devs = app_args[app_args.index("--devices") + 1].split(",")
        assert set(devs) == {"cpu"}
        if "arch6" in app_args:
            n = int(app_args[app_args.index("--num-train-worker") + 1])
        else:
            n = sum(int(app_args[app_args.index(k) + 1]) for k in
                    ("--num-sample-worker", "--num-train-worker"))
        assert len(devs) == n


def test_fig16a_configs_are_the_reference_configs(monkeypatch):
    """The reference's build_engine with its engines stubbed out: each
    mode's configuration, and its engine on the reference's 8-device mesh
    (one device for arch1)."""
    import fgnn_tpu.engine
    import fgnn_tpu.parallel.async_dp
    import fgnn_tpu.parallel.factored

    built = []

    class Stub:
        def __init__(self, cfg, ds, *a, **k):
            built.append(cfg)

    for mod, name in ((fgnn_tpu.engine, "OneChipEngine"),
                      (fgnn_tpu.parallel.factored, "FactoredEngine"),
                      (fgnn_tpu.parallel.factored, "SGNNEngine"),
                      (fgnn_tpu.parallel.async_dp, "AsyncFactoredEngine")):
        monkeypatch.setattr(mod, name, Stub)
    ref = load_reference("fig16a")
    args = type("A", (), {"archs": ["arch1", "arch5", "arch6",
                                    "arch5_async"], "max_epoch": 40})
    rows = fig16a.rows(args)
    assert [a for a, _, _ in rows] == args.archs
    for arch, cfg, n in rows:
        ref.build_engine(arch, None, args.max_epoch)
        assert cfg == port_cfg(built[-1]), arch
        assert n == (1 if arch == "arch1" else 8)


def test_worker_devices_repeat_cards():
    wd = port_runner.worker_devices
    assert wd("cpu", None, 3) == "cpu,cpu,cpu"
    assert wd("cuda", "cuda:0,cuda:1", 5) == \
        "cuda:0,cuda:1,cuda:0,cuda:1,cuda:0"
    assert wd("cuda", "cuda:2", 2) == "cuda:2,cuda:2"


def test_fig14_runs_end_to_end_on_the_cpu(tmp_path):
    """fig14 at n = 2 on a 2000-node graph: both rows (arch5 1S+1T and
    arch6 W=2) run the port's app on the CPU and the table is written."""
    rc = fig14.main(["--device", "cpu", "--worker-counts", "2",
                     "--synthetic-nodes", "2000", "--num-epoch", "2",
                     "--out-dir", str(tmp_path)])
    assert rc == 0
    with open(tmp_path / "fig14.json") as f:
        payload = json.load(f)
    assert payload["meta"]["host_cores"]
    rows = payload["results"]
    assert [r["config"]["system"] for r in rows] == ["fgnn", "sgnn"]
    for r in rows:
        assert r["rc"] == 0
        assert float(r["values"]["epoch_time"]) > 0
        assert r["values"]["devices"] == "cpu,cpu"
    lines = (tmp_path / "fig14.dat").read_text().splitlines()
    assert lines[0].startswith("# card=")
    assert lines[-3].split("\t") == fig14.COLUMNS
    assert [ln.split("\t")[:2] for ln in lines[-2:]] == [["fgnn", "2"],
                                                        ["sgnn", "2"]]
