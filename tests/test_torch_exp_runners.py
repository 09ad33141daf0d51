"""The port's app-driven experiment runners against the reference's
``exp/<name>/run.py`` and ``exp/auto_runner.py``.

Each reference script runs here with its ``run_app`` recording the calls
(nothing runs), and the port's runner likewise: the rows, their order, app
arguments, environments, timeouts and row labels are the reference's; the
port adds only ``--device`` and ``--devices`` (and drops the TPU-calibrated
``pred_epoch_time``). fig16a builds its engines in process: its
configurations equal the reference's. fig4b, a simulation over fig4a's
table, equals the reference's on the same file. Then fig14 runs end to end
on the CPU at n = 2 on a 2000-node graph, and fig17b at 2000 nodes, and
each writes its table."""
import importlib.util
import json
import os

import pytest

from exp.common import runner as ref_runner
from fgnn_tpu_torch.exp import auto_runner, fig4a, fig4b, fig12, fig13
from fgnn_tpu_torch.exp import fig14, fig15, fig16a, fig17a, fig17b, table4
from fgnn_tpu_torch.exp import runner as port_runner
from fgnn_tpu_torch.exp import table5, table6
from torch_parity import port_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = {"fig13": fig13, "fig14": fig14, "fig15": fig15, "fig17a": fig17a,
        "table4": table4, "table5": table5, "fig4a": fig4a, "fig12": fig12,
        "table6": table6, "fig17b": fig17b}


def load_reference(name):
    path = (os.path.join(REPO, "exp", "auto_runner.py")
            if name == "auto_runner"
            else os.path.join(REPO, "exp", name, "run.py"))
    spec = importlib.util.spec_from_file_location(f"ref_{name}", path)
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


def record_reference(name, tmp_path, monkeypatch, argv=()):
    mod = load_reference(name)
    calls = []
    monkeypatch.setattr(mod, "run_app",
                        recorder(calls, ref_runner.RunResult, True))
    monkeypatch.setattr(mod, "HERE", str(tmp_path))
    if hasattr(mod, "annotate_prediction"):
        monkeypatch.setattr(mod, "annotate_prediction", lambda *a, **k: None)
    monkeypatch.setattr("sys.argv", [f"{name}/run.py", *argv])
    mod.main()
    return calls


def record_port(name, tmp_path, monkeypatch, argv=()):
    mod = auto_runner if name == "auto_runner" else PORT[name]
    calls = []
    monkeypatch.setattr(mod, "run_app",
                        recorder(calls, port_runner.RunResult, False))
    mod.main(["--device", "cpu", "--out-dir", str(tmp_path / "port"),
              *argv])
    return calls


def assert_same_rows(ref, port):
    assert len(port) == len(ref) > 0
    for (rt, ra, re_, rto, rr), (pt, pa, pe, pto, pr) in zip(ref, port):
        assert (pt, pa, pe, pto) == (rt, ra, re_, rto)
        assert pr.config == rr.config, pt


@pytest.mark.parametrize("name", sorted(PORT))
def test_rows_are_the_reference_rows(name, tmp_path, monkeypatch):
    ref = record_reference(name, tmp_path, monkeypatch)
    port = record_port(name, tmp_path, monkeypatch)
    assert_same_rows(ref, port)


@pytest.mark.parametrize("suite", sorted(auto_runner.SUITES))
def test_auto_runner_suites_are_the_reference_rows(suite, tmp_path,
                                                   monkeypatch):
    # the reference's write_table makes no directory (its run_app did)
    (tmp_path / "auto" / suite).mkdir(parents=True)
    ref = record_reference("auto_runner", tmp_path, monkeypatch, [suite])
    port = record_port("auto_runner", tmp_path, monkeypatch, [suite])
    assert_same_rows(ref, port)
    table = (tmp_path / "port" / f"{suite}.dat").read_text().splitlines()
    assert table[0].startswith("# card=")


def test_auto_runner_lists_its_suites(capsys):
    assert auto_runner.main(["--list"]) == 0
    names = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()]
    assert names == sorted(auto_runner.SUITES)


def test_fig4b_equals_the_reference_on_one_fig4a_table(tmp_path,
                                                       monkeypatch):
    """The reference's fig4b and the port's over the same fig4a rows: the
    reference's bare list, and the port's {"meta", "results"} file."""
    rows = [{"config": {"cache_percentage": pct, "num_node": 1_000_000},
             "values": {"cache_hit_rate": f"{hit:.4f}"}, "rc": 0}
            for pct, hit in ((0.0, 0.0), (0.05, 0.31), (0.1, 0.47),
                             (0.2, 0.66), (0.3, 0.78))]
    rows.append({"config": {"cache_percentage": 0.4}, "values": {}, "rc": 1})
    bare = tmp_path / "fig4a.json"
    bare.write_text(json.dumps(rows))
    ref = load_reference("fig4b")
    monkeypatch.setattr(ref, "FIG4A", str(bare))
    monkeypatch.setattr(ref, "HERE", str(tmp_path / "ref"))
    (tmp_path / "ref").mkdir()
    monkeypatch.setattr("sys.argv", ["fig4b/run.py"])
    ref.main()
    wrapped = tmp_path / "port_fig4a.json"
    wrapped.write_text(json.dumps({"meta": {"card": "x"}, "results": rows}))
    for i, src in enumerate((bare, wrapped)):
        out = tmp_path / f"port{i}"
        assert fig4b.main(["--fig4a", str(src), "--out-dir", str(out)]) == 0
        for f in ("fig4b.dat", "fig4b.json"):
            assert (out / f).read_text() == (tmp_path / "ref" / f).read_text()


def test_fig4b_without_hit_rates_fails(tmp_path):
    src = tmp_path / "fig4a.json"
    src.write_text(json.dumps([{"config": {}, "values": {}, "rc": 1}]))
    assert fig4b.main(["--fig4a", str(src), "--out-dir",
                       str(tmp_path)]) == 1


def role_device_calls(mod, argv, monkeypatch):
    calls = []
    monkeypatch.setattr(mod, "run_app",
                        lambda app_args, *a, **k: calls.append(app_args)
                        or port_runner.RunResult({}, {}, 0, ""))
    monkeypatch.setattr(mod, "write_lanes", lambda *a: 0, raising=False)
    mod.main(["--device", "cpu", *argv])
    return calls


def assert_role_devices(calls):
    """Every multi-device row names its role devices, as many as its
    workers, repeating the CPU here; the rows' arguments lead with
    --device."""
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


@pytest.mark.parametrize("name", sorted(PORT))
def test_rows_name_the_role_devices(name, tmp_path, monkeypatch):
    assert_role_devices(role_device_calls(
        PORT[name], ["--out-dir", str(tmp_path)], monkeypatch))


@pytest.mark.parametrize("suite", ["scalability", "arch_matrix"])
def test_auto_runner_rows_name_the_role_devices(suite, tmp_path,
                                                monkeypatch):
    calls = role_device_calls(auto_runner,
                              ["--out-dir", str(tmp_path), suite],
                              monkeypatch)
    assert sum("--devices" in c for c in calls) == (
        4 if suite == "scalability" else 2)
    assert_role_devices(calls)


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


def test_fig17b_runs_end_to_end_on_the_cpu(tmp_path):
    """fig17b at 2000 nodes, two epochs: GCN, GraphSAGE and PinSAGE through
    the port's app on the CPU, and the table is written."""
    rc = fig17b.main(["--device", "cpu", "--synthetic-nodes", "2000",
                      "--num-epoch", "2", "--out-dir", str(tmp_path)])
    assert rc == 0
    with open(tmp_path / "fig17b.json") as f:
        payload = json.load(f)
    rows = payload["results"]
    assert [r["config"]["model"] for r in rows] == ["gcn", "graphsage",
                                                    "pinsage"]
    for r in rows:
        assert r["rc"] == 0
        assert float(r["values"]["epoch_time"]) > 0
    lines = (tmp_path / "fig17b.dat").read_text().splitlines()
    assert lines[0].startswith("# card=")
    assert lines[-4].split("\t") == fig17b.COLUMNS
    assert [ln.split("\t")[0] for ln in lines[-3:]] == ["gcn", "graphsage",
                                                        "pinsage"]


def test_fig12_table_carries_the_host_gather(tmp_path, monkeypatch):
    """fig12's table, through the recorder: the reference's columns with
    ``extract_time`` (the misses' host gather, which the port files apart
    from the upload) and a header line saying that copy_time +
    extract_time is the reference's copy_time."""
    def run_app(app_args, log_dir, tag, env=None, **_):
        return port_runner.RunResult(
            config={}, values={"epoch_time": "1.0", "copy_time": "0.05",
                               "extract_time": "0.4", "train_time": "0.3",
                               "cache_hit_rate": "0.44"},
            returncode=0, log_path="")
    monkeypatch.setattr(fig12, "run_app", run_app)
    assert fig12.main(["--device", "cpu", "--out-dir", str(tmp_path)]) == 0
    lines = (tmp_path / "fig12.dat").read_text().splitlines()
    head = [ln for ln in lines if ln.startswith("#")]
    assert f"# note={fig12.NOTE}" in head
    assert "copy_time + extract_time is the reference's copy_time" in (
        fig12.NOTE)
    cols = lines[len(head)].split("\t")
    assert cols == fig12.COLUMNS
    assert cols.index("extract_time") == cols.index("copy_time") + 1
    rows = [dict(zip(cols, ln.split("\t"))) for ln in lines[len(head) + 1:]]
    assert len(rows) == 6
    assert {(r["copy_time"], r["extract_time"]) for r in rows} == {
        ("0.05", "0.4")}
    with open(tmp_path / "fig12.json") as f:
        assert json.load(f)["meta"]["note"] == fig12.NOTE


RUNNERS = ["table1", "table2", "table4", "table5", "table6", "fig4a", "fig5",
           "fig10", "fig11", "fig12", "fig13", "fig14", "fig15", "fig16a",
           "fig17a", "fig17b"]
MAKEFILE_DIR = os.path.join(REPO, "fgnn_tpu_torch", "exp")


def make_n(*targets):
    import subprocess

    r = subprocess.run(["make", "-n", "-s", "-C", MAKEFILE_DIR, *targets],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    return [ln for ln in r.stdout.splitlines() if ln.strip()]


def test_makefile_names_every_runner():
    """``make -n all``: one command a target, each from the repository root
    through ``python3 -m`` on a module that exists, on the default device
    (fig4b, a simulation, takes none); the reference's 16 experiments, fig4b
    and the papers100M Table 1."""
    lines = make_n("all")
    mods = []
    for ln in lines:
        assert ln.startswith(f"cd {REPO} && python3 -m fgnn_tpu_torch.exp."), ln
        mod = ln.split(" -m ")[1].split()[0]
        assert importlib.util.find_spec(mod) is not None, mod
        name = mod.rsplit(".", 1)[1]
        assert ln.endswith(" --device cuda") == (name != "fig4b"), ln
        mods.append(name)
    assert mods == RUNNERS + ["fig4b", "table1_papers100m"]
    with open(os.path.join(REPO, "exp", "Makefile")) as f:
        ref = f.read().split("EXPS =")[1].split("\nRUNS")[0]
    assert ref.replace("\\", " ").split() == RUNNERS


def test_makefile_device_and_clean():
    assert make_n("fig10.run", "DEVICE=cuda:1") == [
        f"cd {REPO} && python3 -m fgnn_tpu_torch.exp.fig10 --device cuda:1"]
    (clean,) = make_n("clean")
    prefix = f"cd {REPO} && rm -rf "
    assert clean.startswith(prefix)
    assert clean[len(prefix):].split() == [
        f"chiprun_out/{n}" for n in RUNNERS + ["fig4b", "table1_papers100m"]]
