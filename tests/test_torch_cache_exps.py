"""The port's cache-policy experiments (fig10, fig11, fig5a/b, table2)
against the reference's ``exp/<name>/run.py`` at 3000 nodes.

Each reference script runs through its ``main`` on the CPU with ``HERE``
pointed at a temporary directory. The port's runner runs on the CPU with
the reference's own draws (``torch_parity.ReferenceDraws``): base 123 with
each runner's stride for the access pass (table2: base 7, stride 65537),
and the presample's ``fold_in(key(seed ^ 0x9E3779B9), epoch * num_step +
step)``. Hit rates and similarities are counts over the same batches, so
they must be exactly equal; init times are not compared."""
import importlib.util
import json
import os

import pytest
import torch

from fgnn_tpu_torch.exp import fig5, fig10, fig11, table2
from torch_parity import ReferenceDraws

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODES = ["--synthetic-nodes", "3000"]


def load_reference(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", os.path.join(REPO, "exp", name, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_reference(name, tmp_path, monkeypatch, argv, out):
    mod = load_reference(name)
    monkeypatch.setattr(mod, "HERE", str(tmp_path))
    monkeypatch.setattr("sys.argv", [f"{name}/run.py", *argv])
    mod.main()
    with open(tmp_path / out) as f:
        return json.load(f)


def reference_draws(eng, base, stride):
    """The reference's uniforms for the port engine's batches."""
    draws = ReferenceDraws(base, eng.cfg.sample_type, stride=stride)
    draws.bind(eng, True)
    return draws


def run_port(mod, tmp_path, argv):
    return mod.main(["--device", "cpu", "--out-dir", str(tmp_path / "port"),
                     *argv], draws=reference_draws)


def by_str_keys(results):
    return {pol: {str(k): v for k, v in row.items()}
            for pol, row in results.items()}


def test_fig10_hit_rates_equal_the_reference(tmp_path, monkeypatch):
    ref = run_reference("fig10", tmp_path, monkeypatch, NODES, "fig10.json")
    port = run_port(fig10, tmp_path, NODES)
    assert by_str_keys(port) == ref
    assert list(port) == ["random", "degree", "pre_sample", "optimal"]
    for pct, best in port["optimal"].items():
        assert all(port[p][pct] <= best for p in port)
    lines = (tmp_path / "port" / "fig10.dat").read_text().splitlines()
    assert lines[0].startswith("# card=")


def test_fig11_hit_rates_equal_the_reference(tmp_path, monkeypatch):
    ref = run_reference("fig11", tmp_path, monkeypatch, NODES, "fig11.json")
    port = run_port(fig11, tmp_path, NODES)
    assert [r["policy"] for r in port] == [r["policy"] for r in ref]
    assert [r["hit_rate"] for r in port] == [r["hit_rate"] for r in ref]
    assert all(r["init_time"] >= 0 for r in port)


@pytest.mark.parametrize("sample_type", ["khop2", "weighted_khop"])
def test_fig5_hit_rates_equal_the_reference(sample_type, tmp_path,
                                            monkeypatch):
    argv = NODES + ["--sample-type", sample_type]
    suffix = "b" if sample_type.startswith("weighted") else "a"
    ref = run_reference("fig5", tmp_path, monkeypatch, argv,
                        f"fig5{suffix}.json")
    port = run_port(fig5, tmp_path, argv)
    assert by_str_keys(port) == ref["hit_rate"]
    assert (tmp_path / "port" / f"fig5{suffix}.dat").exists()


def test_table2_similarities_equal_the_reference(tmp_path, monkeypatch):
    argv = NODES + ["--batch-size", "200"]
    ref = run_reference("table2", tmp_path, monkeypatch, argv, "table2.json")
    port = run_port(table2, tmp_path, argv)
    assert port == ref
    assert all(0.0 <= r["epoch_similarity"] <= 100.0 for r in port)
