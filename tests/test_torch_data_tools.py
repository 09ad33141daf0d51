"""The port's data tools against the reference's ``tools/``:
``degree_info`` and ``dataset_info`` give the reference's artifacts and
report on a 2000-node graph, generated and loaded from disk;
``bandwidth_bench --device cpu`` prints its host lines, and without a card
its device paths fail instead of falling back."""
import importlib.util
import os

import numpy as np
import pytest

from fgnn_tpu_torch.data import make_synthetic_dataset, write_dataset
from fgnn_tpu_torch.tools import bandwidth_bench, dataset_info, degree_info

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_reference(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A 2000-node graph written in the binary layout: its root."""
    root = tmp_path_factory.mktemp("datasets")
    write_dataset(make_synthetic_dataset(num_node=2000, avg_degree=8,
                                         feat_dim=16, num_class=4, seed=3,
                                         name="g2000"), str(root))
    return str(root)


def reports(name, port_main, argv, monkeypatch, capsys):
    """(reference's stdout, port's stdout) of one tool on ``argv``."""
    ref = load_reference(name)
    monkeypatch.setattr("sys.argv", [f"{name}.py", *argv["ref"]])
    ref.main()
    ref_out = capsys.readouterr().out
    port_main(argv["port"])
    return ref_out, capsys.readouterr().out


@pytest.mark.parametrize("source", ["synthetic", "saved"])
def test_degree_info_matches_the_reference(source, saved, tmp_path,
                                           monkeypatch, capsys):
    head = (["synthetic", "--num-nodes", "2000"] if source == "synthetic"
            else ["g2000", "--root", saved])
    argv = {who: head + ["--out", str(tmp_path / who)]
            for who in ("ref", "port")}
    ref_out, port_out = reports("degree_info", degree_info.main, argv,
                                monkeypatch, capsys)
    assert port_out == ref_out.replace(str(tmp_path / "ref"),
                                       str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 5
    for f in names:
        assert (tmp_path / "ref" / f).read_bytes() == \
            (tmp_path / "port" / f).read_bytes(), f


@pytest.mark.parametrize("source", ["synthetic", "saved"])
def test_dataset_info_matches_the_reference(source, saved, monkeypatch,
                                            capsys):
    head = (["synthetic", "--num-nodes", "2000"] if source == "synthetic"
            else ["g2000", "--root", saved, "--fanout", "5", "10", "15",
                  "--batch-size", "256"])
    argv = {who: head + ["--property"] for who in ("ref", "port")}
    ref_out, port_out = reports("dataset_info", dataset_info.main, argv,
                                monkeypatch, capsys)
    assert port_out == ref_out
    assert "csr_check=OK" in port_out and "is_undirected=" in port_out


def test_graph_properties_of_a_small_multigraph():
    # 0->1 twice, 1->0 once, a self-loop on 2, node 3 without edges
    indptr = np.array([0, 2, 3, 4, 4])
    indices = np.array([1, 1, 0, 2])
    props = dataset_info.graph_properties(indptr, indices, 4)
    assert props == {"self_loops": 1, "zero_degree_nodes": 1,
                     "indices_sorted": True, "duplicate_edges": 1,
                     "reverse_edges": 3, "is_undirected": False}


def test_bandwidth_bench_host_lines_on_the_cpu(capsys):
    res = bandwidth_bench.main(["--device", "cpu", "--rows", "5000",
                                "--gather", "1000", "--dim", "32"])
    out = capsys.readouterr().out
    for line in ("host gather (numpy):", "host gather (host_gather):",
                 "host memcpy:"):
        assert line in out
    assert set(res) == {"host"}
    assert all(r["s"] > 0 and r["GB/s"] > 0 for r in res["host"].values())


def test_bandwidth_bench_device_paths_need_a_card(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bandwidth_bench.main(["--rows", "500", "--gather", "100"])
