"""The port's dataset converters (``fgnn_tpu_torch/data/datagen.py``)
against the reference's (``fgnn_tpu/data/datagen.py`` and the converters
of ``fgnn_tpu/data/download.py``).

Both convert the same raw input into their own directory, and every file
they write must be byte-equal: meta.txt, every .bin, the alias and prefix
tables and the four cache_by_*.bin rankings. Inputs: the vendored
ogbn-products fixture (OGB's raw csv.gz layout, 300 nodes), a papers100M
npz layout built from a seed, a decoded webgraph ``coo.bin`` under a
monkeypatched registry entry, and the ``ogb`` package faked as
tests/test_datagen_ogb.py fakes it; then the CLI's generators. Last, the
converted products fixture trains on the CPU through the port's engine."""
import os

import numpy as np
import pytest
import torch

from fgnn_tpu.data import datagen as ref_datagen
from fgnn_tpu.data import download as ref_download
from fgnn_tpu_torch.data import datagen
from test_datagen_ogb import fake_ogb  # noqa: F401  (a fixture)
from test_download_convert import _make_papers_raw

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "ogb_raw")


def assert_same_files(ref_dir, port_dir):
    """Every file of ``ref_dir`` byte-equal in ``port_dir``, and no other."""
    names = sorted(os.listdir(ref_dir))
    assert names == sorted(os.listdir(port_dir))
    for name in names:
        with open(os.path.join(ref_dir, name), "rb") as a, \
                open(os.path.join(port_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    return names


def test_products_fixture_converts_to_the_reference_bytes(tmp_path):
    ref = ref_datagen.convert_ogb("ogbn-products", FIXTURE,
                                  str(tmp_path / "ref"))
    port = datagen.convert_ogb("ogbn-products", FIXTURE,
                               str(tmp_path / "port"))
    assert os.path.basename(port) == "products"
    names = assert_same_files(ref, port)
    for f in ("meta.txt", "indptr.bin", "indices.bin", "feat.bin",
              "label.bin", "train_set.bin", "prob_table.bin",
              "alias_table.bin", "prob_prefix_table.bin",
              "cache_by_degree.bin", "cache_by_degree_hop.bin",
              "cache_by_heuristic.bin", "cache_by_random.bin"):
        assert f in names


def test_papers_npz_converts_to_the_reference_bytes(tmp_path):
    raw = tmp_path / "raw"
    _make_papers_raw(str(raw / "papers100M-bin"))
    ref = ref_datagen.convert_ogb("ogbn-papers100M", str(raw),
                                  str(tmp_path / "ref"))
    port = datagen.convert_ogb("ogbn-papers100M", str(raw),
                               str(tmp_path / "port"))
    assert_same_files(ref, port)
    # the reference's default symmetrizes the graph (ROADMAP queue C)
    with open(os.path.join(port, "meta.txt")) as f:
        assert "NUM_EDGE 144" in f.read()


def test_webgraph_converts_to_the_reference_bytes(tmp_path, monkeypatch):
    num_node, num_edge = 30, 90
    coo = np.random.default_rng(1).integers(0, num_node, size=(num_edge, 2),
                                            dtype=np.uint32)
    spec = {"base": "toy-2010", "num_node": num_node, "feat_dim": 8,
            "num_class": 3, "splits": (5, 3, 2)}
    monkeypatch.setitem(ref_download.REGISTRY, "toy-2010",
                        dict(spec, kind="webgraph", urls=[]))
    monkeypatch.setitem(datagen.REGISTRY, "toy-2010", spec)
    base = tmp_path / "raw" / "toy-2010"
    base.mkdir(parents=True)
    coo.tofile(str(base / "coo.bin"))
    ref = ref_download.convert_webgraph("toy-2010", str(tmp_path / "raw"),
                                        str(tmp_path / "ref"))
    port = datagen.convert_webgraph("toy-2010", str(tmp_path / "raw"),
                                    str(tmp_path / "port"))
    names = assert_same_files(ref, port)
    assert "feat.bin" not in names and "in_degrees.bin" in names


def test_fake_ogb_package_converts_to_the_reference_bytes(fake_ogb,
                                                          tmp_path):
    from fgnn_tpu_torch.data import load_dataset

    ref = ref_datagen.convert_ogb("ogbn-products", str(tmp_path / "raw"),
                                  str(tmp_path / "ref"))
    port = datagen.convert_ogb("ogbn-products", str(tmp_path / "raw"),
                               str(tmp_path / "port"))
    assert_same_files(ref, port)
    ds = load_dataset("products", root=str(tmp_path / "port"))
    assert ds.num_node == fake_ogb["n"] and ds.num_edge == 2 * fake_ogb["e"]
    assert int(np.asarray(ds.label).min()) == -1   # the NaN label
    assert ds.prob_table is not None and ds.alias_table is not None


def test_without_ogb_or_raw_files_the_converter_fails(monkeypatch, tmp_path):
    import builtins
    import sys

    real_import = builtins.__import__

    def no_ogb(name, *a, **k):
        if name.startswith("ogb"):
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_ogb)
    monkeypatch.delitem(sys.modules, "ogb", raising=False)
    with pytest.raises(OSError):
        datagen.convert_ogb("ogbn-products", str(tmp_path), str(tmp_path))


@pytest.mark.parametrize("command", ["synthetic", "rankings", "to64"])
def test_cli_writes_the_reference_bytes(command, tmp_path, monkeypatch):
    """``synthetic`` at 500 nodes; ``rankings`` and ``to64`` over a dataset
    that both CLIs' ``synthetic`` wrote."""
    name = "synthetic"
    for who, main in (("ref", ref_datagen.main), ("port", datagen.main)):
        root = str(tmp_path / who)
        if command != "synthetic":
            datagen.main(["synthetic", "--num-nodes", "500",
                          "--out-root", root])
            for f in os.listdir(os.path.join(root, name)):
                if f.startswith("cache_by") or "degrees" in f:
                    os.remove(os.path.join(root, name, f))
        argv = [command, "--name", name, "--num-nodes", "500",
                "--out-root", root]
        if who == "ref":
            monkeypatch.setattr("sys.argv", ["datagen", *argv])
            main()
        else:
            main(argv)
    names = assert_same_files(str(tmp_path / "ref" / name),
                              str(tmp_path / "port" / name))
    if command == "to64":
        assert "indices64.bin" in names
    else:
        assert "cache_by_random.bin" in names and "out_degrees.bin" in names


def test_converted_products_train_on_the_cpu(tmp_path):
    """The converted fixture through the port's loader and engine, as
    tests/test_ogb_convert_real.py trains it through the reference's: the
    loss falls over 8 epochs and the test accuracy beats chance."""
    from fgnn_tpu_torch.config import RunConfig, SampleType
    from fgnn_tpu_torch.data import load_dataset
    from fgnn_tpu_torch.engine import OneChipEngine

    datagen.convert_ogb("ogbn-products", FIXTURE, str(tmp_path))
    ds = load_dataset("products", root=str(tmp_path))
    assert ds.num_node == 300 and ds.num_edge == 2 * 1930
    assert ds.feat.shape == (300, 100) and 40 <= ds.num_class <= 47
    cfg = RunConfig(model="graphsage", fanout=(5, 5), batch_size=64,
                    num_hidden=64, sample_type=SampleType.KHOP0,
                    dropout=0.0, lr=0.01)
    eng = OneChipEngine(cfg, ds, "cpu")
    losses = [eng.run_epoch(e)["loss"] for e in range(8)]
    acc = eng.evaluate()
    assert losses[-1] < losses[0], losses
    assert acc > 1.5 / 47, acc
