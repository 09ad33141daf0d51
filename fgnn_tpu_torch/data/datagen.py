"""Dataset converters and data-process generators (the port's copy of
``fgnn_tpu/data/datagen.py`` and of the converters of
``fgnn_tpu/data/download.py``).

Turns raw graph layouts that are already on disk into the source system's
binary layout (meta.txt + .bin) that :mod:`.loader` maps:

  * OGB node-property datasets (ogbn-products, ogbn-papers100M): through
    the ``ogb`` package where it imports, else OGB's extracted csv.gz
    layout, else papers100M's ``raw/data.npz``;
  * decoded webgraph edge lists (twitter-2010, uk-2006-05: ``coo.bin``,
    interleaved uint32 src,dst pairs), topology only;

and writes the cache rankings (``cache_by_*.bin``), the degree files and
the 64-bit copies of the topology. NumPy only: nothing here touches torch.
For the same raw input every file it writes is byte for byte the
reference's.

    python -m fgnn_tpu_torch.data.datagen ogb --name ogbn-products \\
        --ogb-root RAW --out-root OUT
    python -m fgnn_tpu_torch.data.datagen {synthetic,rankings,to64,convert-webgraph} ...

Downloading is left out: it needs the network. Fetch the raw files by other
means, then convert them here.
"""
from __future__ import annotations

import gzip
import os
from typing import Optional, Tuple

import numpy as np

from .. import constants
from ..utils import get_logger
from .schema import Dataset
from .synthetic import build_alias_tables, write_dataset

log = get_logger(__name__)

#: webgraph name -> its raw directory and the sizes its meta advertises
#: (download.py's REGISTRY; twitter.sh:37-45, uk-2006-05.sh). An OGB
#: dataset needs no entry: :func:`read_ogb_raw` finds its directory.
REGISTRY = {
    "twitter": {
        "base": "twitter-2010",
        "num_node": 41_652_230,
        "feat_dim": 256,
        "num_class": 150,
        "splits": (416_500, 100_000, 200_000),
    },
    "uk-2006-05": {
        "base": "uk-2006-05",
        "num_node": 77_741_046,
        "feat_dim": 256,
        "num_class": 150,
        "splits": (1_000_000, 200_000, 100_000),
    },
}

#: split-directory name inside each OGB dataset (ogb master.csv ``split``)
OGB_SPLIT_DIR = {
    "ogbn-products": "sales_ranking",
    "ogbn-papers100M": "time",
    "ogbn-arxiv": "time",
}


def coo_to_csr(
    src: np.ndarray, dst: np.ndarray, num_node: int
) -> Tuple[np.ndarray, np.ndarray]:
    """COO -> CSR (coo_to_dataset.cc analog): edges grouped by src, in their
    input order within a row."""
    order = np.argsort(src, kind="stable")
    src_s, dst_s = src[order], dst[order]
    indptr = np.zeros(num_node + 1, dtype=np.int64)
    counts = np.bincount(src_s, minlength=num_node)
    np.cumsum(counts, out=indptr[1:])
    return indptr, dst_s.astype(np.int32)


def from_coo(
    name: str,
    src: np.ndarray,
    dst: np.ndarray,
    feat: np.ndarray,
    label: np.ndarray,
    train_set: np.ndarray,
    test_set: np.ndarray,
    valid_set: np.ndarray,
    num_class: Optional[int] = None,
) -> Dataset:
    num_node = feat.shape[0]
    indptr, indices = coo_to_csr(
        np.asarray(src, dtype=np.int64), np.asarray(dst, dtype=np.int64),
        num_node,
    )
    ds = Dataset(
        name=name,
        num_node=num_node,
        num_edge=len(indices),
        num_class=int(num_class if num_class is not None else label.max() + 1),
        indptr=indptr,
        indices=indices,
        feat=np.asarray(feat, dtype=np.float32),
        label=np.asarray(label, dtype=np.int32),
        train_set=np.asarray(train_set, dtype=np.int32),
        test_set=np.asarray(test_set, dtype=np.int32),
        valid_set=np.asarray(valid_set, dtype=np.int32),
    )
    ds.validate()
    return ds


def read_ogb_npz(base: str):
    """papers100M-bin's raw layout (datagen/papers100M.py:49-65):
    raw/data.npz {node_feat, edge_index}, raw/node-label.npz {node_label},
    split/time/{train,valid,test}.csv.gz. Returns the tuple of
    :func:`read_ogb_raw`."""
    raw = os.path.join(base, "raw")
    data = np.load(os.path.join(raw, "data.npz"))
    labels = np.load(os.path.join(raw, "node-label.npz"))
    feat = np.asarray(data["node_feat"], dtype=np.float32)
    edge_index = np.asarray(data["edge_index"], dtype=np.int64)
    label = np.asarray(labels["node_label"], dtype=np.float64).reshape(-1)

    def split_csv(k):
        with gzip.open(os.path.join(base, "split", "time", f"{k}.csv.gz"),
                       "rt") as f:
            return np.loadtxt(f, dtype=np.int64, ndmin=1)

    split = {k: split_csv(k) for k in ("train", "valid", "test")}
    return edge_index, feat, label, split


def read_ogb_raw(name: str, ogb_root: str):
    """Read OGB's extracted raw layout without the ``ogb`` package:

      <root>/<dir>/raw/edge.csv.gz            src,dst per line
      <root>/<dir>/raw/num-node-list.csv.gz
      <root>/<dir>/raw/node-feat.csv.gz       one row of floats per node
      <root>/<dir>/raw/node-label.csv.gz      one int per node
      <root>/<dir>/split/<split>/{train,valid,test}.csv.gz

    or, where ``raw/data.npz`` exists (papers100M), :func:`read_ogb_npz`.
    ``<dir>`` is the first of ``ogbn_products``, ``ogbn-products``,
    ``products-bin``, ``products`` that exists. Returns (edge_index [2, E],
    node_feat [N, D] f32, labels [N], split dict).
    """
    base = os.path.join(ogb_root, name.replace("-", "_"))
    for cand in (name, name.split("-", 1)[-1] + "-bin", name.split("-", 1)[-1]):
        if not os.path.isdir(base):
            base = os.path.join(ogb_root, cand)
    raw = os.path.join(base, "raw")
    if os.path.exists(os.path.join(raw, "data.npz")):
        return read_ogb_npz(base)

    def csv(path, dtype):
        return np.loadtxt(path, delimiter=",", dtype=dtype, ndmin=2)

    num_node = int(csv(os.path.join(raw, "num-node-list.csv.gz"),
                       np.int64)[0, 0])
    edges = csv(os.path.join(raw, "edge.csv.gz"), np.int64)
    feat = csv(os.path.join(raw, "node-feat.csv.gz"), np.float32)
    label = csv(os.path.join(raw, "node-label.csv.gz"), np.float64)
    if feat.shape[0] != num_node:
        raise ValueError(f"node-feat has {feat.shape[0]} rows for "
                         f"{num_node} nodes")
    split_dir = os.path.join(base, "split", OGB_SPLIT_DIR.get(name, "time"))
    split = {
        k: csv(os.path.join(split_dir, f"{k}.csv.gz"), np.int64).reshape(-1)
        for k in ("train", "valid", "test")
    }
    return edges.T, feat, label.reshape(-1), split


def convert_ogb(name: str, ogb_root: str, out_root: str,
                add_reverse: bool = True) -> str:
    """An OGB dataset -> the binary layout under ``out_root/<short name>``
    (datagen/products.py / papers100M.py); returns the directory.

    ``add_reverse`` (default True, as the reference) adds every edge's
    reverse. That symmetrizes papers100M, where the source paper keeps a
    directed CSC; the output is data, so the port keeps the reference's
    default and its files.
    """
    try:
        from ogb.nodeproppred import NodePropPredDataset

        data = NodePropPredDataset(name=name, root=ogb_root)
        split = data.get_idx_split()
        graph, labels = data[0]
        edge_index, node_feat = graph["edge_index"], graph["node_feat"]
        labels = labels.reshape(-1)
    except ImportError:
        log.info("ogb package unavailable; reading the raw layout")
        edge_index, node_feat, labels, split = read_ogb_raw(name, ogb_root)
    src, dst = edge_index
    if add_reverse:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    short = {"ogbn-products": "products",
             "ogbn-papers100M": "papers100M"}.get(name, name)
    ds = from_coo(
        short, src, dst, node_feat,
        np.nan_to_num(np.asarray(labels, np.float64),
                      nan=-1).astype(np.int64),
        split["train"], split["test"], split["valid"],
    )
    # the reference writes the dataset, the rankings, then the dataset again
    # with its alias tables; one write after the tables gives the same files
    build_alias_tables(ds)
    path = write_dataset(ds, out_root)
    write_cache_rankings(ds, path)
    return path


def convert_webgraph(name: str, raw_root: str, out_root: str,
                     seed: int = 0) -> str:
    """A decoded webgraph's ``coo.bin`` -> the binary layout; returns the
    directory.

    Topology only, as the reference (twitter.sh:34-45 + coo_to_dataset.cc):
    meta advertises FEAT_DIM and NUM_CLASS but no feat.bin is written (the
    loader's empty-feat mode fakes a table). The splits are disjoint
    uniform draws of the advertised sizes and the labels uniform. Edges are
    stored dst -> src (the CSC of the directed graph), so sampling walks
    in-neighbours (papers100M.py:68-71).
    """
    spec = REGISTRY[name]
    base = os.path.join(raw_root, spec["base"])
    coo = np.memmap(os.path.join(base, "coo.bin"), dtype=np.uint32,
                    mode="r").reshape(-1, 2)
    num_node = spec["num_node"]
    indptr, indices = coo_to_csr(
        coo[:, 1].astype(np.int64), coo[:, 0].astype(np.int64), num_node)

    n_train, n_valid, n_test = spec["splits"]
    rng = np.random.default_rng(seed)
    picks = rng.choice(num_node, size=n_train + n_valid + n_test,
                       replace=False).astype(np.uint32)
    label = rng.integers(0, spec["num_class"], size=num_node,
                         dtype=np.uint64)

    d = os.path.join(out_root, name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, constants.META_FILE), "w") as f:
        f.write(f"{constants.META_NUM_NODE} {num_node}\n")
        f.write(f"{constants.META_NUM_EDGE} {len(indices)}\n")
        f.write(f"{constants.META_FEAT_DIM} {spec['feat_dim']}\n")
        f.write(f"{constants.META_NUM_CLASS} {spec['num_class']}\n")
        f.write(f"{constants.META_NUM_TRAIN_SET} {n_train}\n")
        f.write(f"{constants.META_NUM_TEST_SET} {n_test}\n")
        f.write(f"{constants.META_NUM_VALID_SET} {n_valid}\n")
    indptr.astype(np.uint32).tofile(os.path.join(d, constants.INDPTR_FILE))
    indices.view(np.uint32).tofile(os.path.join(d, constants.INDICES_FILE))
    label.tofile(os.path.join(d, constants.LABEL_FILE))
    picks[:n_train].tofile(os.path.join(d, constants.TRAIN_SET_FILE))
    picks[n_train:n_train + n_valid].tofile(
        os.path.join(d, constants.VALID_SET_FILE))
    picks[n_train + n_valid:].tofile(os.path.join(d, constants.TEST_SET_FILE))

    from .loader import load_dataset

    ds = load_dataset(name, root=out_root, empty_feat=20)
    write_cache_rankings(ds, d)
    write_degrees(ds, d)
    if len(indices) >= (1 << 31):  # uk-union-scale consumers index in 64-bit
        write_64(ds, d)
    return d


def write_cache_rankings(ds: Dataset, path: str, seed: int = 0) -> None:
    """cache_by_{degree,degree_hop,heuristic,random}.bin
    (utility/data-process/toolkit/cache/*.cc analogs), uint32 node ids,
    hottest first."""
    from ..cache.policy import (
        rank_by_degree,
        rank_by_degree_hop,
        rank_by_heuristic,
        rank_random,
    )

    def w(fname, arr):
        np.ascontiguousarray(arr.view(np.uint32)).tofile(
            os.path.join(path, fname)
        )

    w(constants.CACHE_BY_DEGREE_FILE, rank_by_degree(ds))
    w(constants.CACHE_BY_DEGREE_HOP_FILE, rank_by_degree_hop(ds))
    w(constants.CACHE_BY_HEURISTIC_FILE, rank_by_heuristic(ds))
    w(constants.CACHE_BY_RANDOM_FILE, rank_random(ds, seed))


def write_64(ds: Dataset, path: str) -> None:
    """indptr64/indices64/{train,test,valid}_set64.bin: uint64 copies of the
    topology and the splits (toolkit/generator/32to64.cc analog)."""
    def w64(fname, arr):
        np.ascontiguousarray(
            np.asarray(arr).astype(np.uint64)
        ).tofile(os.path.join(path, fname))

    w64("indptr64.bin", ds.indptr)
    w64("indices64.bin", ds.indices)
    w64("train_set64.bin", ds.train_set)
    w64("test_set64.bin", ds.test_set)
    w64("valid_set64.bin", ds.valid_set)


def write_degrees(ds: Dataset, path: str) -> None:
    """in_degrees.bin / out_degrees.bin, uint32 (toolkit/degree analog)."""
    out_deg = np.diff(ds.indptr).astype(np.uint32)
    in_deg = np.bincount(
        np.asarray(ds.indices), minlength=ds.num_node
    ).astype(np.uint32)
    out_deg.tofile(os.path.join(path, constants.OUT_DEGREE_FILE))
    in_deg.tofile(os.path.join(path, constants.IN_DEGREE_FILE))


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser("fgnn_tpu_torch datagen")
    p.add_argument("command", choices=["ogb", "synthetic", "rankings",
                                       "to64", "convert-webgraph"])
    p.add_argument("--name", default="ogbn-products")
    p.add_argument("--ogb-root", default="/graph-learning/data-raw")
    p.add_argument("--out-root", default=constants.DEFAULT_DATASET_ROOT)
    p.add_argument("--num-nodes", type=int, default=1_000_000)
    args = p.parse_args(argv)
    if args.command == "ogb":
        print(convert_ogb(args.name, args.ogb_root, args.out_root))
    elif args.command == "convert-webgraph":
        print(convert_webgraph(args.name, args.ogb_root, args.out_root))
    elif args.command == "synthetic":
        from .synthetic import make_synthetic_dataset

        ds = make_synthetic_dataset(num_node=args.num_nodes, avg_degree=15,
                                    feat_dim=128, num_class=64)
        build_alias_tables(ds)
        path = write_dataset(ds, args.out_root)
        write_cache_rankings(ds, path)
        write_degrees(ds, path)
        print(path)
    else:
        from .loader import load_dataset

        ds = load_dataset(args.name, root=args.out_root)
        path = os.path.join(args.out_root, args.name)
        if args.command == "rankings":
            write_cache_rankings(ds, path)
            write_degrees(ds, path)
        else:
            write_64(ds, path)
        print(path)


if __name__ == "__main__":
    main()
