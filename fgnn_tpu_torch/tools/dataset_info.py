"""Dataset inspection and validation (port of ``tools/dataset_info.py``;
the source system's utility/data-process toolkit/{property, degree,
train_graph_size}): a CSR validity check, the graph-property report
(directedness, self-loops, duplicate edges, zero-degree nodes, sorted
indices; graph_property.cc:25-168, csr_checker.cc:26-78), degree
statistics and the per-hop sampled-subgraph caps.

    python -m fgnn_tpu_torch.tools.dataset_info <name> [--root PATH] [--fanout 25 10]
    python -m fgnn_tpu_torch.tools.dataset_info synthetic --num-nodes 100000
    python -m fgnn_tpu_torch.tools.dataset_info <name> --property   # O(E log E)

NumPy only, on the host; the caps come from the port's
``ops/reference_impl.py::calibrate_caps``. For the same dataset the report
is the reference's.
"""
import argparse

import numpy as np


def graph_properties(indptr, indices, num_node):
    """The graph-property report, one sorted-array pass a check: edges are
    encoded as src * N + dst int64 codes, duplicates are adjacent equal
    codes after sorting, and reverse edges are probes of the flipped codes
    by searchsorted."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices)
    num_edge = int(indices.shape[0])
    deg = np.diff(indptr)
    src = np.repeat(np.arange(num_node, dtype=np.int64), deg)
    dst = indices.astype(np.int64)

    out = {}
    out["self_loops"] = int((src == dst).sum())
    out["zero_degree_nodes"] = int((deg == 0).sum())

    # within-row sortedness: adjacent comparisons, masked at row starts
    if num_edge > 1:
        adj_bad = indices[1:] < indices[:-1]
        row_start = np.zeros(num_edge - 1, dtype=bool)
        starts = indptr[1:-1]
        row_start[starts[(starts > 0) & (starts < num_edge)] - 1] = True
        out["indices_sorted"] = bool(~(adj_bad & ~row_start).any())
    else:
        out["indices_sorted"] = True

    codes = src * num_node + dst
    codes_sorted = np.sort(codes)
    out["duplicate_edges"] = int((codes_sorted[1:] == codes_sorted[:-1]).sum())

    # reverse edges, by multiplicity: an edge (s, d) of multiplicity m
    # matches min(m, multiplicity of (d, s)) reverse edges
    rev_sorted = np.sort(dst * num_node + src)
    out["reverse_edges"] = 0
    if num_edge:
        uc, cc = _unique_counts(codes_sorted)
        ur, cr = _unique_counts(rev_sorted)
        pos = np.searchsorted(ur, uc)
        pos_c = np.clip(pos, 0, len(ur) - 1)
        hit = ur[pos_c] == uc
        out["reverse_edges"] = int(
            np.minimum(cc, np.where(hit, cr[pos_c], 0)).sum()
        )
    out["is_undirected"] = out["reverse_edges"] == num_edge
    return out


def _unique_counts(sorted_codes):
    """(values, counts) of an already-sorted 1-D array."""
    first = np.ones(len(sorted_codes), dtype=bool)
    first[1:] = sorted_codes[1:] != sorted_codes[:-1]
    starts = np.flatnonzero(first)
    counts = np.diff(np.append(starts, len(sorted_codes)))
    return sorted_codes[starts], counts


def main(argv=None):
    p = argparse.ArgumentParser("fgnn_tpu_torch dataset info")
    p.add_argument("name")
    p.add_argument("--root", default=None)
    p.add_argument("--num-nodes", type=int, default=100_000)
    p.add_argument("--fanout", nargs="+", type=int, default=[25, 10])
    p.add_argument("--batch-size", type=int, default=8000)
    p.add_argument("--property", action="store_true",
                   help="full graph-property scan (O(E log E) sort)")
    args = p.parse_args(argv)

    from ..data import load_dataset, make_synthetic_dataset
    from ..ops.reference_impl import calibrate_caps

    if args.name == "synthetic":
        ds = make_synthetic_dataset(num_node=args.num_nodes, avg_degree=15,
                                    feat_dim=128, num_class=64)
    else:
        ds = load_dataset(args.name, root=args.root)

    indptr = np.asarray(ds.indptr)
    indices = np.asarray(ds.indices)
    deg = np.diff(indptr)

    # --- property check (toolkit/property csr checker) ------------------
    ok = True
    if indptr[0] != 0 or indptr[-1] != len(indices):
        print("FAIL: indptr endpoints inconsistent"); ok = False
    if (np.diff(indptr) < 0).any():
        print("FAIL: indptr not monotone"); ok = False
    if len(indices) and (indices.max() >= ds.num_node or indices.min() < 0):
        print("FAIL: indices out of range"); ok = False
    for name, arr in (("train", ds.train_set), ("test", ds.test_set),
                      ("valid", ds.valid_set)):
        a = np.asarray(arr)
        if len(a) and (a.max() >= ds.num_node or a.min() < 0):
            print(f"FAIL: {name}_set out of range"); ok = False
    print(f"csr_check={'OK' if ok else 'FAIL'}")

    if args.property:
        props = graph_properties(indptr, indices, ds.num_node)
        for k, v in props.items():
            print(f"{k}={v}")

    # --- degree stats (toolkit/degree) ----------------------------------
    print(f"num_node={ds.num_node} num_edge={ds.num_edge} "
          f"feat_dim={ds.feat_dim} num_class={ds.num_class}")
    print(f"train/test/valid={len(np.asarray(ds.train_set))}/"
          f"{len(np.asarray(ds.test_set))}/{len(np.asarray(ds.valid_set))}")
    qs = np.percentile(deg, [0, 50, 90, 99, 100]).astype(int)
    print(f"out_degree min/p50/p90/p99/max={'/'.join(map(str, qs))} "
          f"mean={deg.mean():.2f}")

    # --- sampled size estimate (toolkit/train_graph_size) ---------------
    caps = calibrate_caps(
        indptr, indices, np.asarray(ds.train_set), args.batch_size,
        list(reversed(args.fanout)), num_probe=3, seed=0,
    )
    print(f"calibrated (cumulative, new) unique caps per hop "
          f"(batch {args.batch_size}, fanout {args.fanout}): {caps}")
    feat_bytes_per_batch = caps[-1][0] * ds.feat_dim * 4
    print(f"est feature bytes/batch={feat_bytes_per_batch/1e6:.1f}MB")


if __name__ == "__main__":
    main()
