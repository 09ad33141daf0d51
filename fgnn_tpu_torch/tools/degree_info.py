"""Degree toolkit (port of ``tools/degree_info.py``; the source system's
utility/data-process/toolkit/degree/degree_info.cc): in- and out-degrees
and their artifacts,

    out_degrees.bin                uint32 per node
    in_degrees.bin                 uint32 per node
    out_degree_frequency.txt       "degree count" lines, descending degree
    in_degree_frequency.txt        the same for in-degree
    sorted_nodes_by_in_degree.bin  uint32 node ids, hottest first: the
                                   input of the cache_by_degree ranking

    python -m fgnn_tpu_torch.tools.degree_info <name> [--root PATH] [--out DIR]
    python -m fgnn_tpu_torch.tools.degree_info synthetic --num-nodes 100000

NumPy only, on the host. For the same dataset the artifacts and the report
are the reference's.
"""
import argparse
import os

import numpy as np


def degree_artifacts(indptr, indices, num_node, out_dir):
    out_deg = np.diff(indptr).astype(np.uint32)
    in_deg = np.bincount(indices, minlength=num_node).astype(np.uint32)
    os.makedirs(out_dir, exist_ok=True)
    out_deg.tofile(os.path.join(out_dir, "out_degrees.bin"))
    in_deg.tofile(os.path.join(out_dir, "in_degrees.bin"))
    for name, deg in (("out", out_deg), ("in", in_deg)):
        vals, counts = np.unique(deg, return_counts=True)
        with open(os.path.join(out_dir, f"{name}_degree_frequency.txt"),
                  "w") as f:
            for v, c in zip(vals[::-1], counts[::-1]):
                f.write(f"{v} {c}\n")
    ranking = np.argsort(-in_deg.astype(np.int64), kind="stable")
    ranking.astype(np.uint32).tofile(
        os.path.join(out_dir, "sorted_nodes_by_in_degree.bin"))
    return out_deg, in_deg, ranking


def main(argv=None):
    p = argparse.ArgumentParser("fgnn_tpu_torch degree info")
    p.add_argument("name")
    p.add_argument("--root", default=None)
    p.add_argument("--num-nodes", type=int, default=100_000)
    p.add_argument("--out", default="degree-out")
    args = p.parse_args(argv)

    from ..data import load_dataset, make_synthetic_dataset

    if args.name == "synthetic":
        ds = make_synthetic_dataset(num_node=args.num_nodes, avg_degree=15,
                                    feat_dim=16, num_class=4)
    else:
        ds = load_dataset(args.name, root=args.root)

    indptr = np.asarray(ds.indptr)
    indices = np.asarray(ds.indices)
    out_deg, in_deg, ranking = degree_artifacts(
        indptr, indices, ds.num_node, args.out)
    for name, deg in (("out", out_deg), ("in", in_deg)):
        qs = np.percentile(deg, [0, 50, 90, 99, 100]).astype(int)
        print(f"{name}_degree min/p50/p90/p99/max={'/'.join(map(str, qs))} "
              f"mean={deg.mean():.2f}")
    print(f"wrote {args.out}/: out_degrees.bin in_degrees.bin "
          f"{{in,out}}_degree_frequency.txt sorted_nodes_by_in_degree.bin")


if __name__ == "__main__":
    main()
