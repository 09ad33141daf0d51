"""Table 2, the epoch-to-epoch similarity of node accesses: why one
presampled epoch predicts the rest (port of ``exp/table2/run.py``):

    python -m fgnn_tpu_torch.exp.table2 [--synthetic-nodes N] [--out-dir DIR]

The source paper's exp/table2 (readme.md:29-41),
``node_access:epoch_similarity`` per (sample type, app). For each workload
(khop2 / GCN, random_walk / PinSAGE, weighted_khop_prefix / GCN, all
[5, 10, 15] at batch 8000) ``--num-epoch`` epochs are sampled on the card,
every hop deduplicated; each epoch's touched nodes are a boolean mask on
the card, and the similarity is the mean Jaccard index (%) of consecutive
epochs (profiler.node_access_similarity, profiler.cc:657-791). The
weighted workload needs the alias tables, a per-vertex loop on the host
whose time is printed. Defaults are the reference's (200,000 nodes, skew
6). The table (``table2.dat``, ``table2.json``, the card and host in its
header) goes to ``--out-dir``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from . import access
from .runner import card_meta

# the workloads: (sample type, app), all at fanout [5, 10, 15]
WORKLOADS = (("khop2", "gcn"), ("random_walk", "pinsage"),
             ("weighted_khop_prefix", "gcn"))
EPOCH_STRIDE = 65537   # the reference's key: ep * 65537 + step


def main(argv=None, draws=None) -> list:
    """Returns the rows ``{sample_type, app, epoch_similarity, epochs,
    touched_per_epoch}``. ``draws(eng, base, stride)`` replaces the port's
    draws (:mod:`.access`)."""
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--synthetic-nodes", type=int, default=200_000)
    p.add_argument("--num-epoch", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=8000)
    p.add_argument("--neighbor-skew", type=float, default=6.0)
    p.add_argument("--out-dir", default=os.path.join("chiprun_out", "table2"))
    args = p.parse_args(argv)
    t_start = time.perf_counter()

    from ..config import RunConfig, SampleType
    from ..data import build_alias_tables, make_synthetic_dataset
    from ..engine import OneChipEngine

    ds = make_synthetic_dataset(
        num_node=args.synthetic_nodes, avg_degree=15, feat_dim=32,
        num_class=16, seed=0, neighbor_skew=args.neighbor_skew,
    )
    t0 = time.perf_counter()
    build_alias_tables(ds, seed=0)  # the weighted workload's tables
    print(f"[table2] alias tables of {ds.num_node} nodes built on the host "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)

    rows = []
    for st_name, app in WORKLOADS:
        cfg = RunConfig(model=app, batch_size=args.batch_size, num_hidden=32,
                        sample_type=SampleType(st_name), fanout=(5, 10, 15))
        eng = OneChipEngine(cfg, ds, torch.device(args.device))
        t0 = time.perf_counter()
        epochs = access.epoch_accesses(
            eng, range(args.num_epoch),
            (draws or access.step_draws)(eng, 7, EPOCH_STRIDE))
        masks = [access.touched(b, ds.num_node) for b in epochs]
        sim = access.epoch_similarity(masks)
        print(f"[table2] {st_name:24s} {app:10s} "
              f"epoch_similarity={sim:.2f}% "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)
        rows.append(dict(sample_type=st_name, app=app,
                         epoch_similarity=sim,
                         epochs=args.num_epoch,
                         touched_per_epoch=[int(m.sum()) for m in masks]))

    meta = card_meta()
    os.makedirs(args.out_dir, exist_ok=True)
    dat = os.path.join(args.out_dir, "table2.dat")
    with open(dat, "w") as f:
        for k, v in meta.items():
            f.write(f"# {k}={v}\n")
        f.write("sample_type\tapp\tnode_access:epoch_similarity\n")
        for r in rows:
            f.write(f"{r['sample_type']}\t{r['app']}\t"
                    f"{r['epoch_similarity']:.4f}\n")
    with open(os.path.join(args.out_dir, "table2.json"), "w") as f:
        json.dump({"meta": meta, "results": rows}, f, indent=2)
    print(f"[table2] wrote {dat}")
    print(f"[table2] wall {time.perf_counter() - t_start:.1f} s", flush=True)
    return rows


if __name__ == "__main__":
    main()
    sys.exit(0)
