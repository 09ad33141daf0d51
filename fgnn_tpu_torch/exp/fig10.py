"""Figure 10, the cache hit rate by policy and cache size (port of
``exp/fig10/run.py``):

    python -m fgnn_tpu_torch.exp.fig10 [--synthetic-nodes N] [--out-dir DIR]

The source paper's exp/fig10: the hit rates of random, degree and presample
rankings against the optimal one. One epoch of batches is sampled on the
card (GraphSAGE [5, 10, 15], KHOP2, batch 8000, every hop deduplicated),
each ranking's top k is scored over them, and the optimal ranking is the
epoch's own access counts (profiler.cc ReportNodeAccessSimple), so it
bounds every policy. The defaults are the reference's: 1M nodes, skew 6,
pref 0.5 (a degree ranking between random and presample). On small graphs
the 2-hop frontier covers most of the graph and every policy tends to the
cache fraction; compare policies at 1M nodes or more. The table
(``fig10.dat``, ``fig10.json``, the card and host in its header) goes to
``--out-dir``.
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


def main(argv=None, draws=None) -> dict:
    """Returns ``{policy: {percentage: hit rate}}``. ``draws(eng, base,
    stride)`` replaces the port's draws of the access pass and of the
    presample (:mod:`.access`)."""
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--synthetic-nodes", type=int, default=1_000_000)
    p.add_argument("--percentages", nargs="+", type=float,
                   default=[0.01, 0.05, 0.1, 0.2])
    p.add_argument("--policies", nargs="+",
                   default=["random", "degree", "pre_sample"])
    p.add_argument("--neighbor-skew", type=float, default=6.0,
                   help="access skew (6 ~ papers100M-like hot set)")
    p.add_argument("--neighbor-pref", type=float, default=0.5,
                   help="fraction of edge mass riding the out-degree ranking")
    p.add_argument("--out-dir", default=os.path.join("chiprun_out", "fig10"))
    args = p.parse_args(argv)
    t_start = time.perf_counter()

    from ..cache.policy import build_ranking, rank_fake_optimal
    from ..config import CachePolicy, RunConfig, SampleType
    from ..data import make_synthetic_dataset
    from ..engine import OneChipEngine

    t0 = time.perf_counter()
    ds = make_synthetic_dataset(num_node=args.synthetic_nodes, avg_degree=15,
                                feat_dim=32, num_class=16, seed=0,
                                neighbor_skew=args.neighbor_skew,
                                neighbor_pref=args.neighbor_pref)
    cfg = RunConfig(model="graphsage", fanout=(5, 10, 15), batch_size=8000,
                    num_hidden=32, sample_type=SampleType.KHOP2)
    eng = OneChipEngine(cfg, ds, torch.device(args.device))
    print(f"[fig10] graph and engine {time.perf_counter() - t0:.2f} s",
          flush=True)

    t0 = time.perf_counter()
    draw = draws or access.step_draws
    (batches,) = access.epoch_accesses(eng, [0], draw(eng, 123, 0))
    ids = torch.cat(batches)
    freq = access.access_counts(ids, ds.num_node)
    print(f"[fig10] access pass: {len(batches)} batches, {ids.numel()} "
          f"accesses, {time.perf_counter() - t0:.2f} s", flush=True)

    rankings = {}
    for pol in args.policies:
        if pol == "pre_sample":
            rankings[pol] = access.presample(eng, draws)
        else:
            rankings[pol] = build_ranking(ds, CachePolicy(pol), seed=0)
    rankings["optimal"] = rank_fake_optimal(freq)

    results = {}
    for pol, ranking in rankings.items():
        results[pol] = {}
        for pct in args.percentages:
            hit = access.hit_rate(ranking, ids, int(pct * ds.num_node))
            results[pol][pct] = round(hit, 4)
            print(f"policy={pol} pct={pct:.0%} hit_rate={hit:.1%}")

    meta = card_meta()
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "fig10.json"), "w") as f:
        json.dump({"meta": meta, "config": vars(args), "hit_rate": results},
                  f, indent=2)
    dat = os.path.join(args.out_dir, "fig10.dat")
    with open(dat, "w") as f:
        for k, v in meta.items():
            f.write(f"# {k}={v}\n")
        pcts = args.percentages
        f.write("policy\t" + "\t".join(f"{p:.0%}" for p in pcts) + "\n")
        for pol, row in results.items():
            f.write(pol + "\t"
                    + "\t".join(f"{row[p]:.4f}" for p in pcts) + "\n")
    print("wrote", dat)
    print(f"[fig10] wall {time.perf_counter() - t_start:.1f} s", flush=True)
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
