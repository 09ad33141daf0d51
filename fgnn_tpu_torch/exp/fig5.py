"""Figure 5, how far a degree-ranked cache falls short of the optimal one
(port of ``exp/fig5/run.py``):

    python -m fgnn_tpu_torch.exp.fig5 [--sample-type khop2|weighted_khop]
        [--synthetic-nodes N] [--out-dir DIR]

The source paper's exp/fig5a (khop on papers100M) and fig5b (weighted
sampling on twitter), both on the skewed synthetic graph here: one epoch
of batches is sampled on the card (GraphSAGE [5, 10, 15], batch 2000, every
hop deduplicated) and the degree, presample and optimal rankings are scored
over it at cache sizes 0-30%. ``--sample-type weighted_khop`` (fig5b)
builds the alias tables first, a per-vertex loop on the host that takes
tens of seconds at 1M nodes; its time is printed. Defaults are the
reference's. The table (``fig5a.dat`` / ``fig5b.dat`` and ``.json``, the
card and host in its header) goes to ``--out-dir``.
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
    stride)`` replaces the port's draws (:mod:`.access`)."""
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--synthetic-nodes", type=int, default=1_000_000)
    p.add_argument("--batch-size", type=int, default=2000)
    p.add_argument("--percentages", nargs="+", type=float,
                   default=[0.0, 0.05, 0.10, 0.15, 0.20, 0.25, 0.30])
    p.add_argument("--sample-type", default="khop2",
                   help="khop2 (fig5a) or weighted_khop (fig5b)")
    p.add_argument("--neighbor-skew", type=float, default=6.0)
    p.add_argument("--neighbor-pref", type=float, default=0.5)
    p.add_argument("--out-dir", default=os.path.join("chiprun_out", "fig5"))
    args = p.parse_args(argv)
    t_start = time.perf_counter()

    from ..cache.policy import build_ranking, rank_fake_optimal
    from ..config import CachePolicy, RunConfig, SampleType
    from ..data import build_alias_tables, make_synthetic_dataset
    from ..engine import OneChipEngine

    ds = make_synthetic_dataset(
        num_node=args.synthetic_nodes, avg_degree=15, feat_dim=16,
        num_class=16, seed=0, neighbor_skew=args.neighbor_skew,
        neighbor_pref=args.neighbor_pref)
    if args.sample_type.startswith("weighted"):
        t0 = time.perf_counter()
        build_alias_tables(ds, seed=0)
        print(f"[fig5] alias tables of {ds.num_node} nodes built on the host "
              f"in {time.perf_counter() - t0:.2f} s", flush=True)
    cfg = RunConfig(model="graphsage", fanout=(5, 10, 15),
                    batch_size=args.batch_size, num_hidden=16,
                    sample_type=SampleType(args.sample_type))
    eng = OneChipEngine(cfg, ds, torch.device(args.device))

    t0 = time.perf_counter()
    (batches,) = access.epoch_accesses(
        eng, [0], (draws or access.step_draws)(eng, 123, 0))
    ids = torch.cat(batches)
    freq = access.access_counts(ids, ds.num_node)
    print(f"[fig5] access pass: {len(batches)} batches, {ids.numel()} "
          f"accesses, {time.perf_counter() - t0:.2f} s", flush=True)

    rankings = {
        "degree": build_ranking(ds, CachePolicy.DEGREE, seed=0),
        "pre_sample": access.presample(eng, draws),
        "optimal": rank_fake_optimal(freq),
    }

    results = {}
    for pol, ranking in rankings.items():
        results[pol] = {}
        for pct in args.percentages:
            hit = access.hit_rate(ranking, ids, int(pct * ds.num_node))
            results[pol][pct] = round(hit, 4)
            print(f"policy={pol} pct={pct:.0%} hit_rate={hit:.1%}")

    suffix = "a" if not args.sample_type.startswith("weighted") else "b"
    meta = card_meta()
    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir, f"fig5{suffix}.json")
    with open(out, "w") as f:
        json.dump({"meta": meta, "config": vars(args), "hit_rate": results},
                  f, indent=2)
    with open(os.path.join(args.out_dir, f"fig5{suffix}.dat"), "w") as f:
        for k, v in meta.items():
            f.write(f"# {k}={v}\n")
        f.write("pct\t" + "\t".join(results) + "\n")
        for pct in args.percentages:
            f.write(f"{pct:.2f}\t" +
                    "\t".join(f"{results[pol][pct]:.4f}" for pol in results)
                    + "\n")
    print("wrote", out)
    print(f"[fig5] wall {time.perf_counter() - t_start:.1f} s", flush=True)
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
