"""Figure 11 and Table 6's hit-rate half: each cache policy's hit rate and
init cost (port of ``exp/fig11/run.py``):

    python -m fgnn_tpu_torch.exp.fig11 [--synthetic-nodes N] [--out-dir DIR]

The source paper's exp/fig11 and exp/table6: presampling reaches a
near-optimal hit rate at an init cost near the degree policy's. The access
pass samples ``--num-epoch`` epochs on the card (GraphSAGE [10, 10], KHOP0,
batch 1000, every hop deduplicated); each policy's ranking is built and
timed (``build_ranking`` on the host; ``presample_ranking`` on the card, the
card synchronised before the clock stops) and scored at
``--cache-percentage`` over all those batches; the optimal ranking is their
own access counts. Defaults are the reference's: 1M nodes, 3 epochs, 10%,
skew 6, pref 0.5. The table (``fig11.dat``, ``fig11.json``, the card and
host in its header) goes to ``--out-dir``.
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


def main(argv=None, draws=None) -> list:
    """Returns ``[{policy, init_time, hit_rate}]``. ``draws(eng, base,
    stride)`` replaces the port's draws (:mod:`.access`)."""
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--synthetic-nodes", type=int, default=1_000_000)
    p.add_argument("--cache-percentage", type=float, default=0.1)
    p.add_argument("--num-epoch", type=int, default=3)
    p.add_argument("--neighbor-skew", type=float, default=6.0,
                   help="access skew (6 ~ papers100M-like hot set)")
    p.add_argument("--neighbor-pref", type=float, default=0.5,
                   help="degree between random and presample")
    p.add_argument("--out-dir", default=os.path.join("chiprun_out", "fig11"))
    args = p.parse_args(argv)
    t_start = time.perf_counter()

    from ..cache.policy import build_ranking, rank_fake_optimal
    from ..config import CachePolicy, RunConfig, SampleType
    from ..data import make_synthetic_dataset
    from ..engine import OneChipEngine, device_sync

    t0 = time.perf_counter()
    ds = make_synthetic_dataset(
        num_node=args.synthetic_nodes, avg_degree=15, feat_dim=64,
        num_class=32, seed=0, neighbor_skew=args.neighbor_skew,
        neighbor_pref=args.neighbor_pref,
    )
    cfg = RunConfig(model="graphsage", fanout=(10, 10), batch_size=1000,
                    sample_type=SampleType.KHOP0, dropout=0.0)
    eng = OneChipEngine(cfg, ds, torch.device(args.device))
    print(f"[fig11] graph and engine {time.perf_counter() - t0:.2f} s",
          flush=True)

    t0 = time.perf_counter()
    stride = eng.shuffler.num_step
    rand = (draws or access.step_draws)(eng, 123, stride)
    ids = torch.cat([b for epoch in access.epoch_accesses(
        eng, range(args.num_epoch), rand) for b in epoch])
    freq = access.access_counts(ids, ds.num_node)
    print(f"[fig11] access pass: {args.num_epoch} epochs of {stride} "
          f"batches, {ids.numel()} accesses, {time.perf_counter() - t0:.2f} s",
          flush=True)
    cache_n = int(args.cache_percentage * ds.num_node)

    results = []
    for policy in ("random", "degree", "degree_hop", "heuristic"):
        t0 = time.perf_counter()
        ranking = build_ranking(ds, CachePolicy(policy), seed=0)
        results.append({"policy": policy,
                        "init_time": time.perf_counter() - t0,
                        "hit_rate": access.hit_rate(ranking, ids, cache_n)})

    t0 = time.perf_counter()
    ranking = access.presample(eng, draws)
    device_sync(eng.device)
    results.append({"policy": "pre_sample",
                    "init_time": time.perf_counter() - t0,
                    "hit_rate": access.hit_rate(ranking, ids, cache_n)})

    results.append({"policy": "optimal", "init_time": 0.0,
                    "hit_rate": access.hit_rate(rank_fake_optimal(freq), ids,
                                                cache_n)})

    for r in results:
        print(f"test_result:hit_rate:{r['policy']}={r['hit_rate']:.4f}")
        print(f"test_result:init_time:{r['policy']}={r['init_time']:.4f}")
    meta = card_meta()
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "fig11.json"), "w") as f:
        json.dump({"meta": meta, "results": results}, f, indent=2)
    dat = os.path.join(args.out_dir, "fig11.dat")
    with open(dat, "w") as f:
        for k, v in meta.items():
            f.write(f"# {k}={v}\n")
        f.write("policy\thit_rate\tinit_time\n")
        for r in results:
            f.write(f"{r['policy']}\t{r['hit_rate']:.4f}\t"
                    f"{r['init_time']:.4f}\n")
    print(f"[exp] wrote {dat}")
    print(f"[fig11] wall {time.perf_counter() - t_start:.1f} s", flush=True)
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
