"""Figure 4b, the feature dimension under a fixed cache budget (port of
``exp/fig4b/run.py``):

    python -m fgnn_tpu_torch.exp.fig4b [--fig4a PATH] [--budget-mb 64]
        [--dims 32 64 128 256 512] [--out-dir DIR]

The source paper's exp/fig4b (readme.md:1-20) is a simulation over fig4a's
measured hit rate against cache size: under a fixed cache budget a wider
feature row means fewer cacheable rows, so a lower hit rate, so a transfer
volume that grows faster than the width,

    cacheable_pct(dim) = budget / (num_node * dim * itemsize)
    miss_bytes(dim) ~ (1 - hit(cacheable_pct(dim))) * dim

It reads the port's ``fig4a.json`` (by default ``chiprun_out/fig4a/``; run
``python -m fgnn_tpu_torch.exp.fig4a`` first), interpolates the hit curve,
and writes the transfer size relative to dim 128 (``fig4b.dat``,
``fig4b.json``) to ``--out-dir``. Host arithmetic only.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--fig4a",
                   default=os.path.join("chiprun_out", "fig4a", "fig4a.json"),
                   help="the port's fig4a.json")
    p.add_argument("--budget-mb", type=float, default=64.0,
                   help="the fixed cache budget (the source paper's 5 GB "
                        "against papers100M's 54 GB table, scaled to the "
                        "synthetic graph fig4a ran on)")
    p.add_argument("--dims", nargs="+", type=int,
                   default=[32, 64, 128, 256, 512])
    p.add_argument("--base-dim", type=int, default=128)
    p.add_argument("--itemsize", type=int, default=4)
    p.add_argument("--num-node", type=int, default=None,
                   help="used when fig4a.json has no num_node")
    p.add_argument("--out-dir", default=os.path.join("chiprun_out", "fig4b"))
    args = p.parse_args(argv)

    with open(args.fig4a) as f:
        payload = json.load(f)
    # the port's runner writes {"meta", "results"}; a bare list is the rows
    runs = payload["results"] if isinstance(payload, dict) else payload
    pts = []
    for r in runs:
        if r["rc"] != 0 or "cache_hit_rate" not in r["values"]:
            continue
        pts.append((float(r["config"]["cache_percentage"]),
                    float(r["values"]["cache_hit_rate"])))
    if not pts:
        print(f"{args.fig4a} has no usable hit-rate points: run fig4a",
              file=sys.stderr)
        return 1
    pts.sort()
    num_node = int(runs[0]["config"].get("num_node",
                                         args.num_node or 1_000_000))
    pcts = np.array([p_ for p_, _ in pts])
    hits = np.array([h for _, h in pts])

    budget = args.budget_mb * 2**20
    rows = []
    for dim in args.dims:
        cacheable = min(1.0, budget / (num_node * dim * args.itemsize))
        hit = float(np.interp(cacheable, pcts, hits))
        # a row's transfer scales with dim, the miss share with (1 - hit)
        rel_miss = (1.0 - hit) * dim / args.base_dim
        rows.append((dim, cacheable, hit, rel_miss))
    base_miss = next(r[3] for r in rows if r[0] == args.base_dim)

    os.makedirs(args.out_dir, exist_ok=True)
    dat = os.path.join(args.out_dir, "fig4b.dat")
    with open(dat, "w") as f:
        f.write("dim\tcacheable_pct\tcache_hit_rate\trel_transfer_size\n")
        for dim, cacheable, hit, rel in rows:
            f.write(f"{dim}\t{cacheable:.4f}\t{hit:.4f}"
                    f"\t{rel / base_miss:.4f}\n")
    print(f"[exp] wrote {dat}")
    with open(os.path.join(args.out_dir, "fig4b.json"), "w") as f:
        json.dump(
            [{"dim": d, "cacheable_pct": c, "cache_hit_rate": h,
              "rel_transfer_size": r / base_miss}
             for d, c, h, r in rows], f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
