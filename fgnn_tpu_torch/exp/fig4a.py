"""Figure 4a, what the cache size does to feature extraction (port of
``exp/fig4a/run.py``):

    python -m fgnn_tpu_torch.exp.fig4a [--percentages 0 0.05 ...] [--out-dir DIR]

The source paper's exp/fig4a (README.md:1-8): the hit rate and the feature
copy time as the cache percentage grows. Each row runs the port's app on
arch1 with the feature table in host memory (``FGNN_TPU_FEAT_HBM_BUDGET=0``)
behind the presample cache, GraphSAGE [5, 10, 15], batch 2000, 1M nodes at
skew 6, pref 0.5, profile level 2 (a sync per stage for the stage columns).
The rows and their arguments are the reference's. The table (``fig4a.dat``,
``fig4a.json``, the card and host in its header; fig4b reads the json) and
the logs go to ``--out-dir``.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from .runner import card_meta, run_app, write_json, write_table

COLUMNS = ["cache_percentage", "cache_hit_rate", "copy_time", "extract_time",
           "train_time", "epoch_time"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--synthetic-nodes", type=int, default=1_000_000)
    p.add_argument("--num-epoch", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=2000)
    p.add_argument("--percentages", nargs="+", type=float,
                   default=[0.0, 0.05, 0.1, 0.2, 0.3])
    p.add_argument("--out-dir", default=os.path.join("chiprun_out", "fig4a"))
    args = p.parse_args(argv)
    t_start = time.perf_counter()

    env = {"FGNN_TPU_FEAT_HBM_BUDGET": "0"}
    base = [
        "--device", args.device, "--model", "graphsage", "--arch", "arch1",
        "--dataset", "synthetic",
        "--synthetic-nodes", str(args.synthetic_nodes),
        "--num-epoch", str(args.num_epoch),
        "--batch-size", str(args.batch_size),
        "--fanout", "5", "10", "15",
        "--synthetic-skew", "6", "--synthetic-pref", "0.5",
        "--cache-policy", "pre_sample", "--presample-epoch", "1",
        "--profile-level", "2",
    ]
    results = []
    for pct in args.percentages:
        tag = f"cache_{int(pct * 100):02d}"
        print(f"[fig4a] {tag}", flush=True)
        r = run_app(base + ["--cache-percentage", str(pct)],
                    os.path.join(args.out_dir, "run-logs"), tag, env=env)
        r.config["cache_percentage"] = pct
        r.config["num_node"] = args.synthetic_nodes  # fig4b reads it
        results.append(r)

    meta = card_meta()
    write_table(results, COLUMNS, os.path.join(args.out_dir, "fig4a.dat"),
                meta=meta)
    write_json(results, os.path.join(args.out_dir, "fig4a.json"), meta=meta)
    print(f"[fig4a] wall {time.perf_counter() - t_start:.1f} s", flush=True)
    return int(any(r.returncode for r in results))


if __name__ == "__main__":
    sys.exit(main())
