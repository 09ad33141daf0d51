"""Figure 12, what the cache policy does to the feature copy time (port of
``exp/fig12/run.py``):

    python -m fgnn_tpu_torch.exp.fig12 [--models gcn graphsage] [--out-dir DIR]

The source paper's exp/fig12 (readme.md:1-50): random, degree and
presample rankings at a fixed cache percentage; the hit rate drives the
copy stage. Each row runs the port's app on arch1 with the feature table in
host memory (``FGNN_TPU_FEAT_HBM_BUDGET=0``), [5, 10, 15], batch 4000, 20%
cache, 1M nodes at skew 6, pref 0.5, profile level 2. The rows and their
arguments are the reference's. The table (``fig12.dat``, ``fig12.json``,
the card and host in its header) and the logs go to ``--out-dir``.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from .runner import card_meta, run_app, write_json, write_table

COLUMNS = ["model", "policy", "cache_hit_rate", "copy_time", "train_time",
           "epoch_time", "epoch_time:min"]
POLICIES = ("random", "degree", "pre_sample")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--synthetic-nodes", type=int, default=1_000_000)
    p.add_argument("--num-epoch", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=4000)
    p.add_argument("--cache-percentage", type=float, default=0.2)
    p.add_argument("--models", nargs="+", default=["gcn", "graphsage"])
    p.add_argument("--out-dir", default=os.path.join("chiprun_out", "fig12"))
    args = p.parse_args(argv)
    t_start = time.perf_counter()

    env = {"FGNN_TPU_FEAT_HBM_BUDGET": "0"}
    results = []
    for model in args.models:
        base = [
            "--device", args.device, "--model", model, "--arch", "arch1",
            "--dataset", "synthetic",
            "--synthetic-nodes", str(args.synthetic_nodes),
            "--num-epoch", str(args.num_epoch),
            "--batch-size", str(args.batch_size),
            "--fanout", "5", "10", "15",
            "--synthetic-skew", "6", "--synthetic-pref", "0.5",
            "--cache-percentage", str(args.cache_percentage),
            "--profile-level", "2",
        ]
        for policy in POLICIES:
            tag = f"{model}_{policy}"
            print(f"[fig12] {tag}", flush=True)
            r = run_app(base + ["--cache-policy", policy],
                        os.path.join(args.out_dir, "run-logs"), tag, env=env)
            r.config["model"] = model
            r.config["policy"] = policy
            results.append(r)

    meta = card_meta()
    write_table(results, COLUMNS, os.path.join(args.out_dir, "fig12.dat"),
                meta=meta)
    write_json(results, os.path.join(args.out_dir, "fig12.json"), meta=meta)
    print(f"[fig12] wall {time.perf_counter() - t_start:.1f} s", flush=True)
    return int(any(r.returncode for r in results))


if __name__ == "__main__":
    sys.exit(main())
