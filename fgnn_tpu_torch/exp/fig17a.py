"""Figure 17a, the balance switcher on and off for PinSAGE (port of
``exp/fig17a/run.py``):

    python -m fgnn_tpu_torch.exp.fig17a [--out-dir DIR]

The source paper's exp/fig17a (README.md:1-14): one epoch of PinSAGE with
and without dynamic switching at a fixed split, here arch5 2S+6T on a
100,000-node graph with half of it in the train set (25 steps of 2000):
no switcher, the cost-gated switcher, and the switcher with its tail forced
(``FGNN_TPU_SWITCHER_FORCE=1``). Each row runs at level 1 for 8 epochs and
again at level 2 for 3 epochs for the stage columns. A row with more
devices than the machine has cards repeats cards (``--devices``). The
table (``fig17a.dat``, ``fig17a.json``, the card and host in its header)
and the logs go to ``--out-dir``.
"""
from __future__ import annotations

import argparse
import os
import sys

from .runner import (card_meta, run_app, take_stages, worker_devices,
                     write_json, write_table)

COLUMNS = ["variant", "epoch_time", "epoch_time:min", "sample_time",
           "train_time"]
# an 8-epoch PinSAGE row with every role on one card takes longer than the
# runner's default 30 minutes in the worst case
ROW_TIMEOUT = 5400


def rows(args):
    """``(tag, app arguments, extra environment, row labels)`` of each
    row."""
    n = args.num_sample_worker + args.num_train_worker
    base = [
        "--device", args.device,
        "--devices", worker_devices(args.device, args.devices, n),
        "--model", "pinsage", "--sample-type", "random_walk",
        "--dataset", "synthetic",
        "--synthetic-nodes", str(args.synthetic_nodes),
        "--synthetic-train-frac", str(args.train_frac),
        "--num-epoch", str(args.num_epoch),
        "--batch-size", str(args.batch_size),
        "--arch", "arch5",
        "--num-sample-worker", str(args.num_sample_worker),
        "--num-train-worker", str(args.num_train_worker),
    ]
    switch = ["--have-switcher", "--switch-cache-percentage",
              str(args.switch_cache_percentage)]
    return [(tag, base + extra, env, {"variant": tag}) for tag, extra, env in (
        ("no_switch", [], {}),
        ("switch", switch, {}),
        ("switch_forced", switch, {"FGNN_TPU_SWITCHER_FORCE": "1"}))]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--devices", default=None,
                   help="the cards the rows take in turn (default: all)")
    p.add_argument("--synthetic-nodes", type=int, default=100_000)
    p.add_argument("--num-epoch", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=2000)
    p.add_argument("--train-frac", type=float, default=0.5)
    p.add_argument("--num-sample-worker", type=int, default=2)
    p.add_argument("--num-train-worker", type=int, default=6)
    p.add_argument("--switch-cache-percentage", type=float, default=0.1)
    p.add_argument("--out-dir", default=os.path.join("chiprun_out", "fig17a"))
    args = p.parse_args(argv)

    log_dir = os.path.join(args.out_dir, "run-logs")
    results = []
    for tag, app_args, env, labels in rows(args):
        print(f"[fig17a] {tag}", flush=True)
        r = run_app(app_args, log_dir, tag, env=env, timeout=ROW_TIMEOUT)
        r.config.update(labels)
        rp = run_app(app_args + ["--profile-level", "2", "--num-epoch", "3"],
                     log_dir, f"{tag}_stages", env=env, timeout=ROW_TIMEOUT)
        results.append(take_stages(r, rp))
    meta = card_meta()
    write_table(results, COLUMNS, os.path.join(args.out_dir, "fig17a.dat"),
                meta=meta)
    write_json(results, os.path.join(args.out_dir, "fig17a.json"), meta=meta)
    return int(any(r.returncode for r in results))


if __name__ == "__main__":
    sys.exit(main())
