"""Figure 14, the scalability of arch5 (FGNN) against arch6 (SGNN) (port of
``exp/fig14/run.py``):

    python -m fgnn_tpu_torch.exp.fig14 [--worker-counts 2 4 8] [--out-dir DIR]

The source paper's exp/fig14a/b (README.md:1-8): epoch time as the worker
count n grows, GCN [5, 10, 15]. arch5 runs 1 sampler + (n - 1) trainers (the
paper's minimal-sampler split), arch6 n space-shared workers. A row with
more workers than the machine has cards repeats cards (``--devices``). The
table (``fig14.dat``, ``fig14.json``, the card and host in its header) and
the logs go to ``--out-dir``; the rows run one at a time.
"""
from __future__ import annotations

import argparse
import os
import sys

from .runner import card_meta, run_app, worker_devices, write_json, write_table
from ..examples.common_config import MODEL_SAMPLE_TYPE

COLUMNS = ["system", "workers", "num_step", "epoch_time", "epoch_time:min"]


def rows(args):
    """``(tag, app arguments, extra environment, row labels)`` of each
    row."""
    out = []
    for n in args.worker_counts:
        base = [
            "--device", args.device,
            "--devices", worker_devices(args.device, args.devices, n),
            "--model", args.model, "--dataset", "synthetic",
            "--synthetic-nodes", str(args.synthetic_nodes),
            "--num-epoch", str(args.num_epoch),
            "--batch-size", str(args.batch_size),
            "--fanout", "5", "10", "15",
        ]
        for system, extra in (
                ("fgnn", ["--arch", "arch5", "--num-sample-worker", "1",
                          "--num-train-worker", str(n - 1)]),
                ("sgnn", ["--arch", "arch6", "--num-train-worker", str(n)])):
            out.append((f"{system}_{n}w", base + extra, {}, {
                "system": system, "workers": n,
                "synthetic_nodes": args.synthetic_nodes,
                "sample_type": MODEL_SAMPLE_TYPE.get(args.model, "khop2")}))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--devices", default=None,
                   help="the cards the rows take in turn (default: all)")
    p.add_argument("--synthetic-nodes", type=int, default=100_000)
    p.add_argument("--num-epoch", type=int, default=3)
    p.add_argument("--model", default="gcn")
    p.add_argument("--batch-size", type=int, default=4000)
    p.add_argument("--worker-counts", nargs="+", type=int, default=[2, 4, 8])
    p.add_argument("--out-dir", default=os.path.join("chiprun_out", "fig14"))
    args = p.parse_args(argv)

    results = []
    for tag, app_args, env, labels in rows(args):
        print(f"[fig14] {tag}", flush=True)
        r = run_app(app_args, os.path.join(args.out_dir, "run-logs"), tag,
                    env=env)
        r.config.update(labels)
        results.append(r)
    meta = card_meta()
    write_table(results, COLUMNS, os.path.join(args.out_dir, "fig14.dat"),
                meta=meta)
    write_json(results, os.path.join(args.out_dir, "fig14.json"), meta=meta)
    return int(any(r.returncode for r in results))


if __name__ == "__main__":
    sys.exit(main())
