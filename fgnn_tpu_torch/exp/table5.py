"""Table 5, arch5's sampler/trainer split and the switcher, beside arch6
(port of ``exp/table5/run.py``):

    python -m fgnn_tpu_torch.exp.table5 [--num-workers 8] [--out-dir DIR]

The source paper's exp/table5: FGNN's epoch time as n devices split into
1S+(n-1)T ... 3S+(n-3)T, 2S+(n-2)T with the balance switcher, and SGNN over
all n, GraphSAGE [5, 10, 15] at the reference's real-chip defaults (batch
8000, 4 epochs, 200,000 synthetic nodes). Each row runs twice:
``epoch_time`` from a level-1 run, the stage columns from a level-2 run. A
row with more devices than the machine has cards repeats cards
(``--devices``). The table (``table5.dat``, ``table5.json``, the card and
host in its header) and the logs go to ``--out-dir``.
"""
from __future__ import annotations

import argparse
import os
import sys

from .runner import (card_meta, run_app, take_stages, worker_devices,
                     write_json, write_table)
from ..examples.common_config import MODEL_SAMPLE_TYPE

COLUMNS = ["split", "num_step", "epoch_time", "epoch_time:min",
           "sample_time", "copy_time", "extract_time", "train_time"]


def rows(args):
    """``(tag, app arguments, extra environment, row labels)`` of each
    row."""
    n = args.num_workers
    configs = [(f"{s}S+{n - s}T", ["--num-sample-worker", str(s),
                                   "--num-train-worker", str(n - s)])
               for s in (1, 2, 3) if s < n]
    configs.append((f"2S+{n - 2}T+switch",
                    ["--num-sample-worker", "2",
                     "--num-train-worker", str(n - 2), "--have-switcher"]))
    configs.append((f"SGNN-{n}w", ["--arch", "arch6",
                                   "--num-train-worker", str(n)]))
    out = []
    for tag, workers in configs:
        out.append((tag.replace("+", "_"), [
            "--device", args.device,
            "--devices", worker_devices(args.device, args.devices, n),
            "--model", args.model, "--dataset", args.dataset,
            "--synthetic-nodes", str(args.synthetic_nodes),
            "--num-epoch", str(args.num_epoch),
            "--batch-size", str(args.batch_size),
            "--fanout", "5", "10", "15",
        ] + (workers if "--arch" in workers else ["--arch", "arch5"] + workers),
            {}, {"split": tag, "synthetic_nodes": args.synthetic_nodes,
                 "sample_type": MODEL_SAMPLE_TYPE[args.model]}))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--devices", default=None,
                   help="the cards the rows take in turn (default: all)")
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--synthetic-nodes", type=int, default=200_000)
    p.add_argument("--num-epoch", type=int, default=4)
    p.add_argument("--model", default="graphsage")
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=8000)
    p.add_argument("--out-dir", default=os.path.join("chiprun_out", "table5"))
    args = p.parse_args(argv)

    log_dir = os.path.join(args.out_dir, "run-logs")
    results = []
    for tag, app_args, env, labels in rows(args):
        print(f"[table5] {labels['split']}", flush=True)
        r = run_app(app_args, log_dir, tag, env=env)
        r.config.update(labels)
        rp = run_app(app_args + ["--profile-level", "2"], log_dir,
                     f"{tag}_stages", env=env)
        results.append(take_stages(r, rp))
    meta = card_meta()
    write_table(results, COLUMNS, os.path.join(args.out_dir, "table5.dat"),
                meta=meta)
    write_json(results, os.path.join(args.out_dir, "table5.json"), meta=meta)
    return int(any(r.returncode for r in results))


if __name__ == "__main__":
    sys.exit(main())
