"""Figure 15, arch5's stage breakdown as trainers are added (port of
``exp/fig15/run.py``):

    python -m fgnn_tpu_torch.exp.fig15 [--trainer-counts 1 3 7] [--out-dir DIR]

The source paper's exp/fig15 (README.md:1-6): FGNN's sample / copy / train
seconds an epoch on GCN [5, 10, 15] as the trainer count grows, one
sampler; the sample stage owns its device and stays flat while the train
stage shrinks. Each row runs at profile level 2 for the stage timers. A row
with more devices than the machine has cards repeats cards (``--devices``).
The table (``fig15.dat``, ``fig15.json``, the card and host in its header)
and the logs go to ``--out-dir``.
"""
from __future__ import annotations

import argparse
import os
import sys

from .runner import card_meta, run_app, worker_devices, write_json, write_table
from ..examples.common_config import MODEL_SAMPLE_TYPE

COLUMNS = ["split", "num_step", "sample_time", "copy_time", "train_time",
           "epoch_time"]


def rows(args):
    """``(tag, app arguments, extra environment, row labels)`` of each
    row."""
    out = []
    for t in args.trainer_counts:
        tag = f"1S+{t}T"
        out.append((tag, [
            "--device", args.device,
            "--devices", worker_devices(args.device, args.devices, t + 1),
            "--model", args.model, "--dataset", "synthetic",
            "--synthetic-nodes", str(args.synthetic_nodes),
            "--num-epoch", str(args.num_epoch),
            "--batch-size", str(args.batch_size),
            "--fanout", "5", "10", "15",
            "--arch", "arch5", "--num-sample-worker", "1",
            "--num-train-worker", str(t),
            "--profile-level", "2",
        ], {}, {"split": tag, "synthetic_nodes": args.synthetic_nodes,
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
    p.add_argument("--trainer-counts", nargs="+", type=int, default=[1, 3, 7])
    p.add_argument("--out-dir", default=os.path.join("chiprun_out", "fig15"))
    args = p.parse_args(argv)

    results = []
    for tag, app_args, env, labels in rows(args):
        print(f"[fig15] {tag}", flush=True)
        r = run_app(app_args, os.path.join(args.out_dir, "run-logs"), tag,
                    env=env)
        r.config.update(labels)
        results.append(r)
    meta = card_meta()
    write_table(results, COLUMNS, os.path.join(args.out_dir, "fig15.dat"),
                meta=meta)
    write_json(results, os.path.join(args.out_dir, "fig15.json"), meta=meta)
    return int(any(r.returncode for r in results))


if __name__ == "__main__":
    sys.exit(main())
