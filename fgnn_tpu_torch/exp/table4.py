"""Table 4, end-to-end epoch time of arch5 (FGNN) against arch6 (SGNN)
(port of ``exp/table4/run.py``):

    python -m fgnn_tpu_torch.exp.table4 [--models gcn graphsage pinsage] \\
        [--num-workers 8] [--out-dir DIR]

The source paper's exp/table4: DGL / PyG / SGNN / FGNN epoch times per model
and dataset. Here arch5 (n // 4 samplers, at least one, and the rest
trainers) against arch6 (n workers) per model, [5, 10, 15], at the
reference's real-chip defaults (batch 8000, 4 epochs, 200,000 synthetic
nodes). Each row runs twice: ``epoch_time`` from a level-1 run, the stage
columns from a level-2 run (its stage syncs cost time). A row with more
devices than the machine has cards repeats cards (``--devices``). The table
(``table4.dat``, ``table4.json``, the card and host in its header) and the
logs go to ``--out-dir``.
"""
from __future__ import annotations

import argparse
import os
import sys

from .runner import (card_meta, run_app, take_stages, worker_devices,
                     write_json, write_table)
from ..examples.common_config import MODEL_SAMPLE_TYPE

COLUMNS = ["model", "run_arch", "num_step", "epoch_time", "sample_time",
           "copy_time", "extract_time", "train_time", "init_time"]


def rows(args):
    """``(tag, app arguments, extra environment, row labels)`` of each
    row."""
    n = args.num_workers
    s = max(1, n // 4)
    devices = worker_devices(args.device, args.devices, n)
    out = []
    for model in args.models:
        for arch, workers in (
                ("arch5", ["--num-sample-worker", str(s),
                           "--num-train-worker", str(n - s)]),
                ("arch6", ["--num-train-worker", str(n)])):
            out.append((f"{model}_{arch}", [
                "--device", args.device, "--devices", devices,
                "--model", model, "--arch", arch,
                "--dataset", args.dataset,
                "--synthetic-nodes", str(args.synthetic_nodes),
                "--num-epoch", str(args.num_epoch),
                "--batch-size", str(args.batch_size),
                "--fanout", "5", "10", "15",
            ] + workers, {}, {
                "model": model, "run_arch": arch,
                "synthetic_nodes": args.synthetic_nodes,
                "sample_type": MODEL_SAMPLE_TYPE[model]}))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--devices", default=None,
                   help="the cards the rows take in turn (default: all)")
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--synthetic-nodes", type=int, default=200_000)
    p.add_argument("--num-epoch", type=int, default=4)
    p.add_argument("--num-workers", type=int, default=8,
                   help="role devices (arch5 splits S+T, arch6 uses all)")
    p.add_argument("--batch-size", type=int, default=8000)
    p.add_argument("--models", nargs="+",
                   default=["gcn", "graphsage", "pinsage"])
    p.add_argument("--out-dir", default=os.path.join("chiprun_out", "table4"))
    args = p.parse_args(argv)

    log_dir = os.path.join(args.out_dir, "run-logs")
    results = []
    for tag, app_args, env, labels in rows(args):
        print(f"[table4] {tag}", flush=True)
        r = run_app(app_args, log_dir, tag, env=env)
        r.config.update(labels)
        rp = run_app(app_args + ["--profile-level", "2"], log_dir,
                     f"{tag}_stages", env=env)
        results.append(take_stages(r, rp))
    meta = card_meta()
    write_table(results, COLUMNS, os.path.join(args.out_dir, "table4.dat"),
                meta=meta)
    write_json(results, os.path.join(args.out_dir, "table4.json"), meta=meta)
    for r in results:
        print("[table4] " + "\t".join(
            [r.config["model"], r.config["run_arch"]]
            + [r.values.get(c, "X") for c in COLUMNS[2:]])
            + f"\trc={r.returncode}", flush=True)
    return int(any(r.returncode for r in results))


if __name__ == "__main__":
    sys.exit(main())
