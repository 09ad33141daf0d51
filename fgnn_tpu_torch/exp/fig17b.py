"""Figure 17b, one device's end-to-end epoch time per model (port of
``exp/fig17b/run.py``):

    python -m fgnn_tpu_torch.exp.fig17b [--models gcn graphsage pinsage]
        [--out-dir DIR]

The source paper's exp/fig17b (README.md:1-10) sets DGL and T_SOTA against
GNNLab on one GPU for GCN, GraphSAGE and PinSAGE; the external baselines'
numbers live in BASELINE.md. The system's point here is the port's app on
arch1 (the table on the card), one row per model: 200,000 nodes, batch
8000, the app's [5, 10, 15] (PinSAGE on random walks). The rows and their
arguments are the reference's. The table (``fig17b.dat``, ``fig17b.json``,
the card and host in its header) and the logs go to ``--out-dir``.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from .runner import card_meta, run_app, write_json, write_table

COLUMNS = ["model", "epoch_time", "epoch_time:min"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--synthetic-nodes", type=int, default=200_000)
    p.add_argument("--num-epoch", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=8000)
    p.add_argument("--models", nargs="+",
                   default=["gcn", "graphsage", "pinsage"])
    p.add_argument("--out-dir", default=os.path.join("chiprun_out", "fig17b"))
    args = p.parse_args(argv)
    t_start = time.perf_counter()

    results = []
    for model in args.models:
        base = [
            "--device", args.device, "--model", model, "--arch", "arch1",
            "--dataset", "synthetic",
            "--synthetic-nodes", str(args.synthetic_nodes),
            "--num-epoch", str(args.num_epoch),
            "--batch-size", str(args.batch_size),
        ]
        if model == "pinsage":
            base += ["--sample-type", "random_walk"]
        print(f"[fig17b] {model}", flush=True)
        r = run_app(base, os.path.join(args.out_dir, "run-logs"), model,
                    env={})
        r.config["model"] = model
        results.append(r)

    meta = card_meta()
    write_table(results, COLUMNS, os.path.join(args.out_dir, "fig17b.dat"),
                meta=meta)
    write_json(results, os.path.join(args.out_dir, "fig17b.json"), meta=meta)
    print(f"[fig17b] wall {time.perf_counter() - t_start:.1f} s", flush=True)
    return int(any(r.returncode for r in results))


if __name__ == "__main__":
    sys.exit(main())
