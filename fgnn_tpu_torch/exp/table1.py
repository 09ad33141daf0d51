"""Table 1, the motivation ablation (port of ``exp/table1/run.py``): where
does epoch time go as sampling moves to the device and a feature cache is
added?

    python -m fgnn_tpu_torch.exp.table1 [--num-epoch 4] [--out-dir DIR]

The source paper's exp/table1 (README.md:95-104) with Sample / Extract /
Train / Total columns. The rows map its two axes onto the port's engines:

  host-sample            arch0: host sampling, host extract
  host-sample+cache      arch0 + the presample feature cache
  dev-sample             arch1 with the feature table in host memory
  dev-sample+cache       arch1, host table + the presample cache
  dev-sample+hbm-feat    arch1 with the whole feature table on the device

Each row runs twice: ``epoch_time`` from a level-1 run (the unobserved
path), the stage columns from a level-2 run, whose stage syncs cost time
(``epoch_time_l2``). The defaults are the reference's: GraphSAGE [5, 10,
15], batch 8000, hidden 256, 200,000 synthetic nodes, PRESAMPLE 20%. The
table (``table1.dat``, ``table1.json``, the card and host in its header)
and the logs go to ``--out-dir``. The rows run one at a time, each alone
on the card and the host.
"""
from __future__ import annotations

import argparse
import os
import sys

from .runner import card_meta, run_app, write_json, write_table

COLUMNS = ["system", "sample_time", "copy_time", "extract_time",
           "train_time", "epoch_time", "epoch_time_l2"]
STAGES = ("sample_time", "copy_time", "extract_time", "train_time")


def rows(args):
    """``(tag, app arguments, extra environment)`` of each row."""
    base = [
        "--device", args.device, "--model", args.model,
        "--dataset", args.dataset,
        "--synthetic-nodes", str(args.synthetic_nodes),
        "--num-epoch", str(args.num_epoch),
        "--batch-size", str(args.batch_size),
        "--fanout", "5", "10", "15",
    ]
    cache = ["--cache-policy", "pre_sample",
             "--cache-percentage", str(args.cache_percentage)]
    host_feat = {"FGNN_TPU_FEAT_HBM_BUDGET": "0"}
    return [
        ("host-sample", base + ["--arch", "arch0"], {}),
        ("host-sample+cache", base + ["--arch", "arch0"] + cache, {}),
        ("dev-sample", base + ["--arch", "arch1"], host_feat),
        ("dev-sample+cache", base + ["--arch", "arch1"] + cache, host_feat),
        ("dev-sample+hbm-feat", base + ["--arch", "arch1"], {}),
    ]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--synthetic-nodes", type=int, default=200_000)
    p.add_argument("--num-epoch", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=8000)
    p.add_argument("--model", default="graphsage")
    p.add_argument("--cache-percentage", type=float, default=0.2)
    p.add_argument("--out-dir", default=os.path.join("chiprun_out", "table1"))
    args = p.parse_args(argv)

    log_dir = os.path.join(args.out_dir, "run-logs")

    def row(tag, app_args, env):
        print(f"[table1] {tag}", flush=True)
        r = run_app(app_args + ["--profile-level", "1"], log_dir,
                    tag + "-l1", env=env)
        r2 = run_app(app_args + ["--profile-level", "2"], log_dir,
                     tag + "-l2", env=env)
        for k in STAGES:
            if k in r2.values:
                r.values[k] = r2.values[k]
        r.values["epoch_time_l2"] = r2.values.get("epoch_time", "")
        r.returncode = r.returncode or r2.returncode
        r.config["system"] = tag
        return r

    results = [row(*a) for a in rows(args)]

    meta = card_meta()
    write_table(results, COLUMNS, os.path.join(args.out_dir, "table1.dat"),
                meta=meta)
    write_json(results, os.path.join(args.out_dir, "table1.json"), meta=meta)
    for r in results:
        print("[table1] " + "\t".join(
            [r.config["system"]] + [r.values.get(c, "X") for c in COLUMNS[1:]])
            + f"\trc={r.returncode}", flush=True)
    return int(any(r.returncode for r in results))


if __name__ == "__main__":
    sys.exit(main())
