"""Table 6, presample's init cost is small (port of ``exp/table6/run.py``):

    python -m fgnn_tpu_torch.exp.table6 [--repeats N] [--out-dir DIR]

The source paper's exp/table6 (readme.md:1-60) splits engine init into
stages to show that presampling adds little to startup. The columns are
the init timers the app prints: the dataset load, the copy to the card,
the cache build (the host gather and upload of the hot rows) and the
presample epochs, beside the hit rate and the steady epoch they buy. Each
row runs the port's app on arch1 with the feature table in host memory
(``FGNN_TPU_FEAT_HBM_BUDGET=0``), GCN [5, 10, 15], batch 2000, 20% cache,
1M nodes at skew 6, pref 0.5, profile level 1: presample (1 and 2 epochs),
degree, random. With ``--repeats N`` each row runs N times and every init
and epoch-time column is the minimum over them. The rows and their
arguments are the reference's. The table (``table6.dat``, ``table6.json``,
the card and host in its header) and the logs go to ``--out-dir``.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from .runner import card_meta, run_app, write_json, write_table

COLUMNS = ["policy", "init:load_dataset", "init:copy", "init:build_cache",
           "init:presample", "init_time", "cache_hit_rate", "epoch_time",
           "epoch_time:min"]
ROWS = (
    ("pre_sample", ["--presample-epoch", "1"]),
    ("pre_sample_x2", ["--cache-policy", "pre_sample",
                       "--presample-epoch", "2"]),
    ("degree", []),
    ("random", []),
)


def min_over_repeats(reps):
    """The first run with each init and epoch-time column replaced by its
    minimum over ``reps``."""
    r = reps[0]
    for k in list(r.values):
        if k.startswith("init") or k.startswith("epoch_time"):
            try:
                r.values[k] = (f"{min(float(x.values[k]) for x in reps if k in x.values):.4f}")
            except (ValueError, TypeError):
                pass
    return r


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--synthetic-nodes", type=int, default=1_000_000)
    p.add_argument("--num-epoch", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=2000)
    p.add_argument("--cache-percentage", type=float, default=0.2)
    p.add_argument("--repeats", type=int, default=1,
                   help="run each row N times; every init and epoch-time "
                        "column is the minimum over them")
    p.add_argument("--out-dir", default=os.path.join("chiprun_out", "table6"))
    args = p.parse_args(argv)
    t_start = time.perf_counter()

    env = {"FGNN_TPU_FEAT_HBM_BUDGET": "0"}
    base = [
        "--device", args.device, "--model", "gcn", "--arch", "arch1",
        "--dataset", "synthetic",
        "--synthetic-nodes", str(args.synthetic_nodes),
        "--num-epoch", str(args.num_epoch),
        "--batch-size", str(args.batch_size),
        "--fanout", "5", "10", "15",
        "--synthetic-skew", "6", "--synthetic-pref", "0.5",
        "--cache-percentage", str(args.cache_percentage),
        "--profile-level", "1",
    ]
    results = []
    for policy, extra in ROWS:
        cp = "pre_sample" if policy.startswith("pre_sample") else policy
        reps = []
        for i in range(max(1, args.repeats)):
            print(f"[table6] {policy} (rep {i + 1}/{args.repeats})",
                  flush=True)
            tag = policy if args.repeats == 1 else f"{policy}_rep{i}"
            reps.append(run_app(base + ["--cache-policy", cp] + extra,
                                os.path.join(args.out_dir, "run-logs"), tag,
                                env=env))
        r = min_over_repeats(reps)
        r.returncode = max(x.returncode for x in reps)
        r.config["policy"] = policy
        r.config["repeats"] = args.repeats
        results.append(r)

    meta = card_meta()
    write_table(results, COLUMNS, os.path.join(args.out_dir, "table6.dat"),
                meta=meta)
    write_json(results, os.path.join(args.out_dir, "table6.json"), meta=meta)
    print(f"[table6] wall {time.perf_counter() - t_start:.1f} s", flush=True)
    return int(any(r.returncode for r in results))


if __name__ == "__main__":
    sys.exit(main())
