"""One-command sweep suites (port of ``exp/auto_runner.py``; the source
system's example/auto_runner):

    python -m fgnn_tpu_torch.exp.auto_runner <suite> [--synthetic-nodes N]
        [--device cuda] [--devices cuda:0,...] [--out-dir DIR]
    python -m fgnn_tpu_torch.exp.auto_runner --list

Each suite returns ``(tag, extra app arguments, extra environment)`` rows
over the port's app (``python -m fgnn_tpu_torch.examples.train_gnn``),
the rows of the source system's LogTable configs (run_samgraph.py,
run_sgnn.py) that a paper table needs; every row runs through
:func:`.runner.run_app` into ``<suite>.dat`` and ``<suite>.json`` (the card
and host in the header) under ``--out-dir`` (default
``chiprun_out/auto/<suite>``). The rows and their arguments are the
reference's; rows on arch5 and arch6 name their role devices (``--devices``)
with :func:`.runner.worker_devices`, which repeats cards where there are
fewer than workers (``scalability`` needs 8, ``arch_matrix`` 4).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from .runner import card_meta, run_app, worker_devices, write_json, write_table

MODELS = ["gcn", "graphsage", "pinsage"]


def _model_args(model):
    if model == "pinsage":
        return ["--model", "pinsage", "--sample-type", "random_walk"]
    return ["--model", model]


def suite_breakdown(args):
    """per-stage Sample/Copy/Train split for every app (run_samgraph.py
    breakdown_test: one device, arch1, profile level 2)."""
    rows = []
    for m in MODELS:
        rows.append((m, _model_args(m) + ["--arch", "arch1",
                                          "--profile-level", "2"], {}))
    cols = ["model", "sample_time", "copy_time", "extract_time",
            "train_time", "epoch_time"]
    return rows, cols


def suite_cache(args):
    """hit rate and epoch time against the cache size (run_sgnn.py
    overall_perf): presample, the feature table in host memory."""
    rows = []
    for pct in (0.0, 0.1, 0.2, 0.3):
        extra = ["--arch", "arch1", "--model", "graphsage",
                 "--profile-level", "1"]
        if pct > 0:
            extra += ["--cache-policy", "pre_sample",
                      "--cache-percentage", str(pct)]
        rows.append((f"cache{int(pct * 100):02d}", extra,
                     {"FGNN_TPU_FEAT_HBM_BUDGET": "0"}))
    cols = ["cache_percentage", "cache_hit_rate", "epoch_time"]
    return rows, cols


def suite_scalability(args):
    """sampler:trainer ratio on arch5 (run_samgraph.py scalability_test,
    table5-shaped)."""
    rows = []
    for s, t in ((1, 7), (2, 6), (3, 5), (4, 4)):
        rows.append((
            f"{s}S_{t}T",
            ["--arch", "arch5", "--model", "graphsage",
             "--num-sample-worker", str(s), "--num-train-worker", str(t),
             "--profile-level", "2",
             "--devices", worker_devices(args.device, args.devices, s + t)],
            {},
        ))
    cols = ["num_sample_worker", "num_train_worker", "sample_time",
            "train_time", "epoch_time"]
    return rows, cols


def suite_arch_matrix(args):
    """every arch with GraphSAGE, one configuration: a smoke and relative
    times."""
    rows = []
    for arch in ("arch0", "arch1", "arch2", "arch5", "arch6"):
        extra = ["--arch", arch, "--model", "graphsage"]
        env = {}
        if arch == "arch2":
            extra += ["--cache-policy", "pre_sample",
                      "--cache-percentage", "0.2"]
            env = {"FGNN_TPU_FEAT_HBM_BUDGET": "0"}
        if arch in ("arch5", "arch6"):
            extra += ["--num-sample-worker", "2", "--num-train-worker", "2",
                      "--devices", worker_devices(args.device, args.devices,
                                                  4 if arch == "arch5" else 2)]
        rows.append((arch, extra, env))
    cols = ["arch", "epoch_time", "init_time"]
    return rows, cols


SUITES = {
    "breakdown": suite_breakdown,
    "cache": suite_cache,
    "scalability": suite_scalability,
    "arch_matrix": suite_arch_matrix,
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("suite", nargs="?", choices=sorted(SUITES))
    p.add_argument("--list", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--devices", default=None,
                   help="the cards arch5/arch6 rows take in turn "
                        "(default: all)")
    p.add_argument("--synthetic-nodes", type=int, default=200_000)
    p.add_argument("--num-epoch", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=8000)
    p.add_argument("--out-dir", default=None,
                   help="default chiprun_out/auto/<suite>")
    args = p.parse_args(argv)
    if args.list or not args.suite:
        for k, fn in sorted(SUITES.items()):
            print(f"{k:14s} {fn.__doc__.splitlines()[0]}")
        return 0

    t_start = time.perf_counter()
    rows, cols = SUITES[args.suite](args)
    base = [
        "--device", args.device, "--dataset", "synthetic",
        "--synthetic-nodes", str(args.synthetic_nodes),
        "--num-epoch", str(args.num_epoch),
        "--batch-size", str(args.batch_size),
        "--fanout", "5", "10", "15",
    ]
    out_dir = args.out_dir or os.path.join("chiprun_out", "auto", args.suite)
    results = []
    for tag, extra, extra_env in rows:
        print(f"[auto:{args.suite}] {tag}", flush=True)
        r = run_app(base + extra, os.path.join(out_dir, "run-logs"), tag,
                    env=extra_env)
        for c in cols:  # expose config:<c> under the bare column name
            r.config.setdefault(c, r.config.get(f"config:{c}", tag))
        results.append(r)
    meta = card_meta()
    write_table(results, cols, os.path.join(out_dir, f"{args.suite}.dat"),
                meta=meta)
    write_json(results, os.path.join(out_dir, f"{args.suite}.json"),
               meta=meta)
    print(f"[auto:{args.suite}] wrote {out_dir}/{args.suite}.dat; wall "
          f"{time.perf_counter() - t_start:.1f} s")
    return int(any(r.returncode for r in results))


if __name__ == "__main__":
    sys.exit(main())
