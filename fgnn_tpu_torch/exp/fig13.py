"""Figure 13, the pipeline on and off (port of ``exp/fig13/run.py``):

    python -m fgnn_tpu_torch.exp.fig13 [--out-dir DIR]

The source paper's exp/fig13 runs the cached arch5 apps with and without
the pipeline (dist_loops_arch5.cc's PIPELINE). Both paths that overlap the
host gather of step (group) k + 1 with the training of k run with and
without it, the table in host memory behind a PRESAMPLE 20% cache,
GraphSAGE [5, 10, 15]: arch1 (``OneChipEngine``'s pipelined cache epoch) and
arch5 2S+6T (``FactoredEngine``'s group pipeline; its devices repeat the
machine's cards, ``--devices``). The pipeline changes when work runs, not
what it computes, so a pipelined epoch is the shorter one at the same stage
sums. Then a traced arch1 run (profile level 3, two epochs) whose Chrome
trace's lanes are summed into ``fig13_lanes.dat``. The tables
(``fig13.dat``, ``fig13.json``, the card and host in their header), the
trace and the logs go to ``--out-dir``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from .runner import card_meta, run_app, worker_devices, write_json, write_table
from ..utils.profiler import TRACE_ITEMS

COLUMNS = ["case", "epoch_time", "epoch_time:min"]
HOST_FEAT = {"FGNN_TPU_FEAT_HBM_BUDGET": "0"}


def base_args(args):
    return [
        "--model", args.model, "--dataset", args.dataset,
        "--synthetic-nodes", str(args.synthetic_nodes),
        "--num-epoch", str(args.num_epoch),
        "--batch-size", str(args.batch_size),
        "--fanout", "5", "10", "15",
        "--cache-policy", "pre_sample",
        "--cache-percentage", str(args.cache_percentage),
    ]


def rows(args):
    """``(tag, app arguments, extra environment, row labels)`` of each
    row."""
    one = ["--device", args.device]
    eight = one + ["--devices", worker_devices(args.device, args.devices, 8)]
    arch5 = ["--arch", "arch5", "--num-sample-worker", "2",
             "--num-train-worker", "6"]
    return [(tag, dev + base_args(args) + extra, dict(HOST_FEAT),
             {"case": tag}) for tag, dev, extra in (
        ("arch1-nopipe", one, ["--arch", "arch1", "--no-pipeline"]),
        ("arch1-pipe", one, ["--arch", "arch1"]),
        ("arch5-nopipe", eight, arch5 + ["--no-pipeline"]),
        ("arch5-pipe", eight, arch5))]


def trace_row(args, trace_path: str):
    """The traced arch1 run: (tag, app arguments, extra environment)."""
    return ("arch1-trace",
            ["--device", args.device] + base_args(args)
            + ["--arch", "arch1", "--no-pipeline", "--profile-level", "3",
               "--num-epoch", "2"],
            dict(HOST_FEAT, FGNN_TPU_DUMP_TRACE="1",
                 FGNN_TPU_TRACE_PATH=trace_path))


def write_lanes(trace_path: str, path: str) -> int:
    """Each of the 19 lanes' event count, total and mean; returns the
    events read."""
    with open(trace_path) as f:
        ev = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    lanes = {}
    for e in ev:
        s = lanes.setdefault(e["name"], [0, 0.0])
        s[0] += 1
        s[1] += e["dur"] / 1e6
    with open(path, "w") as f:
        f.write("lane\tcount\ttotal_s\tmean_ms\n")
        for name in TRACE_ITEMS:
            c, tot = lanes.get(name, [0, 0.0])
            f.write(f"{name}\t{c}\t{tot:.4f}\t{tot / c * 1e3 if c else 0.0:.3f}"
                    "\n")
    return len(ev)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--devices", default=None,
                   help="the cards arch5's rows take in turn (default: all)")
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--synthetic-nodes", type=int, default=200_000)
    p.add_argument("--num-epoch", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=8000)
    p.add_argument("--model", default="graphsage")
    p.add_argument("--cache-percentage", type=float, default=0.2)
    p.add_argument("--out-dir", default=os.path.join("chiprun_out", "fig13"))
    args = p.parse_args(argv)

    log_dir = os.path.join(args.out_dir, "run-logs")
    results = []
    for tag, app_args, env, labels in rows(args):
        print(f"[fig13] {tag}", flush=True)
        r = run_app(app_args, log_dir, tag, env=env)
        r.config.update(labels)
        results.append(r)
    meta = card_meta()
    write_table(results, COLUMNS, os.path.join(args.out_dir, "fig13.dat"),
                meta=meta)
    write_json(results, os.path.join(args.out_dir, "fig13.json"), meta=meta)

    trace_path = os.path.abspath(os.path.join(args.out_dir,
                                              "fig13_trace.json"))
    tag, app_args, env = trace_row(args, trace_path)
    print("[fig13] traced run (19-lane timeline)", flush=True)
    tr = run_app(app_args, log_dir, tag, env=env)
    if tr.returncode == 0:
        n = write_lanes(trace_path,
                        os.path.join(args.out_dir, "fig13_lanes.dat"))
        print(f"[fig13] lanes -> fig13_lanes.dat ({n} events)", flush=True)

    by = {r.config["case"]: r for r in results}
    for arch in ("arch1", "arch5"):
        try:
            off = float(by[f"{arch}-nopipe"].values["epoch_time"])
            on = float(by[f"{arch}-pipe"].values["epoch_time"])
            print(f"[fig13] {arch}: pipeline {off:.3f}s -> {on:.3f}s "
                  f"({off / max(on, 1e-9):.2f}x)", flush=True)
        except (KeyError, ValueError):
            pass
    return int(any(r.returncode for r in results) or tr.returncode)


if __name__ == "__main__":
    sys.exit(main())
