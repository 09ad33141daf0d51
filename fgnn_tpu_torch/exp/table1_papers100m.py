"""Table 1 at papers100M scale on the card (port of
``exp/table1/run_papers100m.py``):

    python -m fgnn_tpu_torch.exp.table1_papers100m [--rows hbm cache ...]
        [--model graphsage|gcn|pinsage] [--cache-dir DIR] [--out-dir DIR]

The rows of exp/table1/run.py's motivation ablation, on the
papers100M-shaped synthetic graph (111,059,956 nodes, lognormal(3)
targets, the 1M-row mock feature table) that ``python -m
fgnn_tpu_torch.tools.papers100m_rehearsal --gen-only`` saves under the same
``--cache-dir``:

  host-sample          arch0: host sampling, host extract
  dev-sample           arch1 with the table in host memory, every row a miss
                       (``--dev-train-frac`` bounds its steps)
  dev-sample+cache     arch1, host table + a PRESAMPLE cache (10%, the source
                       paper's papers100M operating point)
  dev-sample+hbm-feat  arch1 with the mock table on the card

Each row runs twice, each time in a process of its own: the headline epoch
time at profile level 1, then the stage split at level 2, whose stage syncs
cost time (``epoch_time_l2``). A fresh process per row and pass hands the
previous one's device memory back. Earlier rows of the table are kept only
where their parameters equal this call's. The table
(``table1_papers100m.dat``, ``.json``, the card and host in its header) goes
to ``--out-dir``. The defaults are the reference's. Each row's process
prints the row gather's launches over its passes
(``test_result:launches:gather_rows=N``), as the apps do.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from ..tools.papers100m_rehearsal import DEFAULT_CACHE_DIR, load_cached, stamp
from .runner import card_meta

ROWS = ["host", "dev", "cache", "hbm"]
ROW_LABEL = {
    "host": "host-sample",
    "dev": "dev-sample",
    "cache": "dev-sample+cache",
    "hbm": "dev-sample+hbm-feat",
}
COLUMNS = ["system", "model", "sample_time", "copy_time", "extract_time",
           "train_time", "epoch_time", "epoch_time_l2", "cache_hit_rate",
           "init_time"]
NOTE = ("sample/copy/extract/train columns come from a SEPARATE "
        "force-synced profile-level-2 pass whose epoch wall-clock is "
        "epoch_time_l2; per-stage syncs serialize the pipeline, so those "
        "columns sum to epoch_time_l2, NOT to the headline epoch_time "
        "(async/pipelined pass).")
MODULE = "fgnn_tpu_torch.exp.table1_papers100m"


def load_p100m(cache_dir: str, num_node: int, train_frac: float,
               seed: int = 0):
    """The saved papers100M-shaped dataset, mmapped, with its split for
    ``train_frac`` (exp/table1/run_papers100m.py:62-89)."""
    d = os.path.join(cache_dir, stamp(num_node, seed=seed))
    if not os.path.exists(os.path.join(d, "indices.npy")):
        raise FileNotFoundError(
            f"dataset cache missing at {d}; run python -m "
            "fgnn_tpu_torch.tools.papers100m_rehearsal --gen-only "
            f"--num-node {num_node} --cache-dir {cache_dir} first")
    return load_cached(d, num_node, train_frac, seed)


def run_row(row: str, ds, args) -> dict:
    """One row's passes (``args.phase``): its table columns."""
    import numpy as np
    import torch

    from ..config import CachePolicy, RunArch, RunConfig, SampleType
    from ..ops import cuda_lib
    from ..utils.profiler import Profiler

    def build(profile_level):
        Profiler.reset()
        st = {"gcn": SampleType.KHOP2, "graphsage": SampleType.KHOP2,
              "pinsage": SampleType.RANDOM_WALK}[args.model]
        kw = dict(
            model=args.model, fanout=tuple(args.fanout),
            batch_size=args.batch_size,
            num_hidden=256, sample_type=st, dropout=0.5,
            lr=0.003, profile_level=profile_level,
            # the stage pass takes the synchronous path: the pipelined
            # epoch overlaps its stages, so their spans would not add up
            pipeline=profile_level < 2,
        )
        if args.model == "pinsage":
            kw.update(num_layer_rw=2, num_random_walk=4,
                      random_walk_length=3, num_neighbor=5)
            kw.pop("fanout", None)
        if row == "host":
            kw["arch"] = RunArch.ARCH0
            os.environ["FGNN_TPU_FEAT_HBM_BUDGET"] = "0"
        elif row == "dev":
            os.environ["FGNN_TPU_FEAT_HBM_BUDGET"] = "0"
        elif row == "cache":
            os.environ["FGNN_TPU_FEAT_HBM_BUDGET"] = "0"
            kw.update(cache_policy=CachePolicy.PRESAMPLE,
                      cache_percentage=args.cache_percentage,
                      presample_epoch=1)
        else:  # hbm: the 1M-row mock table fits the card
            os.environ.pop("FGNN_TPU_FEAT_HBM_BUDGET", None)
        cfg = RunConfig(**kw)
        if row == "host":
            from ..host_engine import HostSamplingEngine

            return HostSamplingEngine(cfg, ds, args.device), cfg
        from ..engine import OneChipEngine

        return OneChipEngine(cfg, ds, args.device), cfg

    out = {"system": ROW_LABEL[row], "model": args.model}
    phase = getattr(args, "phase", "both")
    if phase in ("both", "headline"):
        # pass 1: the headline epoch time at level 1
        t0 = time.perf_counter()
        eng, cfg = build(1)
        out["init_time"] = round(time.perf_counter() - t0, 1)
        times = []
        for e in range(args.num_epoch):
            r = eng.run_epoch(e)
            print(f"[{row}] epoch {e}: {r['epoch_time']:.2f}s "
                  f"loss={r['loss']:.3f} edges={r.get('sampled_edges')}",
                  flush=True)
            if e > 0:
                times.append(r["epoch_time"])
        out["epoch_time"] = round(
            float(np.median(times or [r["epoch_time"]])), 3)
        prof = Profiler.get()
        fb = prof.epoch_average("epoch_feature_bytes")
        mb = prof.epoch_average("epoch_miss_bytes")
        if fb:
            out["cache_hit_rate"] = round(1.0 - mb / fb, 4)
        del eng

    # pass 2: the stage split at level 2 (a sync per stage)
    if phase in ("both", "stages") and not args.skip_stages:
        try:
            eng, cfg = build(2)
            for e in range(min(2, args.num_epoch)):
                eng.run_epoch(e)
            prof = Profiler.get()
            for col, item in (("sample_time", "epoch_sample_time"),
                              ("copy_time", "epoch_copy_time"),
                              ("extract_time", "epoch_extract_time"),
                              ("train_time", "epoch_train_time")):
                out[col] = round(prof.epoch_average(item), 3)
            out["epoch_time_l2"] = round(
                prof.epoch_average("epoch_total_time"), 3)
            del eng
        except torch.cuda.OutOfMemoryError:
            # the level-2 engine may not fit beside what the process still
            # holds; any other failure propagates and fails the phase
            print(f"[{row}] stage pass OOM; keeping headline columns",
                  flush=True)
    cuda_lib.log_launches()
    return out


def child_argv(args) -> list:
    """The arguments every row's process gets, before its ``--rows`` and
    ``--phase`` (exp/table1/run_papers100m.py:235-246)."""
    return [sys.executable, "-m", MODULE,
            "--device", args.device,
            "--cache-dir", args.cache_dir,
            "--model", args.model,
            "--fanout", *[str(f) for f in args.fanout],
            "--batch-size", str(args.batch_size),
            "--num-node", str(args.num_node),
            "--num-epoch", str(args.num_epoch),
            "--cache-percentage", str(args.cache_percentage),
            "--train-frac", str(args.train_frac),
            "--dev-train-frac", str(args.dev_train_frac),
            "--out-dir", args.out_dir]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--cache-dir", default=DEFAULT_CACHE_DIR)
    p.add_argument("--model", default="graphsage",
                   choices=["graphsage", "gcn", "pinsage"],
                   help="gcn [5, 10, 15] is the source paper's Table 1 "
                        "workload (exp/table1/README.md:95-104)")
    p.add_argument("--fanout", nargs="+", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=8000)
    p.add_argument("--out-dir",
                   default=os.path.join("chiprun_out", "table1_papers100m"))
    p.add_argument("--num-node", type=int, default=111_059_956)
    p.add_argument("--num-epoch", type=int, default=3)
    p.add_argument("--cache-percentage", type=float, default=0.10)
    p.add_argument("--train-frac", type=float, default=0.01)
    p.add_argument("--dev-train-frac", type=float, default=0.0005,
                   help="the train fraction of the host and dev rows, whose "
                        "every feature row crosses from the host")
    p.add_argument("--rows", nargs="+", default=["hbm", "cache", "dev",
                                                 "host"], choices=ROWS)
    p.add_argument("--skip-stages", action="store_true")
    p.add_argument("--phase", choices=["both", "headline", "stages"],
                   default="both",
                   help="one pass of each row; with more than one row each "
                        "row's passes run as processes of their own")
    args = p.parse_args(argv)
    if args.fanout is None:
        args.fanout = [5, 10, 15] if args.model == "gcn" else [25, 10]

    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("table1_papers100m: no CUDA device (torch.cuda.is_available() "
              "is False); pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 1

    out_json = os.path.join(args.out_dir, "table1_papers100m.json")
    if len(args.rows) > 1:
        base = child_argv(args)
        phases = (["headline"] if args.skip_stages
                  else ["headline", "stages"])
        failed = []
        for row in args.rows:
            for phase in phases:
                r = subprocess.run(base + ["--rows", row, "--phase", phase])
                if r.returncode != 0:
                    print(f"[table1-p100m] row {row} phase {phase} "
                          f"FAILED rc={r.returncode}", flush=True)
                    failed.append((row, phase))
        if failed:
            print(f"[table1-p100m] {len(failed)} child run(s) failed: "
                  f"{failed}", flush=True)
            return 1
        return 0

    # merge with the rows of earlier calls whose parameters equal this
    # call's: a row from another --num-node or --cache-percentage must not
    # stand under a header that names this call's scale
    prior = {}
    if os.path.exists(out_json):
        try:
            with open(out_json) as f:
                prior = {(r["system"], r.get("model", "graphsage")): r
                         for r in json.load(f).get("results", [])}
        except (OSError, ValueError, KeyError, TypeError, AttributeError):
            pass
    for row in args.rows:
        frac = (args.dev_train_frac if row in ("dev", "host")
                else args.train_frac)
        params = {"num_node": args.num_node, "train_frac": frac,
                  "model": args.model, "batch_size": args.batch_size}
        if row == "cache":
            params["cache_percentage"] = args.cache_percentage
        old = dict(prior.get((ROW_LABEL[row], args.model), {}))
        if any(old.get(k) != v for k, v in params.items()):
            if old:
                print(f"[table1-p100m] dropping stale prior row "
                      f"{ROW_LABEL[row]} (params changed)", flush=True)
            old = {}
        ds = load_p100m(args.cache_dir, args.num_node, frac)
        print(f"[table1-p100m] row {row} (train_frac {frac}, "
              f"phase {args.phase})", flush=True)
        merged = old
        merged.update(run_row(row, ds, args))
        merged.update(params)
        prior[(ROW_LABEL[row], args.model)] = merged
    results = [prior[k] for r in ROWS for m in ("graphsage", "gcn", "pinsage")
               for k in [(ROW_LABEL[r], m)] if k in prior]

    meta = dict(card_meta())
    meta["dataset"] = (f"papers100M-shape synthetic {args.num_node} nodes "
                       "(generated from a seed, no download)")
    os.makedirs(args.out_dir, exist_ok=True)
    with open(out_json[:-5] + ".dat", "w") as f:
        for k, v in meta.items():
            f.write(f"# {k}={v}\n")
        f.write(f"# NOTE: {NOTE}\n")
        f.write("\t".join(COLUMNS) + "\n")
        for r in results:
            f.write("\t".join(str(r.get(c, "X")) for c in COLUMNS) + "\n")
    with open(out_json, "w") as f:
        json.dump({"meta": meta, "results": results}, f, indent=2)
    print(f"[table1-p100m] wrote {out_json[:-5]}.dat/.json", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
