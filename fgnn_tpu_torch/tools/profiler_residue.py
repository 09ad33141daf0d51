"""Do epochs run slower in a process after a torch.profiler session?

    python -m fgnn_tpu_torch.tools.profiler_residue [--epochs 2] [app arguments]

``chip_smoke.py`` times whole epochs in one long process, after phases that
ran epochs under torch.profiler, and its epochs of the app's configuration
came out slower than the app's own process gives. This tool repeats the
question in a fresh process: the app's configuration (by default the
smoke's: GraphSAGE arch1 [25, 10], batch 8000, hidden 256, 1M synthetic
nodes, train 25%; later arguments win) through OneChipEngine, a warm-up
epoch, then ``--epochs`` timed epochs (``run_epoch``'s host clock, one sync
an epoch) before any profiler, after one epoch under a CPU-only
torch.profiler session, and after one under a CPU and CUDA session. Each
set's times are printed beside the card's name and power limit. Without a
CUDA device it exits 1.
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..engine import OneChipEngine
from ..examples import common_config
from .gather_campaign import card_name

APP_ARGS = ["--arch", "arch1", "--model", "graphsage", "--fanout", "25", "10",
            "--batch-size", "8000", "--num-hidden", "256",
            "--synthetic-nodes", "1000000", "--synthetic-train-frac", "0.25"]


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("profiler_residue: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    p = argparse.ArgumentParser("profiler_residue")
    p.add_argument("--model", default="graphsage")
    p.add_argument("--epochs", type=int, default=2)
    common_config.add_common_arguments(p)
    args = p.parse_args(APP_ARGS + list(sys.argv[1:] if argv is None
                                        else argv))
    card = card_name()
    cfg = common_config.build_run_config(
        args, args.model, common_config.MODEL_SAMPLE_TYPE[args.model])
    eng = OneChipEngine(cfg, common_config.load_app_dataset(args),
                        torch.device("cuda"))
    epoch = iter(range(1 << 30))
    eng.run_epoch(next(epoch))   # warm-up
    for label, activities in (
            ("before any profiler", None),
            ("after a CPU-only torch.profiler epoch", [ProfilerActivity.CPU]),
            ("after a CPU and CUDA torch.profiler epoch",
             [ProfilerActivity.CPU, ProfilerActivity.CUDA])):
        if activities is not None:
            with profile(activities=activities):
                eng.run_epoch(next(epoch))
        times = [eng.run_epoch(next(epoch))["epoch_time"]
                 for _ in range(args.epochs)]
        print(f"{label}: epochs " + " / ".join(f"{t:.4f}" for t in times)
              + f" s, mean {sum(times) / len(times):.4f} s ({card})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
