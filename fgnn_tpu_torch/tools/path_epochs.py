"""Epoch times of the main path and of the host-table paths that run
without the pipeline, for an A/B of two checkouts on one card.

    python fgnn_tpu_torch/tools/path_epochs.py [--epochs N] [--label L]

``chip_smoke.py`` phase 5's and phase 15's configuration: GraphSAGE [25, 10]
khop2, batch 8000, hidden 256, bf16, dropout 0.5, lr 0.003 on the 1M-node
synthetic graph (degree 15, 128-dim features, 172 classes, train 25%, seed
0), with the feature table on the card, then in host memory
(``feat_budget=0``) with PRESAMPLE 10% synchronous (``pipeline=False``) and
with no cache. Each engine runs a warm-up epoch, then
``--epochs`` timed epochs (``run_epoch``'s host clock, one sync an epoch).
It uses only the engine API that every version of the package with host
tables has, so ``PYTHONPATH=<another checkout>`` times that checkout's
package with the same script. Without a CUDA device it exits 1.
"""
from __future__ import annotations

import argparse
import subprocess
import sys

import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser("path_epochs")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--label", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("path_epochs: no CUDA device", file=sys.stderr)
        return 1
    from fgnn_tpu_torch.config import CachePolicy, RunConfig, SampleType
    from fgnn_tpu_torch.data import make_synthetic_dataset
    from fgnn_tpu_torch.engine import OneChipEngine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    ds = make_synthetic_dataset(num_node=1_000_000, avg_degree=15,
                                feat_dim=128, num_class=172, train_frac=0.25,
                                seed=0)
    base = RunConfig(model="graphsage", fanout=(25, 10), batch_size=8000,
                     num_hidden=256, sample_type=SampleType.KHOP2,
                     dropout=0.5, lr=0.003, compute_dtype="bfloat16")
    for name, kw, budget in (
            ("table on the card", {}, None),
            ("PRESAMPLE 10% synchronous",
             dict(cache_policy=CachePolicy.PRESAMPLE, cache_percentage=0.1,
                  pipeline=False), 0),
            ("no cache", {}, 0)):
        eng = OneChipEngine(base.replace(**kw), ds, torch.device("cuda"),
                            feat_budget=budget)
        eng.run_epoch(0)   # warm-up
        times = [eng.run_epoch(e)["epoch_time"]
                 for e in range(1, args.epochs + 1)]
        print(f"{args.label} {name}: epochs "
              + " / ".join(f"{t:.4f}" for t in times)
              + f" s, mean {sum(times) / len(times):.4f} s ({card})",
              flush=True)
        del eng
    return 0


if __name__ == "__main__":
    sys.exit(main())
