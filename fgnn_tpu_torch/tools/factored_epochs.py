"""Epochs of the multi-device engines on one card, in a process of its own.

    python -m fgnn_tpu_torch.tools.factored_epochs [--device cuda:0]

``chip_smoke.py``'s main-path configuration (GraphSAGE [25, 10] khop2,
batch 8000, hidden 256, bf16, dropout 0.5, lr 0.003 on the 1M-node
synthetic graph: degree 15, 128-dim features, 172 classes, train 25%, seed
0), with every role on ``--device``:

1. arch5, ``FactoredEngine`` S=1, T=1, the table on the trainer: 3 epochs;
2. arch5 cache mode (PRESAMPLE 10%: the table in host memory), S=1, T=1:
   2 epochs pipelined and 2 synchronous, and whether the two agree bit for
   bit in losses and parameters;
3. arch6, ``SGNNEngine`` W=1 and W=2: 2 epochs each;
4. one more arch5 epoch under torch.profiler (CPU and CUDA activity) for
   the card's busy seconds: the union of its kernel and copy intervals.
   They are given over the profiled epoch's wall time and over the last
   unprofiled arch5 epoch's: the profiler slows the host's launch path, so
   the first share reads low. It runs last, because a profiler session
   slows the later epochs of its process (``tools/profiler_residue.py``).

Each epoch's loss, time (the engine's host clock, which ends in a sync),
sampled edges and edges/s; each run's peak device memory and row-gather
launches. Prints one JSON line, with the card's name and power limit, as
its last line. Without a CUDA device it exits 1.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def bench_config(**kw):
    """The main path's configuration (bench.py), for the multi-device
    engines."""
    from ..config import RunConfig, SampleType

    return RunConfig(model="graphsage", fanout=(25, 10), batch_size=8000,
                     num_hidden=256, sample_type=SampleType.KHOP2,
                     dropout=0.5, lr=0.003, compute_dtype="bfloat16", **kw)


def bench_dataset():
    """The main path's 1M-node synthetic graph, built from seed 0."""
    from ..data import make_synthetic_dataset

    return make_synthetic_dataset(num_node=1_000_000, avg_degree=15,
                                  feat_dim=128, num_class=172,
                                  train_frac=0.25, seed=0)


def busy_share(device: torch.device, fn) -> dict:
    """Run ``fn`` under torch.profiler: its wall seconds, the union of the
    card's kernel and copy intervals in seconds, their share of the wall
    time, and the top kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_s": wall, "busy_s": busy / 1e6,
            "busy_share": busy / 1e6 / wall,
            "top_kernels_ms": [(k, v / 1e3) for k, v in top]}


def run_epochs(eng, epochs, device, **meta) -> dict:
    """``epochs`` epochs of ``eng``: each one's dict with edges/s, the
    peak memory and the row-gather launches over them."""
    from ..ops import cuda_lib

    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    cuda_lib.reset_launches()
    out = []
    for e in epochs:
        r = eng.run_epoch(e)
        r["edges_per_s"] = r["sampled_edges"] / r["epoch_time"]
        out.append(r)
    return {"epochs": out, "overflowed": eng.last_overflowed,
            "peak_bytes": torch.cuda.max_memory_allocated(device),
            "launches": dict(cuda_lib.launches), **meta}


def main(argv=None) -> int:
    p = argparse.ArgumentParser("factored_epochs")
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("factored_epochs: no CUDA device", file=sys.stderr)
        return 1
    from ..config import CachePolicy
    from ..parallel.factored import FactoredEngine, SGNNEngine
    from .gather_campaign import card_name

    dev = torch.device(args.device)
    card = card_name()
    t0 = time.perf_counter()
    ds = bench_dataset()
    print(f"dataset: {ds.num_node} nodes, {ds.num_edge} edges "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    base = bench_config()
    runs = {}

    def engine(cls, cfg, n):
        t = time.perf_counter()
        eng = cls(cfg, ds, [dev] * n)
        return eng, time.perf_counter() - t

    arch5, init_s = engine(FactoredEngine, base, 2)
    runs["arch5"] = run_epochs(arch5, range(3), dev, init_s=init_s,
                               num_step=arch5.num_step)
    cache_cfg = base.replace(cache_policy=CachePolicy.PRESAMPLE,
                             cache_percentage=0.1)
    cached = {}
    for name, pipeline in (("pipelined", True), ("synchronous", False)):
        eng, init_s = engine(FactoredEngine, cache_cfg.replace(
            pipeline=pipeline), 2)
        r = run_epochs(eng, range(2), dev, init_s=init_s,
                       num_step=eng.num_step)
        for x in r["epochs"]:
            x["hit_rate"] = 1.0 - x["miss_bytes"] / x["feature_bytes"]
        runs[f"arch5_cache_{name}"] = r
        cached[name] = eng
    a, b = cached["pipelined"], cached["synchronous"]
    runs["arch5_cache_bit_equal"] = (
        [x["loss"] for x in runs["arch5_cache_pipelined"]["epochs"]]
        == [x["loss"] for x in runs["arch5_cache_synchronous"]["epochs"]]
        and all(torch.equal(p, q) for p, q in zip(a.model.parameters(),
                                                  b.model.parameters())))
    del a, b, cached
    for W in (1, 2):
        eng, init_s = engine(SGNNEngine, base.replace(num_train_worker=W), W)
        runs[f"arch6_w{W}"] = run_epochs(eng, range(2), dev, init_s=init_s,
                                         num_step=eng.num_step)
        del eng
    busy = busy_share(dev, lambda: arch5.run_epoch(3))
    busy["unprofiled_epoch_s"] = runs["arch5"]["epochs"][-1]["epoch_time"]
    busy["busy_share_unprofiled"] = busy["busy_s"] / busy["unprofiled_epoch_s"]
    runs["arch5_busy"] = busy
    print(json.dumps({"card": card, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
