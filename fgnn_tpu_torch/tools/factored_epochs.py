"""Epochs of the multi-device engines, in a process of its own.

    python -m fgnn_tpu_torch.tools.factored_epochs [--device cuda:0]
    python -m fgnn_tpu_torch.tools.factored_epochs \\
        --devices cuda:0,cuda:1,cuda:2,cuda:3

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

With ``--devices`` (four role devices, samplers first; a device may
repeat) it runs every layout of :data:`LAYOUTS` instead, 3 epochs each at
the same configuration:
``arch5_s2t2`` (S=2, T=2), ``arch6_w4``, ``switcher_forced`` and
``switcher`` (S=1, T=3, the tail forced with ``FGNN_TPU_SWITCHER_FORCE=1``
or left to the calibration, which runs once before the epochs),
``arch5_cache_s1t3`` (PRESAMPLE 25%, the table in host memory behind each
trainer's cache) and ``async_t3`` (the async trainers, S=1, T=3). Each
run also gives its K1 launches per step against the count its schedule
implies (:func:`expected_launches`), whether every epoch's loss is finite
and the last below the first, each card's peak memory and its seconds.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Dict, List, NamedTuple, Tuple

import torch

from ..config import CachePolicy, env_set


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


def profiled(devices, fn):
    """Run ``fn`` under torch.profiler (CPU and CUDA activity), every card
    of ``devices`` synced before and after: ``(wall seconds, profile)``."""
    from torch.profiler import ProfilerActivity, profile

    for d in devices:
        torch.cuda.synchronize(d)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        for d in devices:
            torch.cuda.synchronize(d)
        wall = time.perf_counter() - t0
    return wall, prof


def device_events(events):
    """The card's kernels, copies and sets among profiler events: CUDA
    events, without the ranges that ``record_function`` mirrors onto the
    card's timeline (``Optimizer.step#Adam.step``), which span idle time."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def merged_intervals(events):
    """The union of the events' time ranges (µs), as sorted disjoint
    ``[start, end]`` pairs."""
    out = []
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_share(device: torch.device, fn) -> dict:
    """Run ``fn`` under torch.profiler: its wall seconds, the union of the
    card's kernel and copy intervals in seconds, their share of the wall
    time, and the top kernels by device time."""
    wall, prof = profiled([device], fn)
    events = device_events(prof.events())
    busy = sum(b - a for a, b in merged_intervals(events))
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_s": wall, "busy_s": busy / 1e6,
            "busy_share": busy / 1e6 / wall,
            "top_kernels_ms": [(k, v / 1e3) for k, v in top]}


def train_epochs(eng, epochs) -> Tuple[List[dict], bool]:
    """``eng``'s ``epochs``: each one's dict, and whether any overflowed
    its caps."""
    out, overflowed = [], False
    for e in epochs:
        out.append(eng.run_epoch(e))
        overflowed |= bool(eng.last_overflowed)
    return out, overflowed


def run_epochs(eng, epochs, devices, **meta) -> dict:
    """``epochs`` epochs of ``eng`` on ``devices`` (one or a list): each
    one's dict with edges/s, whether any overflowed, the peak memory (the
    largest card's, and each card's) and the row-gather launches over
    them."""
    from ..ops import cuda_lib

    cards = sorted({torch.device(d) for d in (
        devices if isinstance(devices, (list, tuple)) else [devices])
        if torch.device(d).type == "cuda"}, key=str)
    for d in cards:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    cuda_lib.reset_launches()
    out, overflowed = train_epochs(eng, epochs)
    for r in out:
        r["edges_per_s"] = r["sampled_edges"] / r["epoch_time"]
    peaks = {str(d): torch.cuda.max_memory_allocated(d) for d in cards}
    return {"epochs": out, "overflowed": overflowed,
            "peak_bytes": max(peaks.values(), default=0),
            "peak_bytes_by_card": peaks,
            "launches": dict(cuda_lib.launches), **meta}


# K1 launches a trained batch: arch5 dedups every hop, so its feature
# gather and both layers' gather_src gather; arch6's last hop is a slice
ARCH5_LAUNCHES_PER_BATCH = 3
ARCH6_LAUNCHES_PER_BATCH = 2


class Layout(NamedTuple):
    """A multi-device run: its engine, configuration, the roles it takes
    of the four devices given, and the environment it runs under."""
    engine: str
    cfg: Dict
    samplers: int
    trainers: int
    kwargs: Dict = {}
    env: Dict = {}


LAYOUTS = {
    "arch5_s2t2": Layout("FactoredEngine", {}, 2, 2),
    "arch6_w4": Layout("SGNNEngine", {}, 0, 4),
    "switcher_forced": Layout("SwitcherEngine", {"have_switcher": True}, 1,
                              3, env={"FGNN_TPU_SWITCHER_FORCE": "1"}),
    "switcher": Layout("SwitcherEngine", {"have_switcher": True}, 1, 3),
    "arch5_cache_s1t3": Layout("FactoredEngine", {
        "cache_policy": CachePolicy.PRESAMPLE, "cache_percentage": 0.25}, 1, 3,
        kwargs={"feat_on_trainer": False}),
    "async_t3": Layout("AsyncFactoredEngine", {"async_train": True}, 1, 3),
}


def trained_slots(num_step: int, T: int, W: int = 0, reserve: int = 0) -> int:
    """The replica slots an arch5 epoch trains, pads included: groups of T
    (the last padded), or with the switcher's ``reserve`` engaged, T-wide
    groups while fewer than ``num_step - reserve`` batches are trained and
    whole groups are left, then the rest in groups of W."""
    if not reserve:
        return -(-num_step // T) * T
    main = min(-(-(num_step - reserve) // T), num_step // T)
    tail = num_step - main * T
    return main * T + -(-tail // W) * W


def expected_launches(name: str, eng, epochs: int) -> int:
    """K1's launches over ``epochs`` epochs of layout ``name``, from its
    schedule: 3 a trained arch5 slot, 2 an arch6 batch (padding steps
    included: each worker gathers every local step)."""
    lay = LAYOUTS[name]
    if lay.engine == "SGNNEngine":
        return ARCH6_LAUNCHES_PER_BATCH * eng.num_step * epochs
    reserve = getattr(eng, "_tail_reserve_batches", None) or 0
    W = getattr(eng, "num_full", 0)
    return (ARCH5_LAUNCHES_PER_BATCH * epochs
            * trained_slots(eng.num_step, lay.trainers, W, reserve))


def run_layout(name: str, devices: List[torch.device], ds,
               epochs: int = 3) -> dict:
    """Layout ``name`` on ``devices``: engine init (and the switcher's
    calibration) timed apart from its epochs."""
    from ..parallel import async_dp, factored, switcher

    lay = LAYOUTS[name]
    cls = {"FactoredEngine": factored.FactoredEngine,
           "SGNNEngine": factored.SGNNEngine,
           "SwitcherEngine": switcher.SwitcherEngine,
           "AsyncFactoredEngine": async_dp.AsyncFactoredEngine}[lay.engine]
    cfg = bench_config(num_sample_worker=max(1, lay.samplers),
                       num_train_worker=lay.trainers, **lay.cfg)
    roles = devices[:lay.samplers + lay.trainers]
    t0 = time.perf_counter()
    with env_set(lay.env):
        t = time.perf_counter()
        eng = cls(cfg, ds, roles, **lay.kwargs)
        init_s = time.perf_counter() - t
        meta = {"role_devices": [str(d) for d in roles], "init_s": init_s,
                "num_step": eng.num_step}
        if lay.engine == "SwitcherEngine":
            t = time.perf_counter()
            eng._tail_reserve_batches = eng._calibrate_tail_reserve()
            meta.update(calibrate_s=time.perf_counter() - t,
                        reserve=eng._tail_reserve_batches)
        r = run_epochs(eng, range(epochs), roles, **meta)
    if lay.engine == "SwitcherEngine":
        r["tail_batches"] = getattr(eng, "tail_batches", 0)
    if "miss_bytes" in r["epochs"][0]:
        for x in r["epochs"]:
            x["hit_rate"] = 1.0 - x["miss_bytes"] / x["feature_bytes"]
    losses = [x["loss"] for x in r["epochs"]]
    launches = r["launches"].get("gather_rows", 0)
    expected = expected_launches(name, eng, epochs)
    r.update(seconds=time.perf_counter() - t0,
             losses_finite=all(math.isfinite(x) for x in losses),
             losses_fall=losses[-1] < losses[0],
             k1_launches=launches, k1_expected=expected,
             k1_per_step=launches / (eng.num_step * epochs))
    r["ok"] = bool(r["losses_finite"] and r["losses_fall"]
                   and not r["overflowed"] and launches == expected)
    del eng
    torch.cuda.empty_cache()
    return r


def layouts_main(args, card: str) -> int:
    """The ``--devices`` mode: every layout, one JSON line."""
    devices = [torch.device(d) for d in args.devices.split(",")]
    if len(devices) < 4:
        print("factored_epochs: --devices names four role devices",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    ds = bench_dataset()
    print(f"dataset: {ds.num_node} nodes, {ds.num_edge} edges "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    runs = {}
    for name in LAYOUTS:
        r = runs[name] = run_layout(name, devices, ds)
        print(f"{name}: {'ok' if r['ok'] else 'FAILED'}, epochs "
              + " / ".join(f"{x['epoch_time']:.4f}" for x in r["epochs"])
              + " s, losses " + " / ".join(f"{x['loss']:.4f}"
                                           for x in r["epochs"])
              + f", overflow {r['overflowed']}, K1 {r['k1_launches']} "
              f"(expected {r['k1_expected']}, {r['k1_per_step']:g} a step), "
              f"peak GiB " + ", ".join(
                  f"{d} {b / 2**30:.3f}"
                  for d, b in r["peak_bytes_by_card"].items())
              + f", {r['seconds']:.1f} s", flush=True)
    print(json.dumps({"card": card, "devices": [str(d) for d in devices],
                      "layouts": runs}), flush=True)
    return 0 if all(r["ok"] for r in runs.values()) else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser("factored_epochs")
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--devices", default=None,
                   help="four role devices, comma-separated: run the "
                        "layouts instead")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("factored_epochs: no CUDA device", file=sys.stderr)
        return 1
    from ..parallel.factored import FactoredEngine, SGNNEngine
    from .gather_campaign import card_name

    if args.devices:
        return layouts_main(args, card_name())
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
