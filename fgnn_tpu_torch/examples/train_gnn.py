"""Generic training app, every model (port of ``examples/train_gnn.py``).

    python -m fgnn_tpu_torch.examples.train_gnn --arch arch1 --model graphsage \\
        --fanout 25 10 --synthetic-nodes 1000000 [--device cpu]

One process: arch0 is ``HostSamplingEngine``, arch1-4 and 7
``OneChipEngine``, arch5 ``FactoredEngine`` (``SwitcherEngine`` with
``--have-switcher``, ``AsyncFactoredEngine`` with ``--async-train``) and
arch6 ``SGNNEngine`` (examples/train_gnn.py:50-67). It runs on the CUDA
device unless ``--device cpu`` asks for the CPU; without a card it exits
non-zero. arch5 and arch6 run on ``--devices`` (comma-separated, samplers
first; a device may repeat: ``cuda:0,cuda:0`` puts both roles on one card),
by default the first S + T (arch6: W) devices of ``--device``; with fewer
cards than that and no ``--devices`` the app exits non-zero naming both
counts, and never drops to fewer roles.

Prints the reference's lines: ``config:<k>=<v>`` for the run configuration,
``Epoch ... | Time ... | Loss ... | Acc ...`` an epoch, and
``test_result:<k>=<v>`` (train_gcn.py:411-412 format) for the init time,
the steady epoch time (epoch 0 is the warm-up), the stage columns, every
L2/L3 step item written, the cache's hit rate and miss volume and the init
items. Beyond the reference's keys: ``first_epoch_loss`` at six decimals,
and ``launches:<kernel>``, each hand-written kernel's launches over the run.
``FGNN_TPU_LOG_NODE_ACCESS`` writes ``node_ranking.bin`` and
``node_access.json``, ``FGNN_TPU_DUMP_TRACE`` a Chrome trace to
``$FGNN_TPU_TRACE_PATH`` (``trace.json`` by default), both in the working
directory.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..config import RunArch
from ..ops import cuda_lib
from ..parallel.mesh import role_devices
from ..session import build_engine
from ..utils.logging import log_test_result
from ..utils.profiler import STEP_ITEMS, Profiler
from .common_config import (MODEL_SAMPLE_TYPE, add_common_arguments,
                            build_run_config, load_app_dataset,
                            print_run_config)


def report(prof: Profiler, num_node: int) -> None:
    """The run's ``test_result:`` lines after the epochs."""
    log_test_result("num_step", str(prof.num_step))
    # stage columns: per-epoch seconds (reference table5 convention);
    # non-zero when --profile-level >= 2 wrote epoch stage items, else
    # approximated from per-step L1 items where those were recorded
    for col, epoch_item, l1_item in (
        ("sample_time", "epoch_sample_time", "L1_sample_time"),
        ("copy_time", "epoch_copy_time", "L1_copy_time"),
        ("extract_time", "epoch_extract_time", None),
        ("train_time", "epoch_train_time", "L1_train_time"),
    ):
        v = prof.epoch_average(epoch_item)
        if v == 0.0 and l1_item is not None:
            v = prof.step_average(l1_item) * prof.num_step
        log_test_result(col, f"{v:.4f}")
    # per-stage / per-kernel items recorded at profile_level >= 2/3
    # (report_step_average L2/L3 analog, operation.cc:284-300)
    for item in STEP_ITEMS:
        if not item.startswith("L1") and prof.has_step_item(item):
            log_test_result(item, f"{prof.step_average(item):.6f}")
    fb = prof.epoch_average("epoch_feature_bytes")
    mb = prof.epoch_average("epoch_miss_bytes")
    if fb > 0:
        log_test_result("cache_hit_rate", f"{1.0 - mb / fb:.4f}")
        # staged miss volume per epoch (kLogEpochMissBytes analog)
        log_test_result("miss_mb", f"{mb / 2**20:.2f}")
    if prof.log_node_access:
        prof.report_node_access("node", num_node)
    for key, item in (("init:presample", "init_presample"),
                      ("init:load_dataset", "init_load_dataset"),
                      ("init:copy", "init_copy"),
                      ("init:build_cache", "init_build_cache")):
        log_test_result(key, f"{prof.get_init_value(item):.4f}")
    cuda_lib.log_launches()
    if prof.trace_enabled:
        # samgraph_dump_trace analog (SAMGRAPH_DUMP_TRACE flow)
        prof.dump_trace(os.environ.get("FGNN_TPU_TRACE_PATH", "trace.json"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser("fgnn_tpu_torch training app")
    p.add_argument("--model", default="graphsage",
                   choices=list(MODEL_SAMPLE_TYPE))
    add_common_arguments(p)
    args = p.parse_args(argv)

    cfg = build_run_config(args, args.model, MODEL_SAMPLE_TYPE[args.model])
    print_run_config(cfg)
    if args.validate_configs:
        return 0
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("train_gnn: no CUDA device (torch.cuda.is_available() is "
              "False); pass --device cpu to run on the CPU", file=sys.stderr)
        return 1
    if cfg.arch in (RunArch.ARCH5, RunArch.ARCH6):
        try:
            device = role_devices(cfg, args.devices.split(",")
                                  if args.devices else args.device)
        except ValueError as e:
            print(f"train_gnn: {e}", file=sys.stderr)
            return 2
        log_test_result("devices", ",".join(str(d) for d in device))

    ds = load_app_dataset(args)
    t_init = time.time()
    eng = build_engine(cfg, ds, device)
    log_test_result("init_time", f"{time.time() - t_init:.4f}")

    epoch_times, losses = [], []
    for e in range(cfg.num_epoch):
        stats = eng.run_epoch(e)
        epoch_times.append(stats["epoch_time"])
        losses.append(stats["loss"])
        print(
            f"Epoch {e:05d} | Time {stats['epoch_time']:.4f} | "
            f"Loss {stats['loss']:.4f} | Acc {stats['acc']:.4f}", flush=True
        )
        # arch0 has no evaluate, as in the reference
        if (args.report_acc and (e + 1) % args.report_acc == 0
                and hasattr(eng, "evaluate")):
            log_test_result("test_acc", f"{eng.evaluate():.4f}")

    # reference convention: epoch 0 is warm-up (common_config.py:162-163)
    steady = epoch_times[1:] or epoch_times
    log_test_result("epoch_time", f"{np.mean(steady):.4f}")
    log_test_result("epoch_time:min", f"{np.min(steady):.4f}")
    log_test_result("first_epoch_loss", f"{losses[0]:.6f}")
    report(Profiler.get(), ds.num_node)
    return 0


if __name__ == "__main__":
    sys.exit(main())
