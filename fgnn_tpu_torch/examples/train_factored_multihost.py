"""arch5 with a process per role (port of
``examples/train_factored_multihost.py``).

Ranks ``[0, --num-sampler-hosts)`` sample on their devices, the others
train, the waves crossing between processes
(``parallel.factored_multihost.MultihostFactoredEngine``; the source
system's per-GPU sampler and trainer processes, dist_engine.cc:231-465).

Launch one process a rank:

  FGNN_TPU_COORDINATOR=127.0.0.1:29777 FGNN_TPU_NUM_PROCESSES=2 \\
  FGNN_TPU_PROCESS_ID=<i> python -m \\
  fgnn_tpu_torch.examples.train_factored_multihost [--smoke]

Each process takes ``--devices`` (comma-separated, its own role devices;
one slot or logical trainer each), by default ``cuda:<rank mod visible
cards>``; ``--smoke`` runs on the CPU. Every process prints
``test_result:grad_route`` (``nccl``, ``host``, or ``None`` with one
trainer process); trainers print ``test_result:``
``epoch<i>_loss`` and ``epoch<i>_acc`` (8 decimals) and ``param_checksum``;
``--save-params DIR`` writes the first trainer's parameters to
``DIR/params.pt``.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Sequence

import numpy as np
import torch

from ..config import CachePolicy, RunConfig, SampleType
from ..data import make_synthetic_dataset
from ..parallel import multihost as mh
from ..utils.logging import log_test_result


def app_config(args) -> RunConfig:
    """The reference app's configuration (its roles come from the
    processes, not from the worker counts)."""
    return RunConfig(
        model="graphsage", fanout=(4, 4), batch_size=args.batch_size,
        num_hidden=args.num_hidden, sample_type=SampleType.KHOP0,
        dropout=args.dropout, lr=0.01, num_sample_worker=1, num_train_worker=1,
        cache_policy=(CachePolicy.PRESAMPLE if args.cache_percentage > 0
                      else CachePolicy.DEGREE),
        cache_percentage=args.cache_percentage, presample_epoch=1)


def app_dataset(num_node: int):
    return make_synthetic_dataset(num_node=num_node, avg_degree=10,
                                  feat_dim=32, num_class=8, seed=5)


def main(argv: Sequence[str] = None) -> int:
    p = argparse.ArgumentParser("fgnn_tpu_torch arch5, a process per role")
    p.add_argument("--smoke", action="store_true",
                   help="the CPU (the multi-process runs of the tests)")
    p.add_argument("--devices", default=None,
                   help="this process's role devices, comma-separated "
                        "(default cuda:<rank mod visible cards>)")
    p.add_argument("--synthetic-nodes", type=int, default=20_000)
    p.add_argument("--num-epoch", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--num-hidden", type=int, default=32)
    p.add_argument("--num-sampler-hosts", type=int, default=1)
    p.add_argument("--cache-percentage", type=float, default=0.0)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--save-params", default=None)
    args = p.parse_args(argv)

    if not mh.initialize_from_env():
        print("train_factored_multihost: set FGNN_TPU_COORDINATOR / "
              "FGNN_TPU_NUM_PROCESSES / FGNN_TPU_PROCESS_ID", file=sys.stderr)
        return 2
    if args.devices:
        devices = args.devices.split(",")
    elif args.smoke:
        devices = ["cpu"]
    elif torch.cuda.is_available():
        devices = [mh.default_device()]
    else:
        print("train_factored_multihost: no CUDA device; pass --smoke (or "
              "--devices cpu) to run on the CPU", file=sys.stderr)
        return 1

    from ..parallel.factored_multihost import MultihostFactoredEngine

    eng = MultihostFactoredEngine(
        app_config(args), app_dataset(args.synthetic_nodes),
        num_sampler_hosts=args.num_sampler_hosts, devices=devices)
    log_test_result("grad_route", str(eng.grad_route))
    for epoch in range(args.num_epoch):
        r = eng.run_epoch(epoch)
        print(f"proc {eng.proc} ({r['role']}) epoch {epoch}: "
              f"loss={r['loss']:.6f} time={r['epoch_time']:.2f}s", flush=True)
        if r["role"] == "trainer":
            log_test_result(f"epoch{epoch}_loss", f"{r['loss']:.8f}")
            log_test_result(f"epoch{epoch}_acc", f"{r['acc']:.8f}")
    if not eng.is_sampler_host:
        checksum = float(np.sum([float(x.detach().abs().sum())
                                 for x in eng.model.parameters()]))
        log_test_result("param_checksum", f"{checksum:.6f}")
        if args.save_params and eng.proc == eng.first_trainer:
            os.makedirs(args.save_params, exist_ok=True)
            torch.save({k: v.cpu() for k, v in eng.model.state_dict().items()},
                       os.path.join(args.save_params, "params.pt"))
    mh.barrier("factored-done")
    print(f"proc {eng.proc} done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
