"""arch5 with a process per role, beside arch5 in one process.

    python -m fgnn_tpu_torch.tools.multiprocess_epochs \\
        [--devices cuda:0,cuda:0] [--epochs 3] [--deterministic-epochs 1]

The main path's configuration (GraphSAGE [25, 10] khop2, batch 8000, hidden
256, bf16, dropout 0.5, lr 0.003 on the 1M-node synthetic graph: degree 15,
128-dim features, 172 classes, train 25%, seed 0; each process builds it
from the seed) through ``MultihostFactoredEngine``: one sampler process and
one trainer process a further entry of ``--devices`` (the sampler's device
first, then each trainer process's; all on ``cuda:0`` by default, so
``--devices cuda:0,cuda:1,cuda:2`` is S = 1 with T = 2 processes on cards 1
and 2, and ``cuda:0,cuda:0,cuda:0,cuda:0`` puts three trainer processes on
one card). Each process prints a JSON line: its epochs (time, loss,
sampled edges and edges/s), the bytes its broadcasts moved and the seconds
it waited on them, a lone broadcast of one wave's bytes timed after the
epochs, its peak device memory, its row-gather launches and the route its
gradients took (``grad_route``: ``nccl``, card to card, where each trainer
process has a card of its own; ``host``, through host memory, where they
share one; null with one trainer process). Then the same epochs through
the single-process ``FactoredEngine`` on the same devices in this process,
and whether the two agree bit for bit in losses and parameters.
``--deterministic-epochs K`` runs the first K epochs of both under
deterministic algorithms (the gradients' scatter-adds use atomics
otherwise, and the bits may move) and compares the parameters after those
K epochs too: on the H100 such an epoch takes about nine times as long, so
K = 1 makes epoch 0 comparable bit for bit and leaves the later epochs'
times as users see them. Prints one JSON line,
with the card's name and power limit and the host's CPU, as its last line.
Every child has a timeout and is killed when a peer fails. Without a CUDA
device (and devices that name one) it exits 1.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from .factored_epochs import bench_config, bench_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# broadcasts of one wave's bytes timed after the epochs (their median)
PROBE_BROADCASTS = 10
# seconds a role process and each of its collectives may take
TIMEOUT_S = 600
# the first trainer's parameters after the deterministic epochs
DETERMINISTIC_PARAMS = "params_multiprocess_deterministic.pt"


def deterministic(args, epoch: int) -> None:
    """Deterministic algorithms for epochs before ``--deterministic-epochs``.
    The first call imports for seconds: make it before the timed work."""
    torch.use_deterministic_algorithms(epoch < args.deterministic_epochs)


def child(args) -> int:
    """One role's process: the engine's epochs, then a lone broadcast of a
    wave's bytes; one JSON line."""
    import torch.distributed as dist

    from ..ops import cuda_lib
    from ..parallel import multihost as mh
    from ..parallel.factored_multihost import MultihostFactoredEngine

    deterministic(args, 0)
    mh.initialize_from_env()
    rank = dist.get_rank()
    dev = torch.device(args.devices.split(",")[rank])
    ds = bench_dataset()
    t = time.perf_counter()
    eng = MultihostFactoredEngine(bench_config(), ds, devices=[dev])
    init_s = time.perf_counter() - t
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cuda_lib.reset_launches()
    epochs = []
    for e in range(args.epochs):
        deterministic(args, e)
        r = eng.run_epoch(e)
        r["edges_per_s"] = r["sampled_edges"] / r["epoch_time"]
        epochs.append(r)
        if (e + 1 == args.deterministic_epochs and args.out_dir
                and rank == eng.first_trainer):
            torch.save([p.detach().cpu() for p in eng.model.parameters()],
                       os.path.join(args.out_dir, DETERMINISTIC_PARAMS))
    launches = dict(cuda_lib.launches)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    buf = mh.host_buffer(eng.codec.nbytes, dev.type == "cuda")
    times = []
    for _ in range(PROBE_BROADCASTS):
        dist.barrier()
        t = time.perf_counter()
        dist.broadcast(buf, src=0)
        times.append(time.perf_counter() - t)
    if args.out_dir and rank == eng.first_trainer:
        torch.save([p.detach().cpu() for p in eng.model.parameters()],
                   os.path.join(args.out_dir, "params_multiprocess.pt"))
    times.sort()
    print(json.dumps({
        "rank": rank, "role": "sampler" if eng.is_sampler_host else "trainer",
        "device": str(dev), "init_s": init_s, "epochs": epochs,
        "batch_bytes": eng.codec.nbytes, "num_waves": eng.num_waves,
        "probe_broadcast_s": times[len(times) // 2],
        "peak_bytes": peak, "launches": launches,
        "grad_route": eng.grad_route,
        "groups": sum(-(-x["num_step"] // eng.T) for x in epochs)}),
        flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def launch(args, devices) -> list:
    """Start every role's process together; wait for each with a timeout,
    killing the others when one fails."""
    from ..parallel import multihost as mh

    cmd = [sys.executable, "-m", "fgnn_tpu_torch.tools.multiprocess_epochs",
           "--child", "--devices", ",".join(devices), "--epochs",
           str(args.epochs), "--out-dir",
           args.out_dir, "--deterministic-epochs",
           str(args.deterministic_epochs)]
    env = {"FGNN_TPU_DIST_TIMEOUT": str(TIMEOUT_S),
           "PYTHONPYCACHEPREFIX": os.path.join(ROOT, "fgnn_tpu_torch",
                                               "_build", "pycache"),
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = mh.start_ranks([cmd] * len(devices), env=env, cwd=ROOT)
    out = mh.wait_ranks(procs, TIMEOUT_S)
    for i, (rc, text) in enumerate(out):
        if rc != 0:
            raise RuntimeError(f"rank {i} exited {rc}:\n{text[-4000:]}")
    return [json.loads(text.strip().splitlines()[-1]) for _, text in out]


def single(args, devices):
    """The same epochs through FactoredEngine on the same devices, here."""
    from ..ops import cuda_lib
    from ..parallel.factored import FactoredEngine

    deterministic(args, 0)
    devs = [torch.device(d) for d in devices]
    ds = bench_dataset()
    t = time.perf_counter()
    eng = FactoredEngine(bench_config(num_train_worker=len(devs) - 1), ds,
                         devs)
    init_s = time.perf_counter() - t
    for d in set(devs):
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)
    cuda_lib.reset_launches()
    epochs, det_params = [], None
    for e in range(args.epochs):
        deterministic(args, e)
        r = eng.run_epoch(e)
        r["edges_per_s"] = r["sampled_edges"] / r["epoch_time"]
        epochs.append(r)
        if e + 1 == args.deterministic_epochs:
            det_params = [p.detach().cpu().clone()
                          for p in eng.model.parameters()]
    params = [p.detach().cpu() for p in eng.model.parameters()]
    peak = {str(d): torch.cuda.max_memory_allocated(d)
            for d in set(devs) if d.type == "cuda"}
    return {"init_s": init_s, "epochs": epochs, "peak_bytes": peak,
            "launches": dict(cuda_lib.launches)}, params, det_params


def main(argv=None) -> int:
    p = argparse.ArgumentParser("multiprocess_epochs")
    p.add_argument("--devices", default="cuda:0,cuda:0",
                   help="the sampler process's device, then one a trainer "
                        "process")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--deterministic-epochs", type=int, default=0)
    p.add_argument("--out-dir", default=os.path.join(
        ROOT, "chiprun_out", "multiprocess_epochs"))
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        return child(args)
    devices = args.devices.split(",")
    if len(devices) < 2:
        print("multiprocess_epochs: --devices names the sampler's device and "
              "at least one trainer's", file=sys.stderr)
        return 2
    if any(d.startswith("cuda") for d in devices) and not (
            torch.cuda.is_available()):
        print("multiprocess_epochs: no CUDA device", file=sys.stderr)
        return 1
    from ..exp.runner import card_meta

    os.makedirs(args.out_dir, exist_ok=True)
    # the children read and write the bytecode cache (PYTHONPYCACHEPREFIX);
    # cuBLAS reads its workspace setting when this process first uses it
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    if args.deterministic_epochs:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t = time.perf_counter()
    multi = launch(args, devices)
    multi_s = time.perf_counter() - t
    one, params, det_params = single(args, devices)
    mp = torch.load(os.path.join(args.out_dir, "params_multiprocess.pt"))
    trainer = next(r for r in multi if r["role"] == "trainer")
    losses_m = [x["loss"] for x in trainer["epochs"]]
    losses_s = [x["loss"] for x in one["epochs"]]
    k = args.deterministic_epochs
    det_equal = None
    if det_params is not None:
        det_equal = same_params(torch.load(
            os.path.join(args.out_dir, DETERMINISTIC_PARAMS)), det_params)
    print(json.dumps({
        **card_meta(), "devices": devices,
        "grad_route": trainer["grad_route"],
        "deterministic_epochs": k,
        "multi_wall_s": multi_s, "multi": multi, "single": one,
        "epoch0_loss_equal": losses_m[0] == losses_s[0],
        "deterministic_params_equal": det_equal,
        "losses_equal": losses_m == losses_s,
        "params_equal": same_params(mp, params)}), flush=True)
    return 0


def same_params(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


if __name__ == "__main__":
    sys.exit(main())
