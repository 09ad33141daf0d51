"""Data-parallel training across processes (port of
``examples/train_multihost.py``).

The cross-process form of the SGNN loop: every process samples its slots of
the identically shuffled train set on the host (``np_multi_layer_sample``,
``default_rng(seed + rank)``), trains them on its devices, and the slots'
gradients cross by one ``all_gather`` a wave and are summed in logical slot
order on every process (``multihost.gather_images``, ``apply_images``), so
every process takes the same Adam step and the replicas stay bit-identical.
The images cross card to card over NCCL where every process owns its card,
else through host memory over gloo (``multihost.grad_route``; printed as
``test_result:grad_route``). Rank 0 also ranks
the nodes by a presample epoch and broadcasts the ranking (the shared-mmap
ranking, dist_engine.cc:115-127).

Launch one process a rank:

  FGNN_TPU_COORDINATOR=127.0.0.1:29777 FGNN_TPU_NUM_PROCESSES=2 \\
  FGNN_TPU_PROCESS_ID=<i> python -m fgnn_tpu_torch.examples.train_multihost \\
  [--smoke]

Each process trains one slot of a wave on ``--device``, by default
``cuda:<rank mod visible cards>``; ``--smoke`` runs on the CPU. Prints the
reference's ``test_result:`` keys: ``ranking_checksum``, ``epoch<i>_loss``
and ``param_checksum``, and the port's ``grad_route``. ``--save-params
DIR`` writes this rank's parameters to ``DIR/params_rank<i>.pt``.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Sequence

import numpy as np
import torch

from ..config import RunConfig, SampleType
from ..data import make_synthetic_dataset
from ..host_engine import np_multi_layer_sample
from ..models.gnn import build_model
from ..ops.extract import device_gather, label_gather
from ..ops.padding import make_plan
from ..ops.reference_impl import calibrate_caps
from ..parallel import multihost as mh
from ..parallel.factored import step_generator, to_device
from ..parallel.shuffler import DistShuffler
from ..train.loop import make_optimizer, masked_cross_entropy
from ..utils.logging import log_test_result

# the dropout keys' stream: the reference's seed * 7 + epoch * 100003 + step
DROPOUT_SEED_FACTOR = 7
EPOCH_STRIDE = 100003


def demo_setup(num_node: int, batch_size: int = 128, num_hidden: int = 32):
    """The demo's configuration, dataset and plan, as the reference builds
    them (every process builds the same)."""
    cfg = RunConfig(model="graphsage", fanout=(4, 4), batch_size=batch_size,
                    num_hidden=num_hidden, sample_type=SampleType.KHOP0,
                    dropout=0.0, lr=0.01)
    ds = make_synthetic_dataset(num_node=num_node, avg_degree=10, feat_dim=32,
                                num_class=8, seed=5)
    caps = calibrate_caps(np.asarray(ds.indptr), np.asarray(ds.indices),
                          np.asarray(ds.train_set), cfg.batch_size,
                          list(reversed(cfg.fanout)), num_probe=2,
                          seed=cfg.seed)
    plan = make_plan(cfg.batch_size, list(cfg.fanout), ds.num_node,
                     unique_caps=caps)
    return cfg, ds, plan


def demo_shuffler(cfg, ds, plan) -> DistShuffler:
    return DistShuffler(np.asarray(ds.train_set), cfg.batch_size,
                        plan.num_input_cap[0], 0, 1, base_seed=cfg.seed)


def host0_ranking(cfg, ds, plan, rng: np.random.Generator) -> np.ndarray:
    """Rank 0's presample: one epoch of host sampling with ``rng``, the
    nodes ranked by access count, stable (int32)."""
    indptr, indices = np.asarray(ds.indptr), np.asarray(ds.indices)
    freq = np.zeros(ds.num_node, np.int64)
    for seeds, n, _ in demo_shuffler(cfg, ds, plan).batches(0):
        b = np_multi_layer_sample(rng, indptr, indices, seeds, n, plan)
        ids = b.input_nodes.numpy()
        np.add.at(freq, ids[ids >= 0], 1)
    return np.argsort(-freq, kind="stable").astype(np.int32)


def wave_slots(perm: np.ndarray, wave: int, first: int, count: int,
               width: int, batch_size: int, seed_cap: int):
    """Global slots ``first .. first + count - 1`` of a wave of ``width``:
    slot j takes global step ``wave * width + j`` of the permutation.
    Returns (global step, -1-padded seeds, count) of each."""
    out = []
    for j in range(first, first + count):
        gstep = wave * width + j
        lo = gstep * batch_size
        seeds = np.full(seed_cap, -1, np.int32)
        n = max(0, min(batch_size, len(perm) - lo))
        if n > 0:
            seeds[:n] = perm[lo:lo + n]
        out.append((gstep, seeds, n))
    return out


def local_wave(cfg, ds, plan, rng, slots, device: torch.device):
    """Sample each slot on the host with ``rng`` (in slot order) and move
    the batch to ``device``."""
    indptr, indices = np.asarray(ds.indptr), np.asarray(ds.indices)
    return [(gstep, n, to_device(np_multi_layer_sample(
        rng, indptr, indices, seeds, n, plan), device))
        for gstep, seeds, n in slots]


def wave_weight(perm_len: int, wave: int, width: int, batch_size: int):
    """sum(w_i) over the wave's global slots, w_i = (slot i has seeds), at
    least 1: known to every process from the shared permutation."""
    real = sum(1 for j in range(width)
               if (wave * width + j) * batch_size < perm_len)
    return float(max(real, 1))


def slot_image(model, batch, n: int, feats, labels, wsum: float, dst_caps,
               batch_size: int, generator, codec_box: list) -> torch.Tensor:
    """One slot's gradient image: its term l w / sum(w) backed out through
    ``model`` alone, packed with its weighted loss and accuracy."""
    model.zero_grad(set_to_none=True)
    model.train()
    logits = model(batch, feats, dst_caps, generator=generator)
    l, a = masked_cross_entropy(logits[:batch_size], labels[:batch_size])
    w = float(n > 0)
    (l * w / wsum).backward()
    image = mh.grad_image(list(model.parameters()), l.detach() * w, a * w)
    if not codec_box:
        codec_box.append(mh.ByteCodec(mh.skeleton(image)))
    return codec_box[0].pack(image)


def train_step(model, optimizer, images: torch.Tensor, codec,
               wsum: float, device: torch.device) -> float:
    """Sum the wave's images (every slot's, in logical order, in host
    memory or on a card) into the model's gradients and take one Adam
    step; returns the wave's loss."""
    loss, _ = mh.apply_images(model, images, codec, device)
    optimizer.step()
    return float(loss) / wsum


class Demo:
    """The demo's per-process state: model, optimizer, features and labels
    on the process's device."""

    def __init__(self, cfg, ds, plan, device: torch.device):
        self.cfg, self.ds, self.plan, self.device = cfg, ds, plan, device
        self.dst_caps = tuple(reversed(plan.num_input_cap))
        self.model = build_model(
            cfg.model, ds.feat_dim, cfg.num_hidden, ds.num_class,
            plan.num_layer, cfg.dropout,
            generator=torch.Generator().manual_seed(cfg.seed + 1)).to(device)
        self.optimizer = make_optimizer(self.model.parameters(), cfg.lr)
        self.feat = torch.as_tensor(np.asarray(ds.feat), device=device)
        self.label = torch.as_tensor(np.asarray(ds.label).astype(np.int64),
                                     device=device)
        self.codec_box: list = []

    def images(self, epoch: int, wave, wsum: float) -> List[torch.Tensor]:
        """The gradient images of this process's slots of a wave, each
        packed on the device."""
        out = []
        for gstep, n, batch in wave:
            gen = step_generator(self.device,
                                 self.cfg.seed * DROPOUT_SEED_FACTOR,
                                 epoch * EPOCH_STRIDE + gstep)
            feats = device_gather(self.feat, batch.input_nodes)
            labels = label_gather(self.label, batch.output_nodes)
            out.append(slot_image(self.model, batch, n, feats, labels, wsum,
                                  self.dst_caps, self.cfg.batch_size, gen,
                                  self.codec_box))
        return out

    def param_checksum(self) -> float:
        return float(np.sum([float(p.detach().abs().sum())
                             for p in self.model.parameters()]))


def main(argv: Sequence[str] = None) -> int:
    p = argparse.ArgumentParser("fgnn_tpu_torch multi-process data-parallel "
                                "demo")
    p.add_argument("--smoke", action="store_true",
                   help="the CPU (the 2-process run of the tests)")
    p.add_argument("--device", default=None,
                   help="this process's device (default cuda:<rank mod "
                        "visible cards>)")
    p.add_argument("--synthetic-nodes", type=int, default=20_000)
    p.add_argument("--num-epoch", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--num-hidden", type=int, default=32)
    p.add_argument("--save-params", default=None)
    args = p.parse_args(argv)

    if not mh.initialize_from_env():
        print("train_multihost: set FGNN_TPU_COORDINATOR / "
              "FGNN_TPU_NUM_PROCESSES / FGNN_TPU_PROCESS_ID", file=sys.stderr)
        return 2
    host = torch.distributed.get_rank()
    if args.device:
        device = torch.device(args.device)
    elif args.smoke:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = mh.default_device(host)
    else:
        print("train_multihost: no CUDA device; pass --smoke (or --device "
              "cpu) to run on the CPU", file=sys.stderr)
        return 1
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # one slot a process: the wave is as wide as the world
    placements = mh.rank_devices([device])
    W = len(placements)
    counts = [1] * W
    group, route = mh.exchange_group(range(W), placements)
    grad_device = device if route == "nccl" else None
    log_test_result("grad_route", route)

    cfg, ds, plan = demo_setup(args.synthetic_nodes, args.batch_size,
                               args.num_hidden)
    B = cfg.batch_size
    rng = np.random.default_rng(cfg.seed + host)
    ranking = (host0_ranking(cfg, ds, plan, rng) if host == 0
               else np.zeros(ds.num_node, np.int32))
    ranking = mh.broadcast_from_host0(ranking)
    log_test_result("ranking_checksum", str(int(ranking[:100].sum())))
    mh.barrier("post-presample")

    demo = Demo(cfg, ds, plan, device)
    shuf = demo_shuffler(cfg, ds, plan)
    num_waves = -(-shuf.num_step // W)
    for epoch in range(args.num_epoch):
        perm = shuf.epoch_permutation(epoch)
        losses = []
        for wv in range(num_waves):
            slots = wave_slots(perm, wv, host, 1, W, B,
                               plan.num_input_cap[0])
            wave = local_wave(cfg, ds, plan, rng, slots, demo.device)
            wsum = wave_weight(len(perm), wv, W, B)
            images = demo.images(epoch, wave, wsum)
            codec = demo.codec_box[0]
            gathered = mh.gather_images(images, codec.nbytes, group, counts,
                                        grad_device)
            losses.append(train_step(demo.model, demo.optimizer, gathered,
                                     codec, wsum, demo.device))
        print(f"host {host} epoch {epoch}: loss={np.mean(losses):.4f}",
              flush=True)
        log_test_result(f"epoch{epoch}_loss", f"{np.mean(losses):.6f}")

    log_test_result("param_checksum", f"{demo.param_checksum():.6f}")
    if args.save_params:
        os.makedirs(args.save_params, exist_ok=True)
        torch.save({k: v.cpu() for k, v in demo.model.state_dict().items()},
                   os.path.join(args.save_params, f"params_rank{host}.pt"))
    mh.barrier("done")
    print(f"host {host} done, param_checksum={demo.param_checksum():.6f}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
