"""Single-device engine, arch1 (port of ``fgnn_tpu/engine.py::OneChipEngine``).

Sample, extract and train on one device with the feature table resident in
device memory. The step is a plain per-step loop: sample -> feature gather
(the Hopper row-gather kernel) -> labels -> train. Statistics stay on the
device until the end of the run, which syncs once (:meth:`run_epochs`).

Ported: the HBM-resident path for GraphSAGE, GCN, GAT (KHOP0/KHOP2) and
PinSAGE (RANDOM_WALK), and evaluation. Not yet: the other samplers,
host-resident features and the caches, checkpoints, sanity checks and
profiling (ROADMAP.md).
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from fgnn_tpu.config import RunConfig, SampleType
from fgnn_tpu.data.schema import Dataset
from fgnn_tpu.utils import get_logger

from .models.gnn import build_model
from .ops.extract import device_gather, label_gather, mock_gather
from .ops.padding import make_plan
from .ops.random_walk import random_walk_topk, walk_uniform_shapes
from .ops.reference_impl import calibrate_caps
from .ops.sampling import CSRGraph, multi_layer_sample, uniform_shapes
from .parallel.shuffler import EpochShuffler
from .train.loop import eval_step, make_optimizer, train_step

log = get_logger(__name__)

# last-hop degree-tier candidates of the plan's tier search
TIER_CANDIDATES = (4, 6, 8, 10, 12, 14, 16, 20)
# seed offset of evaluation's own generator (the reference's key)
EVAL_SEED_OFFSET = 12345
# share of a CUDA device's memory the feature table may take; the rest
# holds the graph, the batch's activations and the parameters
FEAT_MEMORY_SHARE = 0.5


class OneChipEngine:
    def __init__(self, cfg: RunConfig, ds: Dataset,
                 device: Union[str, torch.device],
                 feat_budget: Optional[int] = None):
        """``feat_budget``: bytes the feature table may take on the device;
        by default ``FEAT_MEMORY_SHARE`` of a CUDA device's memory (no limit
        on the CPU). A table that does not fit raises."""
        cfg.validate()
        if cfg.sample_type not in (SampleType.KHOP0, SampleType.KHOP2,
                                   SampleType.RANDOM_WALK):
            raise NotImplementedError(
                f"{cfg.sample_type} is not ported yet (ROADMAP.md A12)")
        if cfg.use_cache:
            raise NotImplementedError(
                "feature caches are not ported yet (ROADMAP.md A13)")
        self.cfg = cfg
        self.ds = ds
        self.device = torch.device(device)
        dev = self.device
        self.compute_dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                              else None)
        # the model first: an unported model fails before any upload
        self.model = build_model(
            cfg.model, ds.feat_dim, cfg.num_hidden, ds.num_class,
            cfg.num_layer, cfg.dropout, dtype=self.compute_dtype,
            generator=torch.Generator().manual_seed(cfg.seed + 1),
        ).to(dev)
        self.optimizer = make_optimizer(self.model.parameters(), cfg.lr,
                                        cfg.weight_decay)

        # --- topology to device ------------------------------------------
        indptr = np.asarray(ds.indptr)
        indices = np.asarray(ds.indices)
        self.graph = CSRGraph(
            indptr=torch.as_tensor(indptr.astype(np.int64), device=dev),
            indices=torch.as_tensor(indices.astype(np.int32), device=dev),
        )

        # --- static plan via NumPy calibration -----------------------------
        # the feature table is on the device, so the last hop skips dedup
        # (duplicate feature-row reads cost less than the dedup sort), EXCEPT
        # for GCN: its 1/sqrt(out-degree) source normalisation counts block
        # occurrences, which skipping dedup changes, and it reads those
        # counts from the dedup sort. The uniform samplers' no-dedup last
        # hop is degree-tiered; PinSAGE's walks every hop at K = num_neighbor
        gcn = cfg.model == "gcn"
        walk = cfg.sample_type == SampleType.RANDOM_WALK
        self.dedup_last_hop = gcn
        self.with_out_degrees = gcn
        fan_sampling = ([cfg.num_neighbor] * cfg.num_layer_rw if walk
                        else list(reversed(cfg.fanout)))
        tier_stats = None
        if gcn or walk:
            caps = calibrate_caps(indptr, indices, np.asarray(ds.train_set),
                                  cfg.batch_size, fan_sampling, seed=cfg.seed)
        else:
            caps, tier_stats = calibrate_caps(
                indptr, indices, np.asarray(ds.train_set), cfg.batch_size,
                fan_sampling, seed=cfg.seed, tier_candidates=TIER_CANDIDATES,
            )
        self.plan = make_plan(cfg.batch_size, list(reversed(fan_sampling)),
                              ds.num_node, unique_caps=caps,
                              tier_stats=tier_stats)
        log.info("sample plan: %s", self.plan)

        # --- feature table in device memory --------------------------------
        feat_dtype = self.compute_dtype or torch.float32
        feat = np.asarray(ds.feat)
        feat_bytes = feat.shape[0] * feat.shape[1] * feat_dtype.itemsize
        if feat_budget is None and dev.type == "cuda":
            total = torch.cuda.get_device_properties(dev).total_memory
            feat_budget = int(total * FEAT_MEMORY_SHARE)
        if feat_budget is not None and feat_bytes > feat_budget:
            raise ValueError(
                f"feature table of {feat_bytes} bytes exceeds the device "
                f"budget of {feat_budget} bytes; host-resident features and "
                "the caches are not ported yet (ROADMAP.md A13)"
            )
        self.feat_dev = torch.as_tensor(feat, device=dev).to(feat_dtype)
        self.label_dev = torch.as_tensor(
            np.asarray(ds.label).astype(np.int64), device=dev)
        self.feat_gather = mock_gather if ds.empty_feat else device_gather

        # --- shuffler, generators -----------------------------------------
        self.shuffler = EpochShuffler(
            ds.train_set, cfg.batch_size, self.plan.num_input_cap[0],
            base_seed=cfg.seed,
        )
        self.dst_caps = tuple(reversed(self.plan.num_input_cap))
        self.sample_gen = torch.Generator(dev).manual_seed(cfg.seed)
        self.dropout_gen = torch.Generator(dev).manual_seed(cfg.seed + 0x5eed)
        self.last_overflowed = False

    # ------------------------------------------------------------------
    def uniform_shapes(self, dedup_last_hop: bool) -> list:
        """Shape of the uniforms each hop of :meth:`sample` draws."""
        cfg = self.cfg
        if cfg.sample_type == SampleType.RANDOM_WALK:
            return walk_uniform_shapes(self.plan, cfg.num_random_walk,
                                       cfg.random_walk_length)
        return uniform_shapes(self.plan, cfg.sample_type, dedup_last_hop)

    def sample(self, seeds: torch.Tensor, num_seeds,
               rand: Union[torch.Generator, Sequence[torch.Tensor]],
               dedup_last_hop: bool):
        """One batch under the engine's plan: ``random_walk_topk`` for
        RANDOM_WALK, else ``multi_layer_sample``. ``rand`` is a generator
        or one uniforms tensor per hop (:meth:`uniform_shapes`)."""
        cfg = self.cfg
        if cfg.sample_type == SampleType.RANDOM_WALK:
            return random_walk_topk(
                self.graph, seeds, num_seeds, self.plan,
                num_random_walk=cfg.num_random_walk,
                random_walk_length=cfg.random_walk_length,
                restart_prob=cfg.random_walk_restart_prob,
                dedup_last_hop=dedup_last_hop, rand=rand,
            )
        return multi_layer_sample(
            self.graph, seeds, num_seeds, self.plan, self.cfg.sample_type,
            dedup_last_hop=dedup_last_hop,
            with_out_degrees=self.with_out_degrees, rand=rand,
        )

    def step(self, seeds: torch.Tensor, num_seeds,
             rand: Optional[Sequence[torch.Tensor]] = None):
        """One training step on a ``[seed_cap]`` int32 seed tensor.

        ``rand`` injects the sampler's uniforms, one tensor per hop
        (:meth:`uniform_shapes`); by default the engine's own
        generator draws them. Returns device scalars ``(loss, acc,
        sampled_edges, overflowed)``.
        """
        cfg = self.cfg
        batch = self.sample(seeds, num_seeds,
                            self.sample_gen if rand is None else rand,
                            self.dedup_last_hop)
        feats = self.feat_gather(self.feat_dev, batch.input_nodes)
        labels = label_gather(self.label_dev, batch.output_nodes)
        loss, acc = train_step(
            self.model, self.optimizer, batch, feats, labels, self.dst_caps,
            cfg.batch_size, generator=self.dropout_gen,
        )
        n_edges = sum(b.mask.sum() for b in batch.blocks)
        return loss, acc, n_edges, batch.overflowed

    def _surface_overflow(self, epoch: int, overflowed: bool) -> None:
        """A sampler cap overflow clips sampled nodes/edges: warn, or raise
        under ``cfg.sanity_check``."""
        self.last_overflowed = overflowed
        if not overflowed:
            return
        msg = (
            f"epoch {epoch}: sampler cap overflow — a batch exceeded the "
            f"calibrated unique/edge caps {self.plan.num_unique_cap}/"
            f"{self.plan.num_edge_cap} and was clipped (dropped neighbors). "
            "Raise constants.ALLOC_SCALE or calibrate_caps num_probe."
        )
        if self.cfg.sanity_check:
            raise RuntimeError(msg)
        log.warning(msg)

    def _dispatch_epoch(self, epoch: int):
        """Every step of one epoch, with no host sync: the ``[num_step, 4]``
        device stats (loss, acc, edges, overflow) and the host weights of
        the steps (1 where the batch is not empty)."""
        seeds_all, nums_all = self.shuffler.epoch_arrays(epoch)
        seeds_dev = torch.as_tensor(seeds_all, device=self.device)
        nums_dev = torch.as_tensor(nums_all, device=self.device)
        stats = []
        for i in range(self.shuffler.num_step):
            loss, acc, n_edges, ovf = self.step(seeds_dev[i], nums_dev[i])
            stats.append(torch.stack([loss.float(), acc.float(),
                                      n_edges.float(), ovf.float()]))
        return torch.stack(stats), torch.as_tensor(nums_all > 0,
                                                   dtype=torch.float32)

    def run_epochs(self, start_epoch: int, n: int) -> List[dict]:
        """``n`` epochs back to back with one host sync at the end; the same
        math and dicts as ``n`` :meth:`run_epoch` calls. Each epoch reports
        ``epoch_time`` as the total over ``n``, and surfaces its overflow."""
        t0 = time.perf_counter()
        epochs = range(start_epoch, start_epoch + n)
        dispatched = [self._dispatch_epoch(e) for e in epochs]
        stats = torch.stack([s for s, _ in dispatched]).cpu()   # the one sync
        epoch_time = (time.perf_counter() - t0) / n
        out = []
        for e, s, (_, w) in zip(epochs, stats, dispatched):
            wsum = max(float(w.sum()), 1.0)
            self._surface_overflow(e, bool(s[:, 3].any()))
            out.append({
                "epoch": e,
                "epoch_time": epoch_time,
                "loss": float((s[:, 0] * w).sum() / wsum),
                "acc": float((s[:, 1] * w).sum() / wsum),
                "num_step": self.shuffler.num_step,
                "sampled_edges": int(s[:, 2].double().sum()),
            })
        return out

    def run_epoch(self, epoch: int) -> dict:
        return self.run_epochs(epoch, 1)[0]

    def evaluate(self, node_set: Optional[np.ndarray] = None,
                 rand: Optional[Callable[[int], Sequence[torch.Tensor]]] = None
                 ) -> float:
        """Accuracy over ``node_set`` (the test set by default): the
        unweighted mean of the per-batch accuracies, dropout off.

        Batches are sampled with last-hop dedup, as the reference's
        evaluation does for every model, from a generator of their own
        (seed ``cfg.seed + EVAL_SEED_OFFSET``), so evaluating leaves the
        training generators where they were. ``rand(step)`` injects the
        uniforms of a step instead (:meth:`uniform_shapes` with dedup)."""
        cfg = self.cfg
        nodes = np.asarray(node_set if node_set is not None
                           else self.ds.test_set)
        gen = torch.Generator(self.device).manual_seed(
            cfg.seed + EVAL_SEED_OFFSET)
        sh = EpochShuffler(nodes, cfg.batch_size, self.plan.num_input_cap[0])
        accs = []
        for seeds, n, step in sh.batches(0):
            batch = self.sample(torch.as_tensor(seeds, device=self.device), n,
                                gen if rand is None else rand(step),
                                dedup_last_hop=True)
            feats = self.feat_gather(self.feat_dev, batch.input_nodes)
            labels = label_gather(self.label_dev, batch.output_nodes)
            accs.append(eval_step(self.model, batch, feats, labels,
                                  self.dst_caps, cfg.batch_size))
        if not accs:
            return 0.0
        return float(torch.stack(accs).cpu().double().mean())   # the one sync
