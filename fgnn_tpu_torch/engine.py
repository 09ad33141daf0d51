"""Single-device engine (port of ``fgnn_tpu/engine.py::OneChipEngine``).

Sample, extract and train on one device. The step is a plain per-step loop:
sample -> features -> labels -> train. Where the feature table lives is the
reference's rule: on the device when it fits the budget, else in host
memory (``feat_on_device``).

* Device-resident table (arch1): the features come from the Hopper
  row-gather kernel. Statistics stay on the device until the end of the
  run, which syncs once (:meth:`run_epochs`).
* Host-resident table (arch2/3/4): every hop dedups, the last one
  included, and each step syncs on its ids. Without a cache the batch's
  rows are gathered on the host and uploaded in float32, as in the
  reference. With ``cache_percentage > 0`` a static cache (ranked by
  presampling, degree, ...) or the dynamic previous-batch cache holds rows
  on the device; only the misses are gathered on the host and uploaded, in
  the staging dtype, and the combine runs the row-gather kernel over the
  cache. With ``cfg.pipeline`` (the default) the host gather and upload of
  batch k+1 run on a worker thread and a copy stream while batch k trains.

Ported: GraphSAGE, GCN and GAT over every khop sampler (KHOP0/KHOP2,
KHOP1, WEIGHTED_KHOP, WEIGHTED_KHOP_PREFIX, WEIGHTED_KHOP_HASH_DEDUP) and
PinSAGE (RANDOM_WALK), the device-resident and host-resident paths, the
static and dynamic caches, and evaluation. Not yet: checkpoints, sanity
checks and profiling levels (ROADMAP.md). Host sampling (arch0) is
:mod:`fgnn_tpu_torch.host_engine`.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from .cache.dynamic import DynamicFeatureCache
from .cache.manager import FeatureCache
from .cache.policy import build_ranking
from .cache.presample import RandFn, presample_ranking, presample_static_ranking
from .config import CachePolicy, RunConfig, SampleType
from .data.schema import Dataset
from .models.gnn import build_model
from .ops.extract import (HostFeatures, device_gather, host_table,
                          label_gather, mock_gather)
from .ops.padding import make_plan
from .ops.random_walk import random_walk_topk, walk_uniform_shapes
from .ops.reference_impl import calibrate_caps
from .ops.sampling import (WEIGHT_TABLES, CSRGraph, check_weight_tables,
                           multi_layer_sample, uniform_shapes)
from .parallel.shuffler import EpochShuffler
from .train.loop import eval_step, make_optimizer, train_step
from .utils import get_logger

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
                 feat_budget: Optional[int] = None,
                 presample_rand: Optional[RandFn] = None):
        """``feat_budget``: bytes the feature table may take on the device;
        by default ``FEAT_MEMORY_SHARE`` of a CUDA device's memory (no limit
        on the CPU). A table over it stays in host memory. ``presample_rand
        (epoch, step)`` injects the presample's per-hop uniforms."""
        cfg.validate()
        # a weighted sampler without its tables fails here, not in a step
        check_weight_tables(ds, cfg.sample_type)
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
        # (an int32 ``indices``, an np.memmap included, is not copied on the
        # host; a CPU engine reads it in place). The weighted samplers' tables
        # go up by the reference's rule (fgnn_tpu/engine.py:88-112): the
        # alias tables for WEIGHTED_KHOP and HASH_DEDUP, the prefix table for
        # PREFIX and HASH_DEDUP.
        indptr = np.asarray(ds.indptr)
        indices = np.asarray(ds.indices)
        tables = {
            name: host_table(np.asarray(getattr(ds, name), dtype)).to(dev)
            for name, dtype in (("prob_table", np.float32),
                                ("alias_table", np.int32),
                                ("prob_prefix_table", np.float32))
            if name in WEIGHT_TABLES.get(cfg.sample_type, ())}
        self.graph = CSRGraph(
            indptr=torch.as_tensor(indptr.astype(np.int64), device=dev),
            indices=host_table(np.asarray(indices, np.int32)).to(dev),
            **tables,
        )

        # --- feature placement: the device if the table fits ---------------
        feat_dtype = self.compute_dtype or torch.float32
        feat_bytes = ds.feat.shape[0] * ds.feat.shape[1] * feat_dtype.itemsize
        if feat_budget is None and dev.type == "cuda":
            total = torch.cuda.get_device_properties(dev).total_memory
            feat_budget = int(total * FEAT_MEMORY_SHARE)
        self.feat_on_device = feat_budget is None or feat_bytes <= feat_budget

        # --- static plan via NumPy calibration -----------------------------
        # with the table on the device the last hop skips dedup (duplicate
        # feature-row reads cost less than the dedup sort), EXCEPT for GCN:
        # its 1/sqrt(out-degree) source normalisation counts block
        # occurrences, which skipping dedup changes, and it reads those
        # counts from the dedup sort. A host-resident table dedups every hop:
        # each duplicate would be one more row through the host. The no-dedup
        # last hop is degree-tiered for the uniform samplers without
        # replacement only (take-all on a narrow tier is their distribution,
        # not KHOP1's or a weighted one's); PinSAGE's walks every hop at K =
        # num_neighbor. KHOP1 calibrates its caps with replacement, every
        # other sampler as a uniform one without
        gcn = cfg.model == "gcn"
        walk = cfg.sample_type == SampleType.RANDOM_WALK
        self.dedup_last_hop = gcn or not self.feat_on_device
        self.with_out_degrees = gcn
        fan_sampling = ([cfg.num_neighbor] * cfg.num_layer_rw if walk
                        else list(reversed(cfg.fanout)))
        tier_stats = None
        calibrate = dict(seed=cfg.seed,
                         replace=cfg.sample_type == SampleType.KHOP1)
        if gcn or cfg.sample_type not in (SampleType.KHOP0, SampleType.KHOP2):
            caps = calibrate_caps(indptr, indices, np.asarray(ds.train_set),
                                  cfg.batch_size, fan_sampling, **calibrate)
        else:
            caps, tier_stats = calibrate_caps(
                indptr, indices, np.asarray(ds.train_set), cfg.batch_size,
                fan_sampling, tier_candidates=TIER_CANDIDATES, **calibrate)
        self.plan = make_plan(cfg.batch_size, list(reversed(fan_sampling)),
                              ds.num_node, unique_caps=caps,
                              tier_stats=tier_stats)
        log.info("sample plan: %s", self.plan)

        self.feat_dev = self.host_feat = None
        if self.feat_on_device:
            self.feat_dev = torch.as_tensor(np.asarray(ds.feat),
                                            device=dev).to(feat_dtype)
        else:
            log.info("feature table of %d bytes stays in host memory "
                     "(device budget %d bytes)", feat_bytes, feat_budget)
            self.host_feat = HostFeatures(ds.feat, dev, mod=ds.feat_mod)
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
        # (miss rows, feature rows) of the last host-resident step
        self.last_rows = (0, 0)

        # --- feature cache, only for a host-resident table -----------------
        self.cache = self.dyn_cache = None
        if cfg.use_cache and not self.feat_on_device:
            self._build_cache(presample_rand)

    def _build_cache(self, presample_rand: Optional[RandFn]) -> None:
        """The reference's order (engine.py:186-234): the dynamic cache, or
        a ranking (presample, presample-static, or a static policy) and the
        static cache over its top rows."""
        cfg, ds = self.cfg, self.ds
        if cfg.cache_policy == CachePolicy.DYNAMIC_CACHE:
            # arch4: the cache is the previous batch
            self.dyn_cache = DynamicFeatureCache(self.host_feat,
                                                 self.plan.final_input_cap)
            return
        sample_fn = lambda seeds, n, rand: self.sample(seeds, n, rand, True)
        if cfg.cache_policy == CachePolicy.PRESAMPLE_STATIC:
            ranking = presample_static_ranking(
                sample_fn, self.shuffler, np.asarray(ds.indptr),
                np.asarray(ds.indices), ds.num_node, self.device,
                presample_epoch=cfg.presample_epoch, seed=cfg.seed,
                rand=presample_rand)
        elif cfg.cache_policy == CachePolicy.PRESAMPLE:
            ranking = presample_ranking(
                sample_fn, self.shuffler, ds.num_node, self.device,
                presample_epoch=cfg.presample_epoch, seed=cfg.seed,
                rand=presample_rand)
        else:
            ranking = build_ranking(ds, cfg.cache_policy, cfg.seed)
        self.cache = FeatureCache(self.host_feat, ranking,
                                  cfg.cache_percentage, ds.num_node,
                                  dtype=self.compute_dtype)

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

    # -- features ----------------------------------------------------------
    def _host_rows(self, input_nodes: torch.Tensor,
                   num_input: torch.Tensor) -> torch.Tensor:
        """Every row of ``input_nodes`` from the host table, float32, zero
        rows for padding: the reference's uncached host path."""
        host = self.host_feat
        f = host.fetch(input_nodes, num_input.reshape(1).to(torch.int32))
        rows, (n,), ready = host.load(f, torch.float32, compact=False)
        host.ready(ready)
        self.last_rows = (n, n)
        return rows

    def features(self, batch) -> torch.Tensor:
        """The batch's input features on the device, by the engine's path.
        On the host-resident path it sets ``last_rows`` to the step's
        (miss rows, feature rows)."""
        if self.feat_dev is not None:
            return self.feat_gather(self.feat_dev, batch.input_nodes)
        if self.dyn_cache is not None:
            feats = self.dyn_cache.extract(batch.input_nodes)
            miss, hit = self.dyn_cache.last_num_miss, self.dyn_cache.last_num_hit
        elif self.cache is not None:
            index = self.cache.get_miss_cache_index(batch.input_nodes)
            rows, miss, hit = self.cache.upload_miss(index)
            feats = self.cache.combine(index, rows, miss)
        else:
            return self._host_rows(batch.input_nodes, batch.num_input)
        self.last_rows = (miss, miss + hit)
        return feats

    def train_on(self, batch, feats: torch.Tensor):
        """One optimizer step on a sampled batch and its input features.
        Returns device scalars ``(loss, acc, sampled_edges, overflowed)``."""
        labels = label_gather(self.label_dev, batch.output_nodes)
        loss, acc = train_step(
            self.model, self.optimizer, batch, feats, labels, self.dst_caps,
            self.cfg.batch_size, generator=self.dropout_gen,
        )
        n_edges = sum(b.mask.sum() for b in batch.blocks)
        return loss, acc, n_edges, batch.overflowed

    def step(self, seeds: torch.Tensor, num_seeds,
             rand: Optional[Sequence[torch.Tensor]] = None):
        """One training step on a ``[seed_cap]`` int32 seed tensor.

        ``rand`` injects the sampler's uniforms, one tensor per hop
        (:meth:`uniform_shapes`); by default the engine's own
        generator draws them. Returns device scalars ``(loss, acc,
        sampled_edges, overflowed)``.
        """
        batch = self.sample(seeds, num_seeds,
                            self.sample_gen if rand is None else rand,
                            self.dedup_last_hop)
        return self.train_on(batch, self.features(batch))

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

    # -- epochs ------------------------------------------------------------
    @property
    def pipelined(self) -> bool:
        """Whether epochs run the cache prefetch pipeline."""
        return self.cfg.pipeline and (self.cache is not None
                                      or self.dyn_cache is not None)

    def _epoch_inputs(self, epoch: int):
        seeds_all, nums_all = self.shuffler.epoch_arrays(epoch)
        return (torch.as_tensor(seeds_all, device=self.device),
                torch.as_tensor(nums_all, device=self.device),
                torch.as_tensor(nums_all > 0, dtype=torch.float32))

    @staticmethod
    def _stats(loss, acc, n_edges, ovf) -> torch.Tensor:
        return torch.stack([loss.float(), acc.float(), n_edges.float(),
                            ovf.float()])

    def _dispatch_epoch(self, epoch: int):
        """Every step of one epoch: the ``[num_step, 4]`` device stats
        (loss, acc, edges, overflow), the host weights of the steps (1 where
        the batch is not empty) and, on the host-resident path, the epoch's
        (miss rows, feature rows). The device-resident path never syncs."""
        if self.pipelined:
            return self._dispatch_epoch_pipelined(epoch)
        seeds_dev, nums_dev, weights = self._epoch_inputs(epoch)
        stats, rows = [], [0, 0]
        for i in range(self.shuffler.num_step):
            stats.append(self._stats(*self.step(seeds_dev[i], nums_dev[i])))
            rows = [a + b for a, b in zip(rows, self.last_rows)]
        return (torch.stack(stats), weights,
                None if self.feat_on_device else rows)

    def _dispatch_epoch_pipelined(self, epoch: int):
        """The cache epoch as a two-stage pipeline (the reference's
        ``_run_epoch_split_pipelined`` and ``_run_epoch_dyncache_pipelined``,
        after the source system's SampleSubLoop || DataCopySubLoop): on this
        thread, sample batch k+1, split it against the cache and queue the
        copy of its miss ids to the host; on a worker thread, wait for those
        ids, gather the rows on the host and upload them on the copy stream;
        meanwhile this thread combines and trains batch k, its stream waiting
        for batch k's upload. The same batches, draws and order as the
        synchronous epoch, so the same numbers."""
        seeds_dev, nums_dev, weights = self._epoch_inputs(epoch)
        host = self.host_feat
        cache = self.cache if self.cache is not None else self.dyn_cache
        split = (self.cache.get_miss_cache_index if self.cache is not None
                 else self.dyn_cache.split_and_advance)
        stats, rows = [], [0, 0]
        with ThreadPoolExecutor(max_workers=1) as worker:
            def produce(i):
                batch = self.sample(seeds_dev[i], nums_dev[i], self.sample_gen,
                                    True)
                index = split(batch.input_nodes)
                f = host.fetch(index.miss_ids,
                               torch.stack([index.num_miss, index.num_hit]))
                return batch, index, worker.submit(host.load, f, cache.dtype)

            pending = produce(0)
            for i in range(self.shuffler.num_step):
                batch, index, job = pending
                if i + 1 < self.shuffler.num_step:
                    pending = produce(i + 1)
                miss_rows, (miss, hit), ready = job.result()
                host.ready(ready)
                feats = cache.combine(index, miss_rows, miss)
                stats.append(self._stats(*self.train_on(batch, feats)))
                rows = [rows[0] + miss, rows[1] + miss + hit]
        return torch.stack(stats), weights, rows

    def run_epochs(self, start_epoch: int, n: int) -> List[dict]:
        """``n`` epochs back to back with one host sync at the end; the same
        math and dicts as ``n`` :meth:`run_epoch` calls. Each epoch reports
        ``epoch_time`` as the total over ``n``, and surfaces its overflow.
        With a host-resident table each epoch also reports ``miss_bytes``
        and ``feature_bytes`` (the reference's profiler counters: rows from
        the host, and all input rows, times the staging bytes of a row; the
        hit rate is 1 - miss/feature)."""
        t0 = time.perf_counter()
        epochs = range(start_epoch, start_epoch + n)
        dispatched = [self._dispatch_epoch(e) for e in epochs]
        stats = torch.stack([s for s, _, _ in dispatched]).cpu()   # the one sync
        epoch_time = (time.perf_counter() - t0) / n
        # the reference's counters: rows times the bytes of a staged row,
        # the static cache's dtype, else float32
        row_bytes = self.ds.feat_dim * (
            4 if self.cache is None else self.cache.dtype.itemsize)
        out = []
        for e, s, (_, w, rows) in zip(epochs, stats, dispatched):
            wsum = max(float(w.sum()), 1.0)
            self._surface_overflow(e, bool(s[:, 3].any()))
            r = {
                "epoch": e,
                "epoch_time": epoch_time,
                "loss": float((s[:, 0] * w).sum() / wsum),
                "acc": float((s[:, 1] * w).sum() / wsum),
                "num_step": self.shuffler.num_step,
                "sampled_edges": int(s[:, 2].double().sum()),
            }
            if rows is not None:
                r["miss_bytes"] = rows[0] * row_bytes
                r["feature_bytes"] = rows[1] * row_bytes
            out.append(r)
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
        uniforms of a step instead (:meth:`uniform_shapes` with dedup).
        A host-resident table is read on the host without the cache, as in
        the reference, so evaluating leaves a dynamic cache as it was. An
        empty-feat table is read modulo its rows, as training reads it (the
        reference's evaluate reads it with ``device_gather``, which gives
        NaN rows past the table's end)."""
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
            if self.feat_dev is not None:
                feats = self.feat_gather(self.feat_dev, batch.input_nodes)
            else:
                feats = self._host_rows(batch.input_nodes, batch.num_input)
            labels = label_gather(self.label_dev, batch.output_nodes)
            accs.append(eval_step(self.model, batch, feats, labels,
                                  self.dst_caps, cfg.batch_size))
        if not accs:
            return 0.0
        return float(torch.stack(accs).cpu().double().mean())   # the one sync
