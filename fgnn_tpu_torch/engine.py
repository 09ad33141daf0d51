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

Observing a run does not change it. The profiler
(:mod:`fgnn_tpu_torch.utils.profiler`) gets the reference's items: init
times, the step and epoch items of each path at ``cfg.profile_level``
(``FGNN_TPU_PROFILE_LEVEL`` raises the level the profiler writes at, not
the path, as in the reference), trace lanes (``FGNN_TPU_DUMP_TRACE``) and
node access (``FGNN_TPU_LOG_NODE_ACCESS``).
The path follows the reference's gates: at level 2 or higher, with a
trace, node access or the sanity checker (``cfg.sanity_check`` or
``FGNN_TPU_SANITY_CHECK``) the epoch runs the stepwise loop, which syncs the
device at each stage boundary (the reference's ``force_done``). A
host-resident table without the pipeline runs that loop at every level,
without the syncs while nothing observes. Its stages are those of
:meth:`OneChipEngine.step`: one feature path for both. Level 3 adds a
measurement pass over each step's sampling on a snapshot of the sampler's
generator, so training draws what it would have drawn. ``cfg.ckpt_dir``
restores the latest checkpoint on construction (``start_epoch``), and
:meth:`run_epochs` saves every ``cfg.ckpt_every`` epochs: the model, the
optimizer and both generators' states.

Ported: GraphSAGE, GCN and GAT over every khop sampler (KHOP0/KHOP2,
KHOP1, WEIGHTED_KHOP, WEIGHTED_KHOP_PREFIX, WEIGHTED_KHOP_HASH_DEDUP) and
PinSAGE (RANDOM_WALK), the device-resident and host-resident paths, the
static and dynamic caches, evaluation, the profiler, the checker and
checkpoints. Host sampling (arch0) is :mod:`fgnn_tpu_torch.host_engine`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from .cache.dynamic import DynamicFeatureCache
from .cache.manager import FeatureCache
from .cache.policy import build_ranking
from .cache.presample import RandFn, presample_ranking, presample_static_ranking
from .config import CachePolicy, RunConfig, SampleType, env_int
from .data.schema import Dataset
from .models.gnn import build_model
from .ops.extract import (HostFeatures, device_gather, host_table,
                          label_gather, mock_gather)
from .ops.padding import make_plan
from .ops.random_walk import random_walk_topk, walk_uniform_shapes
from .ops.hashtable import lookup_local_ids, unique_with_seeds
from .ops.reference_impl import calibrate_caps
from .ops.sampling import (WEIGHT_TABLES, CSRGraph, check_weight_tables,
                           multi_layer_sample, sample_layer, uniform_shapes)
from .ops.sanity import make_checker
from .parallel.shuffler import EpochShuffler
from .train.checkpoint import CheckpointManager
from .train.loop import eval_step, make_optimizer, train_step
from .utils import Timer, get_logger
from .utils.profiler import Profiler

log = get_logger(__name__)

# last-hop degree-tier candidates of the plan's tier search
TIER_CANDIDATES = (4, 6, 8, 10, 12, 14, 16, 20)
# seed offset of evaluation's own generator (the reference's key)
EVAL_SEED_OFFSET = 12345
# share of a CUDA device's memory the feature table may take; the rest
# holds the graph, the batch's activations and the parameters
FEAT_MEMORY_SHARE = 0.5


def device_sync(device: torch.device) -> None:
    """Wait for the device's queued work (the reference's ``force_done``);
    nothing to wait for on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_graph(ds: Dataset, sample_type: SampleType,
                 device: torch.device) -> CSRGraph:
    """The dataset's CSR on ``device``: int64 ``indptr``, int32 ``indices``
    (an int32 ``indices``, an np.memmap included, is not copied on the
    host; a CPU graph reads it in place) and the per-edge tables that
    ``sample_type`` reads, by the reference's rule
    (fgnn_tpu/engine.py:88-112): the alias tables for WEIGHTED_KHOP and
    HASH_DEDUP, the prefix table for PREFIX and HASH_DEDUP."""
    tables = {
        name: host_table(np.asarray(getattr(ds, name), dtype)).to(device)
        for name, dtype in (("prob_table", np.float32),
                            ("alias_table", np.int32),
                            ("prob_prefix_table", np.float32))
        if name in WEIGHT_TABLES.get(sample_type, ())}
    return CSRGraph(
        indptr=torch.as_tensor(np.asarray(ds.indptr).astype(np.int64),
                               device=device),
        indices=host_table(np.asarray(ds.indices, np.int32)).to(device),
        **tables,
    )


def resolve_feat_budget(feat_budget: Optional[int],
                        device: torch.device) -> Optional[int]:
    """Bytes a feature table may take on ``device``: ``feat_budget`` if
    given, else ``FGNN_TPU_FEAT_HBM_BUDGET`` (read where the reference reads
    it, fgnn_tpu/engine.py:162-164), else ``FEAT_MEMORY_SHARE`` of a CUDA
    device's memory; None (no limit) on the CPU."""
    if feat_budget is None:
        feat_budget = env_int("FGNN_TPU_FEAT_HBM_BUDGET", -1)
        feat_budget = None if feat_budget < 0 else feat_budget
    if feat_budget is None and device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
        feat_budget = int(total * FEAT_MEMORY_SHARE)
    return feat_budget


@dataclasses.dataclass
class Span:
    seconds: float = 0.0


@contextlib.contextmanager
def stage(device: torch.device, key: int, lane: Optional[str], sync: bool):
    """One stage of a step: its trace lane (and torch.profiler range) while
    a trace is on and the step has a ``key``, and its host-clock seconds in
    the yielded :class:`Span`, taken after a device sync when ``sync``."""
    span = Span()
    with (Profiler.get().span(key, lane) if lane and key is not None
          else contextlib.nullcontext()):
        t = Timer()
        yield span
        if sync:
            device_sync(device)
        span.seconds = t.passed()


class OneChipEngine:
    def __init__(self, cfg: RunConfig, ds: Dataset,
                 device: Union[str, torch.device],
                 feat_budget: Optional[int] = None,
                 presample_rand: Optional[RandFn] = None):
        """``feat_budget``: bytes the feature table may take on the device;
        by default ``FGNN_TPU_FEAT_HBM_BUDGET``, else ``FEAT_MEMORY_SHARE``
        of a CUDA device's memory (no limit on the CPU). A table over it
        stays in host memory. ``presample_rand(epoch, step)`` injects the
        presample's per-hop uniforms."""
        cfg.validate()
        # a weighted sampler without its tables fails here, not in a step
        check_weight_tables(ds, cfg.sample_type)
        self.cfg = cfg
        self.ds = ds
        self.device = torch.device(device)
        dev = self.device
        prof = Profiler.get()
        # cfg-requested detail unlocks the matching writers even when
        # FGNN_TPU_PROFILE_LEVEL wasn't exported (library users)
        prof.level = max(prof.level, cfg.profile_level)
        t_init = Timer()
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
        t_copy = Timer()   # device placement (SampleDataCopy analog)
        indptr = np.asarray(ds.indptr)
        indices = np.asarray(ds.indices)
        self.graph = device_graph(ds, cfg.sample_type, dev)
        device_sync(dev)
        copy_s = t_copy.passed()

        # --- feature placement: the device if the table fits ---------------
        feat_dtype = self.compute_dtype or torch.float32
        feat_bytes = ds.feat.shape[0] * ds.feat.shape[1] * feat_dtype.itemsize
        feat_budget = resolve_feat_budget(feat_budget, dev)
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

        t_copy.reset()
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
        device_sync(dev)
        copy_s += t_copy.passed()
        self.feat_gather = mock_gather if ds.empty_feat else device_gather

        # --- shuffler, generators -----------------------------------------
        self.shuffler = EpochShuffler(
            ds.train_set, cfg.batch_size, self.plan.num_input_cap[0],
            base_seed=cfg.seed,
        )
        prof.set_num_step(self.shuffler.num_step)
        self.dst_caps = tuple(reversed(self.plan.num_input_cap))
        self.sample_gen = torch.Generator(dev).manual_seed(cfg.seed)
        self.dropout_gen = torch.Generator(dev).manual_seed(cfg.seed + 0x5eed)
        self.last_overflowed = False
        # (miss rows, feature rows) of the last host-resident step, and the
        # seconds of its Extract part (features())
        self.last_rows = (0, 0)
        self.last_extract_s = 0.0

        # --- feature cache, only for a host-resident table -----------------
        self.cache = self.dyn_cache = None
        if cfg.use_cache and not self.feat_on_device:
            self._build_cache(presample_rand)

        # --- opt-in sanity checks (SAMGRAPH_SANITY_CHECK analog) ----------
        self.sanity = make_checker(cfg, ds.num_node)

        # --- checkpoint / resume -----------------------------------------
        self.ckpt = None
        self.start_epoch = 0
        if cfg.ckpt_dir:
            self.ckpt = CheckpointManager(cfg.ckpt_dir)
            restored = self.ckpt.restore()
            if restored is not None:
                self._load_ckpt_state(restored[0])
                self.start_epoch = restored[1] + 1
        prof.log_init("init_copy", copy_s)
        prof.log_init("init_other", max(0.0, t_init.passed() - copy_s))

    def _ckpt_state(self) -> dict:
        """What a checkpoint holds: the parameters and the optimizer, and
        the generators' states. The reference's draws are keyed by (epoch,
        step); the port's generators carry state, so a resumed epoch draws
        the batches and dropout masks of an uninterrupted one only with
        them."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "sample_gen": self.sample_gen.get_state(),
                "dropout_gen": self.dropout_gen.get_state()}

    def _load_ckpt_state(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.sample_gen.set_state(state["sample_gen"])
        self.dropout_gen.set_state(state["dropout_gen"])

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
    # Each stage below takes the step key of an observed step (None when
    # nothing observes): with it, the stage opens its trace lane and writes
    # its L2 item at profile level 2 or higher; ``sync`` ends it in a device
    # sync.
    def _log2(self, skey: Optional[int], item: str, span: Span) -> None:
        if skey is not None and self.cfg.profile_level >= 2:
            Profiler.get().log_step(skey, item, span.seconds)

    @property
    def host_rows_path(self) -> bool:
        """The uncached host table: every input row crosses from the host."""
        return (self.host_feat is not None and self.cache is None
                and self.dyn_cache is None)

    def fetch(self, batch, skey: Optional[int] = None, sync: bool = False):
        """The copy of the batch's ids to the host (DoIdCopy), for
        :meth:`host_rows`."""
        with stage(self.device, skey, "kL2Event_Copy_Id", sync) as s:
            f = self.host_feat.fetch(batch.input_nodes,
                                     batch.num_input.reshape(1).to(torch.int32))
        self._log2(skey, "L2_id_copy_time", s)
        return f

    def host_rows(self, f, skey: Optional[int] = None,
                  sync: bool = False) -> torch.Tensor:
        """Every row of a fetched batch from the host table, float32, zero
        rows for padding: the reference's uncached host path. Sets
        ``last_rows`` and ``last_extract_s`` (the host gather)."""
        host = self.host_feat
        with stage(self.device, skey, "kL2Event_Copy_Extract", sync) as s:
            rows, (n,), ready = host.load(f, torch.float32, compact=False)
        self._log2(skey, "L2_extract_time", s)
        with stage(self.device, skey, "kL2Event_Copy_FeatCopy", sync) as c:
            host.ready(ready)
        self._log2(skey, "L2_feat_copy_time", c)
        self.last_rows = (n, n)
        self.last_extract_s = s.seconds
        return rows

    def features(self, batch, fetched=None, skey: Optional[int] = None,
                 sync: bool = False) -> torch.Tensor:
        """The batch's input features on the device, by the engine's path.
        The uncached host path reads the rows of ``fetched`` (from
        :meth:`fetch`), else fetches them here. Sets ``last_extract_s``, the
        Extract part of Table 1's split (the device gather; the host gather
        and a static cache's split), and on the host-resident path
        ``last_rows``, the step's (miss rows, feature rows)."""
        dev = self.device
        if self.feat_dev is not None:
            with stage(dev, skey, "kL2Event_Copy_Extract", sync) as s:
                feats = self.feat_gather(self.feat_dev, batch.input_nodes)
            self._log2(skey, "L2_extract_time", s)
            self.last_extract_s = s.seconds
            return feats
        if self.host_rows_path:
            return self.host_rows(fetched if fetched is not None
                                  else self.fetch(batch), skey, sync)
        self.last_extract_s = 0.0
        if self.dyn_cache is not None:
            feats = self.dyn_cache.extract(batch.input_nodes)
            miss, hit = self.dyn_cache.last_num_miss, self.dyn_cache.last_num_hit
            self.last_rows = (miss, miss + hit)
            return feats
        cache = self.cache
        with stage(dev, skey, "kL2Event_Copy_CacheCopy", sync):
            with stage(dev, skey, "kL3Event_Copy_CacheCopy_GetIndex",
                       sync) as s:
                index = cache.get_miss_cache_index(batch.input_nodes)
            self._log2(skey, "L2_cache_get_index_time", s)
            with stage(dev, skey, None, sync) as m:
                rows, miss, hit = cache.upload_miss(index, trace_key=skey)
            self._log2(skey, "L2_cache_extract_miss_time", m)
            with stage(dev, skey, "kL3Event_Copy_CacheCopy_CombineMiss",
                       sync) as c:
                feats = cache.combine(index, rows, miss)
            self._log2(skey, "L2_cache_combine_miss_time", c)
        self.last_rows = (miss, miss + hit)
        self.last_extract_s = s.seconds + m.seconds
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
        """A sampler cap overflow clips sampled nodes/edges: count it in
        ``epoch_cap_overflow`` and warn, or raise under the sanity check."""
        self.last_overflowed = overflowed
        if not overflowed:
            return
        Profiler.get().log_epoch_add(epoch, "epoch_cap_overflow", 1.0)
        msg = (
            f"epoch {epoch}: sampler cap overflow — a batch exceeded the "
            f"calibrated unique/edge caps {self.plan.num_unique_cap}/"
            f"{self.plan.num_edge_cap} and was clipped (dropped neighbors). "
            "Raise constants.ALLOC_SCALE or calibrate_caps num_probe."
        )
        if self.sanity is not None:
            raise RuntimeError(msg)
        log.warning(msg)

    def _profile_l3(self, seeds: np.ndarray, num: int, skey: int) -> None:
        """Measurement-only de-fused sub-op timing at profile level 3.

        Runs the step's sampling workload as separate sub-ops with a device
        sync after each: every hop's sample, ``unique_with_seeds`` and
        ``lookup_local_ids``, writing the reference's L3 per-kernel items
        and the L2 stage items they roll up into. It draws from a snapshot
        of the sampler's generator and restores it, so the training sample
        draws what it would have drawn. Only the khop family decomposes
        this way (the random walk is one pass)."""
        if self.cfg.sample_type == SampleType.RANDOM_WALK:
            return
        prof = Profiler.get()
        plan, dev = self.plan, self.device
        state = self.sample_gen.get_state()
        try:
            cur = torch.as_tensor(seeds, device=dev)
            num_cur = torch.tensor(num, dtype=torch.int32, device=dev)
            core = remap = 0.0
            for hop in range(plan.num_layer):
                with stage(dev, skey, "kL2Event_Sample_Core", True) as s:
                    nbrs, _ = sample_layer(self.graph, cur, plan.fanouts[hop],
                                           self.cfg.sample_type,
                                           self.sample_gen)
                prof.log_step_add(skey, "L3_khop_sample_coo_time", s.seconds)
                core += s.seconds
                with prof.span(skey, "kL2Event_Sample_IdRemap"):
                    with stage(dev, skey, None, True) as su:
                        unique, nu, _ = unique_with_seeds(
                            cur, num_cur, nbrs, plan.num_unique_cap[hop])
                    with stage(dev, skey, None, True) as sm:
                        lookup_local_ids(unique, plan.num_input_cap[hop], nbrs)
                prof.log_step_add(skey, "L3_remap_unique_time", su.seconds)
                prof.log_step_add(skey, "L3_remap_map_edge_time", sm.seconds)
                remap += su.seconds + sm.seconds
                cur, num_cur = unique, nu
            prof.log_step(skey, "L2_core_sample_time", core)
            prof.log_step(skey, "L2_id_remap_time", remap)
        finally:
            self.sample_gen.set_state(state)

    # -- epochs ------------------------------------------------------------
    def _knobs(self) -> bool:
        """A per-step observer is on: the checker, node access, a trace."""
        prof = Profiler.get()
        return (self.sanity is not None or prof.log_node_access
                or prof.trace_enabled)

    @property
    def pipelined(self) -> bool:
        """Whether epochs run the cache prefetch pipeline: with
        ``cfg.pipeline``, a static cache or, below profile level 2, the
        dynamic cache, and no per-step observer (the reference's gates,
        fgnn_tpu/engine.py:734-755)."""
        if not self.cfg.pipeline or self._knobs():
            return False
        return self.cache is not None or (self.dyn_cache is not None
                                          and self.cfg.profile_level < 2)

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
        (miss rows, feature rows). The device-resident path, unobserved,
        never syncs."""
        if self.pipelined:
            return self._dispatch_epoch_pipelined(epoch)
        if (self.feat_on_device and self.cfg.profile_level < 2
                and not self._knobs()):
            seeds_dev, nums_dev, weights = self._epoch_inputs(epoch)
            stats = [self._stats(*self.step(seeds_dev[i], nums_dev[i]))
                     for i in range(self.shuffler.num_step)]
            return torch.stack(stats), weights, None
        return self._dispatch_epoch_stepwise(epoch)

    def _dispatch_epoch_stepwise(self, epoch: int):
        """The stepwise loop (fgnn_tpu/engine.py:757-974), for the profiler
        and the checker and for a host-resident table without the
        pipeline: the stages of :meth:`step` (:meth:`sample`,
        :meth:`fetch`, :meth:`features`, :meth:`train_on`), each timed on
        the host clock, with a device sync at its end while anything
        observes, and written to the profiler at the reference's levels. The
        device-resident table below level 2 runs each step whole (the
        reference's fused step). The same draws, batches and order as the
        unobserved epoch."""
        prof = Profiler.get()
        dev = self.device
        lvl = self.cfg.profile_level
        sync = lvl >= 2 or self._knobs()
        node_access = prof.log_node_access
        cached = self.cache is not None or self.dyn_cache is not None
        row_bytes = self.ds.feat_dim * (
            4 if self.cache is None else self.cache.dtype.itemsize)
        seeds_all, nums_all = self.shuffler.epoch_arrays(epoch)
        # the epoch's seeds go up at once, as on the other paths: a step's
        # own upload from pageable memory would wait for the card's queue
        seeds_up = torch.as_tensor(seeds_all, device=dev)
        stats, rows = [], [0, 0]
        for step in range(self.shuffler.num_step):
            seeds, n = seeds_all[step], int(nums_all[step])
            skey = prof.step_key(epoch, step)
            with stage(dev, skey, "kL0Event_Train_Step", sync):
                if self.feat_on_device and lvl < 2:
                    with stage(dev, skey, None, sync) as s:
                        batch = self.sample(seeds_up[step], n,
                                            self.sample_gen,
                                            self.dedup_last_hop)
                        if self.sanity is not None:
                            self.sanity.check_batch(batch, self.plan)
                        result = self.train_on(batch, self.features(batch))
                    prof.log_step(skey, "L1_train_time", s.seconds)
                    if node_access:
                        prof.log_node_access_batch(batch.input_nodes.cpu().numpy())
                    stats.append(self._stats(*result))
                    continue

                if lvl >= 3:
                    self._profile_l3(seeds, n, skey)
                fetched = ids = None
                with stage(dev, skey, "kL1Event_Sample", sync) as s_sample:
                    with stage(dev, skey, "kL2Event_Sample_Shuffle", sync) as s:
                        seeds_dev = seeds_up[step]
                    self._log2(skey, "L2_shuffle_time", s)
                    batch = self.sample(seeds_dev, n, self.sample_gen,
                                        self.dedup_last_hop)
                    # the ids' copy to the host (DoIdCopy), behind the sample
                    if self.host_rows_path:
                        fetched = self.fetch(batch, skey, sync)
                    elif node_access:
                        with stage(dev, skey, "kL2Event_Copy_Id", sync) as s:
                            ids = batch.input_nodes.cpu()
                        self._log2(skey, "L2_id_copy_time", s)
                prof.log_step(skey, "L1_sample_time", s_sample.seconds)
                prof.log_epoch_add(epoch, "epoch_sample_time", s_sample.seconds)
                if self.sanity is not None:
                    self.sanity.check_batch(batch, self.plan)

                with stage(dev, skey, "kL1Event_Copy", sync) as s_copy:
                    feats = self.features(batch, fetched, skey, sync)
                prof.log_step(skey, "L1_copy_time", s_copy.seconds)
                # Table 1's split: Extract (the gather, or a cache's split
                # and miss gather) against Copy (upload and merge)
                et = self.last_extract_s
                prof.log_epoch_add(epoch, "epoch_extract_time", et)
                if not self.feat_on_device:
                    prof.log_epoch_add(epoch, "epoch_copy_time",
                                       max(s_copy.seconds - et, 0.0))
                if cached:
                    miss, total = self.last_rows
                    if self.cache is not None:
                        prof.log_step(skey, "L1_miss_nbytes",
                                      float(miss * row_bytes))
                    prof.log_epoch_add(epoch, "epoch_miss_bytes",
                                       float(miss * row_bytes))
                    prof.log_epoch_add(epoch, "epoch_feature_bytes",
                                       float(total * row_bytes))
                prof.log_step(skey, "L1_feature_bytes",
                              float(feats.numel() * feats.element_size()))
                if node_access:
                    prof.log_node_access_batch(
                        (fetched.ids if fetched is not None else ids).numpy())
                with stage(dev, skey, "kL1Event_Train", sync) as s:
                    result = self.train_on(batch, feats)
                prof.log_step(skey, "L1_train_time", s.seconds)
                prof.log_epoch_add(epoch, "epoch_train_time", s.seconds)
            stats.append(self._stats(*result))
            rows = [a + b for a, b in zip(rows, self.last_rows)]
        weights = torch.as_tensor(nums_all > 0, dtype=torch.float32)
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
        synchronous epoch, so the same numbers.

        At profile level 2 or higher (the static cache) each stage ends in
        a device sync and writes its L1 time: the sample and split, the
        host part, the combine and train; the overlap stays. The host
        part's epoch items split it as Table 1 does (the reference files it
        all under ``epoch_copy_time``): the miss gather as
        ``epoch_extract_time``, the rest as ``epoch_copy_time``."""
        prof = Profiler.get()
        sync = self.cfg.profile_level >= 2
        seeds_dev, nums_dev, weights = self._epoch_inputs(epoch)
        host = self.host_feat
        cache = self.cache if self.cache is not None else self.dyn_cache
        split = (self.cache.get_miss_cache_index if self.cache is not None
                 else self.dyn_cache.split_and_advance)
        row_bytes = self.ds.feat_dim * cache.dtype.itemsize

        def load(f):
            t = Timer()
            out = host.load(f, cache.dtype)
            if sync and out[2] is not None:
                out[2].synchronize()        # the upload is done
            return out, t.passed(), host.last_gather_s

        stats, rows = [], [0, 0]
        with ThreadPoolExecutor(max_workers=1) as worker:
            def produce(i):
                t = Timer()
                batch = self.sample(seeds_dev[i], nums_dev[i], self.sample_gen,
                                    True)
                index = split(batch.input_nodes)
                if sync:
                    device_sync(self.device)
                    skey = prof.step_key(epoch, i)
                    prof.log_step(skey, "L1_sample_time", t.passed())
                    prof.log_epoch_add(epoch, "epoch_sample_time", t.passed())
                f = host.fetch(index.miss_ids,
                               torch.stack([index.num_miss, index.num_hit]))
                return batch, index, worker.submit(load, f)

            pending = produce(0)
            for i in range(self.shuffler.num_step):
                batch, index, job = pending
                if i + 1 < self.shuffler.num_step:
                    pending = produce(i + 1)
                (miss_rows, (miss, hit), ready), host_s, gather_s = job.result()
                skey = prof.step_key(epoch, i)
                t = Timer()
                host.ready(ready)
                feats = cache.combine(index, miss_rows, miss)
                stats.append(self._stats(*self.train_on(batch, feats)))
                if sync:
                    device_sync(self.device)
                    # the host part: the miss gather (Table 1's Extract)
                    # and the rest, ids' wait and upload (its Copy)
                    prof.log_step(skey, "L1_copy_time", host_s)
                    prof.log_epoch_add(epoch, "epoch_extract_time", gather_s)
                    prof.log_epoch_add(epoch, "epoch_copy_time",
                                       max(host_s - gather_s, 0.0))
                    prof.log_step(skey, "L1_train_time", t.passed())
                    prof.log_epoch_add(epoch, "epoch_train_time", t.passed())
                prof.log_step(skey, "L1_miss_nbytes", float(miss * row_bytes))
                prof.log_epoch_add(epoch, "epoch_miss_bytes",
                                   float(miss * row_bytes))
                prof.log_epoch_add(epoch, "epoch_feature_bytes",
                                   float((miss + hit) * row_bytes))
                rows = [rows[0] + miss, rows[1] + miss + hit]
        return torch.stack(stats), weights, rows

    def run_epochs(self, start_epoch: int, n: int) -> List[dict]:
        """``n`` epochs back to back, the device-resident path with one
        host sync at the end; the same math and dicts as ``n``
        :meth:`run_epoch` calls. Each epoch reports ``epoch_time`` as the
        total over ``n`` (also the profiler's ``epoch_total_time``), and
        surfaces its overflow. With a host-resident table each epoch also
        reports ``miss_bytes`` and ``feature_bytes`` (the reference's
        profiler counters: rows from the host, and all input rows, times
        the staging bytes of a row; the hit rate is 1 - miss/feature). With
        ``cfg.ckpt_dir`` and a window that crosses a multiple of
        ``cfg.ckpt_every``, its last epoch is saved."""
        prof = Profiler.get()
        t0 = time.perf_counter()
        epochs = range(start_epoch, start_epoch + n)
        dispatched = []
        for e in epochs:
            prof.begin_node_access_epoch()
            if self.sanity is not None:
                self.sanity.reset()
            dispatched.append(self._dispatch_epoch(e))
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
            prof.log_epoch_add(e, "epoch_total_time", epoch_time)
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
        every = self.cfg.ckpt_every
        if self.ckpt is not None and every > 0 and any(
                (e + 1) % every == 0 for e in epochs):
            self.ckpt.save(epochs[-1], self._ckpt_state())
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
                feats = self.host_rows(self.fetch(batch))
            labels = label_gather(self.label_dev, batch.output_nodes)
            accs.append(eval_step(self.model, batch, feats, labels,
                                  self.dst_caps, cfg.batch_size))
        if not accs:
            return 0.0
        return float(torch.stack(accs).cpu().double().mean())   # the one sync
