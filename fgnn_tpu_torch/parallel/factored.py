"""Multi-device engines (port of ``fgnn_tpu/parallel/factored.py``).

``FactoredEngine`` is arch5, FGNN proper (dist_engine.cc +
dist_loops_arch5.cc): dedicated sampler devices produce batches in waves;
the batches cross to the trainers through one FIFO (the global queue, the
source system's MemoryQueue); the trainers run data-parallel training with
one optimizer step a group of T batches.

``SGNNEngine`` is arch6, the space-shared baseline (dist_loops_arch6.cc):
every device samples, extracts and trains its own batch, one step a local
step.

One process drives every role device, as the reference does. A role is a
list of ``torch.device`` (:mod:`.mesh`); a device may repeat, so one card
can hold both roles. Each logical trainer holds a replica of the model,
equal to the first one's at the start of each group; the gradients are
summed into the first replica in logical order 0..T-1 and one Adam step is
taken there, so a permuted device list gives the same bits.

Pipelining: the reference launches up to ``max_copying_jobs`` sample waves
ahead through JAX's async dispatch. The port queues the same waves' kernels
ahead of the drain and makes no host sync between a wave's launch and its
drain: the CUDA queue plays the part of the async dispatch.

Draws: the reference keys each batch by ``fold_in(key(seed), epoch *
num_step + step)``. The port gives each batch a generator on its sampler's
device seeded from ``(cfg.seed, epoch * num_step + step)``, so a batch's
draws depend on its step, not on the device that samples it (CUDA's Philox
gives the same draws on any card). ``rand_fn(epoch, step)`` injects a
step's per-hop uniforms instead, as ``OneChipEngine``'s ``presample_rand``
does; the tests feed the reference's own draws through it. Dropout draws
follow the same rule, keyed by (epoch, group, logical worker).
"""
from __future__ import annotations

import copy
import dataclasses
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from ..cache.manager import FeatureCache, miss_cache_index
from ..cache.policy import build_ranking
from ..cache.presample import (RandFn, presample_ranking,
                               presample_static_ranking)
from ..config import CachePolicy, RunConfig, SampleType
from ..data.schema import Dataset
from ..engine import (EVAL_SEED_OFFSET, device_graph, device_sync,
                      resolve_feat_budget)
from ..models.gnn import build_model
from ..ops.extract import HostFeatures, device_gather, label_gather, mock_gather
from ..ops.padding import make_plan
from ..ops.random_walk import random_walk_topk, walk_uniform_shapes
from ..ops.reference_impl import calibrate_caps
from ..ops.sampling import (CSRGraph, SampledBatch, check_weight_tables,
                            multi_layer_sample, uniform_shapes)
from ..ops.sanity import make_checker
from ..train.checkpoint import CheckpointManager
from ..train.loop import eval_step, make_optimizer, masked_cross_entropy
from ..utils import Timer, get_logger
from ..utils.profiler import Profiler
from .mesh import make_data_mesh, make_role_mesh
from .shuffler import AlignedDistShuffler, DistShuffler, EpochShuffler

log = get_logger(__name__)

# seed offsets of the dropout draws (OneChipEngine's) and of evaluation's
# shuffler (the reference's base_seed + 7)
DROPOUT_SEED_OFFSET = 0x5EED
EVAL_SHUFFLE_OFFSET = 7
# arch6's batch index stride per epoch (the reference's key data)
SGNN_EPOCH_STRIDE = 100003


def step_generator(device: torch.device, base: int,
                   index: int) -> torch.Generator:
    """A generator on ``device`` for draw ``index`` of the stream ``base``:
    seeded ``base`` in the high 31 bits and ``index`` in the low 32, so two
    (base, index) pairs with index < 2^32 never share a seed."""
    seed = ((base & 0x7FFFFFFF) << 32) | (index & 0xFFFFFFFF)
    return torch.Generator(device).manual_seed(seed)


def resolve_feat_on_trainer(cfg: RunConfig, ds: Dataset,
                            compute_dtype: Optional[torch.dtype],
                            device: torch.device,
                            feat_on_trainer: Optional[bool] = None) -> bool:
    """Whether arch5 keeps the feature table on its trainers: as asked,
    else when there is no cache and the table in the compute dtype fits
    the budget of ``device`` (``resolve_feat_budget``: the reference's
    fixed 6 GB of float32 was a TPU v5e's limit). Raises ``ValueError``
    when the table would stay in host memory without a cache."""
    dtype = compute_dtype or torch.float32
    feat_bytes = ds.feat.shape[0] * ds.feat.shape[1] * dtype.itemsize
    if feat_on_trainer is None:
        budget = resolve_feat_budget(None, device)
        feat_on_trainer = not cfg.use_cache and (
            budget is None or feat_bytes <= budget)
    if not feat_on_trainer and not cfg.use_cache:
        raise ValueError(
            f"the {feat_bytes}-byte feature table stays in host memory "
            "and factored mode reads host-resident features only "
            "through a cache: set cache_percentage > 0")
    return feat_on_trainer


def _tensors(obj) -> Iterator[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _tensors(x)


def to_device(obj, device: torch.device, non_blocking: bool = False):
    """A batch, a block or a miss index (dataclasses of tensors, nested in
    tuples) with every tensor on ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device, non_blocking=non_blocking)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device, non_blocking)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(to_device(x, device, non_blocking) for x in obj)
    return obj


class Transport:
    """Moves batches between devices: the global queue's crossing.

    The same device: nothing is copied. Two CUDA devices: PyTorch queues a
    peer copy behind the source's work on the source's stream, with the
    destination's current stream as its barrier on the other side; that
    stream is here a copy stream of the destination, so the copy waits for
    nothing the trainer has queued, and the trainer's stream then waits on
    an event recorded behind the copy. The host never waits. Otherwise (CPU
    and CUDA) a plain ``to``."""

    def __init__(self):
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}

    def cross(self, obj, src: torch.device, dst: torch.device):
        if src == dst:
            return obj
        if src.type != "cuda" or dst.type != "cuda":
            return to_device(obj, dst)
        stream = self._streams.get(dst)
        if stream is None:
            stream = self._streams[dst] = torch.cuda.Stream(dst)
        with torch.cuda.device(dst), torch.cuda.stream(stream):
            out = to_device(obj, dst, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        consumer = torch.cuda.current_stream(dst)
        consumer.wait_event(done)
        # made on the copy stream, read on the consumer's
        for t in _tensors(out):
            t.record_stream(consumer)
        return out


def epoch_rows(shuffler, device: torch.device, epoch: int, seed_cap: int):
    """A worker's batches of an epoch: their seeds ``[L, seed_cap]`` and
    counts ``[L]`` uploaded to ``device`` at once (a step's own upload from
    pageable memory would wait for the device's queue), and their global
    step ids."""
    rows = list(shuffler.batches(epoch))
    seeds = (np.stack([r[0] for r in rows]) if rows
             else np.zeros((0, seed_cap), np.int32))
    return (torch.as_tensor(seeds, device=device),
            torch.as_tensor(np.array([r[1] for r in rows], np.int32),
                            device=device),
            [r[2] for r in rows])


def _edges(batch: SampledBatch) -> torch.Tensor:
    return sum(b.mask.sum() for b in batch.blocks)


class _EngineBase:
    """What both engines share: the plan, the model and its replicas, the
    per-device graph, features and labels, the data-parallel step, the
    overflow check, the cache and checkpoints."""

    def _setup_common(self, cfg: RunConfig, ds: Dataset,
                      rand_fn: Optional[RandFn]):
        cfg.validate()
        check_weight_tables(ds, cfg.sample_type)
        self.cfg = cfg
        self.ds = ds
        self.rand_fn = rand_fn
        prof = Profiler.get()
        # per-stage timers at profile level 2 or higher, or with a trace:
        # a device sync at each stage boundary (the reference's force_done)
        self._prof_stages = cfg.profile_level >= 2 or prof.trace_enabled
        # cfg-requested detail unlocks the matching writers even when
        # FGNN_TPU_PROFILE_LEVEL wasn't exported (library users)
        prof.level = max(prof.level, cfg.profile_level)
        indptr = np.asarray(ds.indptr)
        walk = cfg.sample_type == SampleType.RANDOM_WALK
        fan_sampling = ([cfg.num_neighbor] * cfg.num_layer_rw if walk
                        else list(reversed(cfg.fanout)))
        # the reference's plan: no degree tiers (every hop dedups, or the
        # no-dedup last hop is plain)
        caps = calibrate_caps(
            indptr, np.asarray(ds.indices), np.asarray(ds.train_set),
            cfg.batch_size, fan_sampling, seed=cfg.seed,
            replace=cfg.sample_type == SampleType.KHOP1)
        self.plan = make_plan(cfg.batch_size, list(reversed(fan_sampling)),
                              ds.num_node, unique_caps=caps)
        self.dst_caps = tuple(reversed(self.plan.num_input_cap))
        self.compute_dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                              else None)
        self.with_out_degrees = cfg.model == "gcn"
        self.feat_gather = mock_gather if ds.empty_feat else device_gather
        self.sanity = make_checker(cfg, ds.num_node)
        self.last_overflowed = False
        self._graphs: Dict[torch.device, CSRGraph] = {}
        self._feats: Dict[torch.device, torch.Tensor] = {}
        self._labels: Dict[torch.device, torch.Tensor] = {}
        self.transport = Transport()

    def _init_model(self, device: torch.device) -> None:
        """The model on the first trainer's device, the optimizer over it;
        the other replicas are made at first use."""
        cfg, ds = self.cfg, self.ds
        self.model = build_model(
            cfg.model, ds.feat_dim, cfg.num_hidden, ds.num_class,
            self.plan.num_layer, cfg.dropout, dtype=self.compute_dtype,
            generator=torch.Generator().manual_seed(cfg.seed + 1),
        ).to(device)
        self.optimizer = make_optimizer(self.model.parameters(), cfg.lr,
                                        cfg.weight_decay)
        self.replicas: Dict[int, torch.nn.Module] = {0: self.model}

    # -- per-device resources ---------------------------------------------
    def _graph(self, dev: torch.device) -> CSRGraph:
        if dev not in self._graphs:
            self._graphs[dev] = device_graph(self.ds, self.cfg.sample_type, dev)
        return self._graphs[dev]

    def _feat_table(self, dev: torch.device) -> torch.Tensor:
        """The feature table on ``dev`` in the compute dtype: one per
        device, however many roles it holds."""
        if dev not in self._feats:
            self._feats[dev] = torch.as_tensor(
                np.asarray(self.ds.feat), device=dev).to(
                    self.compute_dtype or torch.float32)
        return self._feats[dev]

    def _label(self, dev: torch.device) -> torch.Tensor:
        if dev not in self._labels:
            self._labels[dev] = torch.as_tensor(
                np.asarray(self.ds.label).astype(np.int64), device=dev)
        return self._labels[dev]

    def _replica(self, i: int, dev: torch.device) -> torch.nn.Module:
        """Logical worker ``i``'s model on ``dev``, its parameters set to
        the first replica's."""
        if i == 0:
            return self.model
        rep = self.replicas.get(i)
        if rep is None:
            rep = self.replicas[i] = copy.deepcopy(self.model).to(dev)
        else:
            with torch.no_grad():
                for p, q in zip(rep.parameters(), self.model.parameters()):
                    p.copy_(q)
        return rep

    # -- sampling ------------------------------------------------------------
    def uniform_shapes(self, dedup_last_hop: bool) -> list:
        """Shape of the uniforms each hop of :meth:`sample` draws."""
        cfg = self.cfg
        if cfg.sample_type == SampleType.RANDOM_WALK:
            return walk_uniform_shapes(self.plan, cfg.num_random_walk,
                                       cfg.random_walk_length)
        return uniform_shapes(self.plan, cfg.sample_type, dedup_last_hop)

    def sample(self, dev: torch.device, seeds: torch.Tensor, num_seeds,
               rand, dedup_last_hop: bool) -> SampledBatch:
        """One batch on ``dev`` (the reference's ``_sample_one``)."""
        cfg = self.cfg
        if cfg.sample_type == SampleType.RANDOM_WALK:
            return random_walk_topk(
                self._graph(dev), seeds, num_seeds, self.plan,
                num_random_walk=cfg.num_random_walk,
                random_walk_length=cfg.random_walk_length,
                restart_prob=cfg.random_walk_restart_prob,
                dedup_last_hop=dedup_last_hop, rand=rand)
        return multi_layer_sample(
            self._graph(dev), seeds, num_seeds, self.plan, cfg.sample_type,
            dedup_last_hop=dedup_last_hop,
            with_out_degrees=self.with_out_degrees, rand=rand)

    def _draws(self, dev: torch.device, epoch: int, step: int, index: int):
        """Batch ``step``'s draws on ``dev``: ``rand_fn(epoch, step)``'s
        uniforms, else a generator for draw ``index``."""
        if self.rand_fn is not None:
            return [r.to(dev) for r in self.rand_fn(epoch, step)]
        return step_generator(dev, self.cfg.seed, index)

    def _dropout_gen(self, dev: torch.device, index: int) -> torch.Generator:
        return step_generator(dev, self.cfg.seed + DROPOUT_SEED_OFFSET, index)

    # -- training ------------------------------------------------------------
    def _dp_step(self, items: Sequence[Tuple[SampledBatch, torch.Tensor]],
                 devices: Sequence[torch.device],
                 gens: Sequence[Optional[torch.Generator]]):
        """One data-parallel optimizer step over a group: ``items[i]`` is
        logical worker i's (batch, features) on ``devices[i]``. The loss is
        sum(l_i w_i) / max(sum w_i, 1) with w_i = (num_output > 0)
        (fgnn_tpu/parallel/factored.py:371-385): each replica backs its term
        out, the gradients are summed into the first replica in logical
        order, and one step is taken there. Returns (loss, acc), device
        scalars on ``devices[0]``."""
        B = self.cfg.batch_size
        dev0 = devices[0]
        ws = [(b.num_output > 0).float() for b, _ in items]
        wsum = torch.stack([w.to(dev0) for w in ws]).sum().clamp(min=1.0)
        self.optimizer.zero_grad(set_to_none=True)
        loss = acc = None
        for i, ((batch, feats), dev, gen) in enumerate(zip(items, devices,
                                                            gens)):
            model = self._replica(i, dev)
            if i:
                model.zero_grad(set_to_none=True)
            model.train()
            logits = model(batch, feats, self.dst_caps, generator=gen)
            labels = label_gather(self._label(dev), batch.output_nodes)
            l, a = masked_cross_entropy(logits[:B], labels[:B])
            (l * ws[i] / wsum.to(dev)).backward()
            lw, aw = (l.detach() * ws[i]).to(dev0), (a * ws[i]).to(dev0)
            loss = lw if loss is None else loss + lw
            acc = aw if acc is None else acc + aw
        params = list(self.model.parameters())
        for i in range(1, len(items)):
            for p, q in zip(params, self.replicas[i].parameters()):
                if q.grad is not None:
                    g = q.grad.to(dev0)
                    p.grad = g if p.grad is None else p.grad + g
        self.optimizer.step()
        return loss / wsum, acc / wsum

    # -- checks, caches, checkpoints ------------------------------------------
    def _surface_overflow(self, epoch: int, overflowed: bool) -> None:
        """Warn (or raise under the sanity check) when any sampled batch
        clipped its calibrated caps: silent truncation corrupts
        gradients."""
        self.last_overflowed = overflowed
        if not overflowed:
            return
        Profiler.get().log_epoch_add(epoch, "epoch_cap_overflow", 1.0)
        msg = (f"epoch {epoch}: sampler cap overflow — a batch exceeded "
               f"unique/edge caps {self.plan.num_unique_cap}/"
               f"{self.plan.num_edge_cap} and was clipped")
        if self.sanity is not None:
            raise RuntimeError(msg)
        log.warning(msg)

    def _ranking(self, dev: torch.device, shuffler: EpochShuffler,
                 presample_rand: Optional[RandFn]) -> np.ndarray:
        """The cache's ranking, presampled on ``dev`` with the dedup
        sampler, or by a static policy."""
        cfg, ds = self.cfg, self.ds
        sample_fn = lambda seeds, n, rand: self.sample(dev, seeds, n, rand,
                                                       True)
        if cfg.cache_policy == CachePolicy.PRESAMPLE_STATIC:
            return presample_static_ranking(
                sample_fn, shuffler, np.asarray(ds.indptr),
                np.asarray(ds.indices), ds.num_node, dev,
                presample_epoch=cfg.presample_epoch, seed=cfg.seed,
                rand=presample_rand)
        if cfg.cache_policy == CachePolicy.PRESAMPLE:
            return presample_ranking(
                sample_fn, shuffler, ds.num_node, dev,
                presample_epoch=cfg.presample_epoch, seed=cfg.seed,
                rand=presample_rand)
        return build_ranking(ds, cfg.cache_policy, cfg.seed)

    def _ckpt_state(self) -> dict:
        """The model and the optimizer. No generator state: every draw is
        keyed by (epoch, step), so a resumed epoch draws what an
        uninterrupted one does."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def _load_ckpt_state(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])

    def _restore(self) -> None:
        self.ckpt = None
        self.start_epoch = 0
        if self.cfg.ckpt_dir:
            self.ckpt = CheckpointManager(self.cfg.ckpt_dir)
            restored = self.ckpt.restore()
            if restored is not None:
                self._load_ckpt_state(restored[0])
                self.start_epoch = restored[1] + 1

    def _maybe_save(self, epoch: int) -> None:
        every = self.cfg.ckpt_every
        if self.ckpt is not None and every > 0 and (epoch + 1) % every == 0:
            self.ckpt.save(epoch, self._ckpt_state())

    def _eval_model(self) -> torch.nn.Module:
        return self.model

    def _evaluate(self, s_dev: torch.device, t_dev: torch.device,
                  node_set, rand, features) -> float:
        """Accuracy over ``node_set`` (the test set by default), the
        unweighted mean of the per-batch accuracies: each batch sampled on
        ``s_dev`` with last-hop dedup, by a generator keyed
        (seed + EVAL_SEED_OFFSET, step) or ``rand(step)``'s uniforms,
        then crossed to ``t_dev`` for ``features(batch)`` and the model."""
        cfg = self.cfg
        nodes = np.asarray(node_set if node_set is not None
                           else self.ds.test_set)
        sh = EpochShuffler(nodes, cfg.batch_size, self.plan.num_input_cap[0],
                           base_seed=cfg.seed + EVAL_SHUFFLE_OFFSET)
        model = self._eval_model()
        accs = []
        for seeds, n, step in sh.batches(0):
            draws = ([r.to(s_dev) for r in rand(step)] if rand is not None
                     else step_generator(s_dev, cfg.seed + EVAL_SEED_OFFSET,
                                         step))
            batch = self.sample(s_dev, torch.as_tensor(seeds, device=s_dev),
                                n, draws, True)
            b = self.transport.cross(batch, s_dev, t_dev)
            labels = label_gather(self._label(t_dev), b.output_nodes)
            accs.append(eval_step(model, b, features(b), labels,
                                  self.dst_caps, cfg.batch_size))
        if not accs:
            return 0.0
        return float(torch.stack(accs).cpu().double().mean())


class FactoredEngine(_EngineBase):
    """arch5: S sampler devices + T trainer devices.

    ``devices``: at least S + T devices (``cfg.num_sample_worker``,
    ``cfg.num_train_worker``); the first S sample, the next T train.
    ``feat_on_trainer``: keep the feature table on the trainers; by
    default when there is no cache and the table fits the budget
    (``FGNN_TPU_FEAT_HBM_BUDGET`` bytes, else ``FEAT_MEMORY_SHARE`` of the
    first trainer's memory). Otherwise the table stays in host memory and
    a cache is required.
    ``rand_fn(epoch, step)`` and ``presample_rand(epoch, step)`` inject the
    training and presample draws."""

    # the epoch's group pipeline (None: groups train where they are formed)
    _pipe = None

    def __init__(self, cfg: RunConfig, ds: Dataset,
                 devices: Sequence, feat_on_trainer: Optional[bool] = None,
                 rand_fn: Optional[RandFn] = None,
                 presample_rand: Optional[RandFn] = None):
        self._setup_common(cfg, ds, rand_fn)
        S, T = cfg.num_sample_worker, cfg.num_train_worker
        self.roles = make_role_mesh(S, T, devices)
        s_devs, t_devs = self.roles.sampler_devices, self.roles.trainer_devices
        prof = Profiler.get()
        t0 = Timer()
        self.dedup_last_hop = True   # arch5 dedups every hop (:143)

        # --- sampler side (SampleInit analog) ----------------------------
        t_copy = Timer()
        for dev in s_devs:
            self._graph(dev)
            device_sync(dev)
        copy_s = t_copy.passed()
        seed_cap = self.plan.num_input_cap[0]
        self.shufflers = [
            DistShuffler(ds.train_set, cfg.batch_size, seed_cap, s, S,
                         base_seed=cfg.seed)
            for s in range(S)]
        self.num_step = self.shufflers[0].num_step
        prof.set_num_step(self.num_step)

        # --- trainer side (TrainInit analog) ------------------------------
        self.feat_on_trainer = resolve_feat_on_trainer(
            cfg, ds, self.compute_dtype, t_devs[0], feat_on_trainer)

        # the cache: ranked on sampler 0 before the trainers init
        # (dist_engine.cc:323-344 ordering), with its own full-train-set
        # shuffler (dist/pre_sampler.cc:39-53); the node -> slot table sits
        # with the samplers (the sampler-side miss/cache split,
        # DoGetCacheMissIndex, dist_loops.cc:271-323), the rows with the
        # trainers, one cache a device
        self.cache = None
        self._caches: Dict[torch.device, FeatureCache] = {}
        self._cache_tables: Dict[torch.device, torch.Tensor] = {}
        if cfg.use_cache and not feat_on_trainer:
            boot = EpochShuffler(ds.train_set, cfg.batch_size, seed_cap,
                                 base_seed=cfg.seed)
            self.ranking = self._ranking(s_devs[0], boot, presample_rand)
            self.cache = self._cache(t_devs[0])
        t_copy.reset()
        for dev in t_devs:
            self._label(dev)
            if feat_on_trainer:
                self._feat_table(dev)
            device_sync(dev)
        copy_s += t_copy.passed()

        self._init_model(t_devs[0])
        self._cur_epoch = 0
        self._group_ordinal = 0
        self._stats: List[torch.Tensor] = []
        self._rows = [0, 0]
        self._restore()
        prof.log_init("init_copy", copy_s)
        prof.log_init("init_other", max(0.0, t0.passed() - copy_s))
        log.info("FactoredEngine: %d samplers + %d trainers, %d steps/epoch, "
                 "cache=%s feat_on_trainer=%s", S, T, self.num_step,
                 f"{cfg.cache_percentage:.0%}" if self.cache else "off",
                 self.feat_on_trainer)

    # -- the cache -------------------------------------------------------
    def _make_cache(self, dev: torch.device, pct: float) -> FeatureCache:
        # a host loader with enough staging slots for two groups of the
        # widest group, all of whose workers may share this device
        slots = 2 * (self.roles.num_sampler + self.roles.num_trainer)
        host = HostFeatures(self.ds.feat, dev, mod=self.ds.feat_mod,
                            slots=slots)
        return FeatureCache(host, self.ranking, pct, self.ds.num_node,
                            dtype=self.compute_dtype)

    def _cache(self, dev: torch.device) -> FeatureCache:
        if dev not in self._caches:
            self._caches[dev] = self._make_cache(dev,
                                                 self.cfg.cache_percentage)
        return self._caches[dev]

    def _cache_table(self, dev: torch.device) -> torch.Tensor:
        if dev not in self._cache_tables:
            self._cache_tables[dev] = self.cache.cache_table.to(dev)
        return self._cache_tables[dev]

    # -- features --------------------------------------------------------
    def _split(self, batch: SampledBatch, index, dev: torch.device):
        """(cache, miss index) of a batch's features on ``dev``: the
        device's cache and the index that came with the batch, or one made
        here."""
        cache = self._cache(dev)
        if index is None:
            index = cache.get_miss_cache_index(batch.input_nodes)
        return cache, index

    def _count_rows(self, miss: int, hit: int) -> None:
        if self._cur_epoch < 0:   # a calibration probe's group
            return
        row = self.ds.feat_dim * self.cache.dtype.itemsize
        prof = Profiler.get()
        prof.log_epoch_add(self._cur_epoch, "epoch_miss_bytes",
                           float(miss * row))
        prof.log_epoch_add(self._cur_epoch, "epoch_feature_bytes",
                           float((miss + hit) * row))
        self._rows[0] += miss
        self._rows[1] += miss + hit

    def _feats_for(self, batch: SampledBatch, index, dev: torch.device,
                   count: bool = True) -> torch.Tensor:
        """The batch's input features on ``dev``: the row gather over the
        device's table, or the cache's miss upload and combine, with the
        sampler-side ``index`` where it came with the batch."""
        if self.feat_on_trainer:
            return self.feat_gather(self._feat_table(dev), batch.input_nodes)
        cache, index = self._split(batch, index, dev)
        rows, miss, hit = cache.upload_miss(index)
        if count:
            self._count_rows(miss, hit)
        return cache.combine(index, rows, miss)

    # -- the epoch ---------------------------------------------------------
    def _group_devices(self, width: int) -> List[torch.device]:
        return self.roles.trainer_devices[:width]

    def run_epoch(self, epoch: int) -> dict:
        cfg = self.cfg
        self._cur_epoch = epoch
        S, T = self.roles.num_sampler, self.roles.num_trainer
        s_devs = self.roles.sampler_devices
        t0_dev = self.roles.trainer_devices[0]
        t_epoch = Timer()
        prof = Profiler.get()
        stages = self._prof_stages
        self._rows = [0, 0]
        self._stats = []
        self._group_ordinal = 0

        cap = self.plan.num_input_cap[0]
        iters = [iter(list(zip(*epoch_rows(sh, dev, epoch, cap))))
                 for sh, dev in zip(self.shufflers, s_devs)]
        live = list(range(S))
        pending: deque = deque()
        in_flight: deque = deque()
        ovfs: Dict[torch.device, list] = {}
        edges: Dict[torch.device, list] = {}
        waves = [0]

        def launch_wave() -> bool:
            """One batch a live sampler, sampler 0's first. A sampler past
            its range drops out; its slot is not sampled (the reference
            samples a padded slot of -1 seeds and drops it)."""
            t = Timer()
            wave = []
            for s in list(live):
                try:
                    seeds, num, step = next(iters[s])
                except StopIteration:
                    live.remove(s)
                    continue
                dev = s_devs[s]
                batch = self.sample(
                    dev, seeds, num,
                    self._draws(dev, epoch, step, epoch * self.num_step + step),
                    True)
                # the sampler-side miss/cache split ships WITH the batch
                idx = (miss_cache_index(self._cache_table(dev),
                                        batch.input_nodes)
                       if self.cache is not None else None)
                wave.append((s, batch, idx))
            if not wave:
                return False
            if stages:
                for dev in set(s_devs):
                    device_sync(dev)
                prof.log_epoch_add(epoch, "epoch_sample_time", t.passed())
                if prof.trace_enabled:
                    prof.trace_event(waves[0] + len(in_flight),
                                     "kL1Event_Sample", t._start * 1e6,
                                     Timer.now_us())
            in_flight.append(wave)
            return True

        def drain_wave() -> None:
            """The wave crosses to trainer 0 (the global queue) and its
            batches enter the FIFO in wave order."""
            wave = in_flight.popleft()
            t = Timer()
            for s, batch, idx in wave:
                if self.sanity is not None:
                    self.sanity.check_batch(batch, self.plan)
                dev = s_devs[s]
                ovfs.setdefault(dev, []).append(batch.overflowed)
                edges.setdefault(dev, []).append(_edges(batch))
                pending.append(self.transport.cross((batch, idx), dev, t0_dev))
            if stages:
                device_sync(t0_dev)
                prof.log_epoch_add(epoch, "epoch_copy_time", t.passed())
                # DoGraphCopy analog, keyed by wave ordinal within the epoch
                prof.log_step(prof.step_key(epoch, waves[0]),
                              "L2_graph_copy_time", t.passed())
                if prof.trace_enabled:
                    prof.trace_event(waves[0], "kL2Event_Copy_Graph",
                                     t._start * 1e6, Timer.now_us())
            waves[0] += 1

        # 2-stage group pipeline (dist_loops_arch5.cc:106-147): the host
        # miss gather and staging of group k+1 run on a worker thread while
        # group k trains. Only with host-resident features; stage-profiled
        # runs stay serial so the timers mean what they say.
        pipelined = cfg.pipeline and not self.feat_on_trainer and not stages
        consumed = [0]   # real batches trained by the main (T-wide) loop
        depth = max(1, cfg.max_copying_jobs)
        with ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix="fgnn-prep") as pool:
            self._pipe = _GroupPipe(self, pool) if pipelined else None
            try:
                more = True
                while more or in_flight:
                    while more and len(in_flight) < depth:
                        more = launch_wave()
                    if in_flight:
                        drain_wave()
                    while (len(pending) >= T
                           and self._main_loop_may_train(consumed[0])):
                        group = [pending.popleft() for _ in range(T)]
                        consumed[0] += len(group)
                        self._train_group(group, T, self._group_devices(T))
                if self._pipe is not None:
                    self._pipe.finish()   # pipelined groups before the tail
                # tail: sampling is finished and the samplers idle; the
                # switcher enlarges the group here
                self._train_tail(pending)
                if self._pipe is not None:
                    self._pipe.finish()
            finally:
                self._pipe = None

        stats = torch.stack(self._stats).cpu() if self._stats else None
        overflowed = any(bool(torch.stack(v).any()) for v in ovfs.values())
        n_edges = sum(int(torch.stack(v).sum()) for v in edges.values())
        self._surface_overflow(epoch, overflowed)
        epoch_time = t_epoch.passed()
        prof.log_epoch_add(epoch, "epoch_total_time", epoch_time)
        self._maybe_save(epoch)
        out = {
            "epoch": epoch,
            "epoch_time": epoch_time,
            "loss": float(stats[:, 0].mean()) if stats is not None else 0.0,
            "acc": float(stats[:, 1].mean()) if stats is not None else 0.0,
            "num_step": self.num_step,
            "sampled_edges": n_edges,
        }
        if self.cache is not None:
            row = self.ds.feat_dim * self.cache.dtype.itemsize
            out["miss_bytes"] = self._rows[0] * row
            out["feature_bytes"] = self._rows[1] * row
        return out

    def _main_loop_may_train(self, consumed: int) -> bool:
        """Hook: may the main loop keep forming T-wide groups? The
        switcher reserves the epoch's last batches for its tail."""
        return True

    def _train_tail(self, pending: deque) -> None:
        """Train what is left once sampling is finished, in T-wide
        groups (the last one short)."""
        T = self.roles.num_trainer
        while pending:
            group = [pending.popleft() for _ in range(min(T, len(pending)))]
            self._train_group(group, T, self._group_devices(T))

    def _group_gens(self, width: int, devices) -> list:
        """Dropout generators of a group, keyed (epoch, group, worker)."""
        base = ((self._cur_epoch * self.num_step + self._group_ordinal)
                * (self.roles.num_sampler + self.roles.num_trainer))
        return [self._dropout_gen(dev, base + i) for i, dev in enumerate(devices)]

    def _train_group(self, group: list, width: int,
                     devices: Sequence[torch.device]) -> None:
        """Pad a group to ``width`` by repeating its first batch (the
        repeats keep weight w > 0, fgnn_tpu/parallel/factored.py:641-649),
        move batch i to ``devices[i]`` and train it: through the pipeline,
        or here."""
        group = list(group) + [group[0]] * (width - len(group))
        t0_dev = self.roles.trainer_devices[0]
        items = [self.transport.cross(bi, t0_dev, dev)
                 for bi, dev in zip(group, devices)]
        gens = self._group_gens(width, devices)
        self._group_ordinal += 1
        if self._pipe is not None:
            self._pipe.submit(items, devices, gens)
            return
        prof = Profiler.get()
        stages = self._prof_stages
        t = Timer()
        feats = [self._feats_for(b, ix, dev)
                 for (b, ix), dev in zip(items, devices)]
        if stages:
            for dev in set(devices):
                device_sync(dev)
            prof.log_epoch_add(self._cur_epoch, "epoch_extract_time",
                               t.passed())
            if prof.trace_enabled:
                prof.trace_event(self._group_ordinal, "kL1Event_Copy",
                                 t._start * 1e6, Timer.now_us())
            t.reset()
        self._step_group([b for b, _ in items], feats, devices, gens)
        if stages:
            device_sync(devices[0])
            prof.log_epoch_add(self._cur_epoch, "epoch_train_time", t.passed())
            if prof.trace_enabled:
                prof.trace_event(self._group_ordinal, "kL1Event_Train",
                                 t._start * 1e6, Timer.now_us())

    def _step_group(self, batches, feats, devices, gens) -> None:
        """The optimizer step of one group; its (loss, acc) joins the
        epoch's stats."""
        loss, acc = self._dp_step(list(zip(batches, feats)), devices, gens)
        self._stats.append(torch.stack([loss.float(), acc.float()]))

    def evaluate(self, node_set: Optional[np.ndarray] = None,
                 rand: Optional[Callable[[int], Sequence[torch.Tensor]]] = None
                 ) -> float:
        """Test accuracy (train_accuracy.py analog): sampler 0 samples,
        trainer 0 extracts and evaluates. ``rand(step)`` injects a step's
        uniforms (:meth:`uniform_shapes` with dedup)."""
        t_dev = self.roles.trainer_devices[0]
        return self._evaluate(
            self.roles.sampler_devices[0], t_dev, node_set, rand,
            lambda b: self._feats_for(b, None, t_dev, count=False))


class _GroupPipe:
    """The factored engine's 2-stage group pipeline. On the main thread,
    :meth:`submit` queues the copy of each batch's miss ids to the host
    (``HostFeatures.fetch``, on the trainer's stream behind the sampling,
    before the previous group's training is queued) and hands the loads to
    the worker; the worker gathers the rows on the host and uploads them on
    the copy stream; the main thread then waits for a group's upload
    events, combines and trains it. At most two groups are outstanding, so
    each host loader needs two groups' staging slots."""

    def __init__(self, eng: FactoredEngine, pool: ThreadPoolExecutor):
        self.eng = eng
        self.pool = pool
        self.jobs: deque = deque()

    def submit(self, items, devices, gens) -> None:
        splits = [self.eng._split(b, ix, dev)
                  for (b, ix), dev in zip(items, devices)]
        fetches = [c.host.fetch(ix.miss_ids,
                                torch.stack([ix.num_miss, ix.num_hit]))
                   for c, ix in splits]

        def load():
            return [c.host.load(f, c.dtype)
                    for (c, _), f in zip(splits, fetches)]

        self.jobs.append((self.pool.submit(load), items, splits, devices,
                          gens))
        self.train(block=False)

    def train(self, block: bool) -> None:
        """Train finished groups, in order; all of them if ``block``, else
        every group but the newest and any whose loads are done."""
        while self.jobs and (block or len(self.jobs) > 1
                             or self.jobs[0][0].done()):
            job, items, splits, devices, gens = self.jobs.popleft()
            feats = []
            for (rows, (miss, hit), ready), (c, ix) in zip(job.result(),
                                                           splits):
                c.host.ready(ready)
                self.eng._count_rows(miss, hit)
                feats.append(c.combine(ix, rows, miss))
            self.eng._step_group([b for b, _ in items], feats, devices, gens)

    def finish(self) -> None:
        self.train(block=True)


class SGNNEngine(_EngineBase):
    """arch6: every device samples, extracts and trains its own batch.

    ``devices``: at least W = ``cfg.num_train_worker`` devices. The feature
    table sits on each of them. The last hop skips dedup (the table is on
    the device, where a duplicate row costs less than the dedup), except
    for GCN, whose out-degree normalisation counts duplicates
    (fgnn_tpu/parallel/factored.py:769-773). ``rand_fn(epoch, step)``
    injects batch ``step``'s uniforms (step = local * W + w, the aligned
    shuffler's global step)."""

    def __init__(self, cfg: RunConfig, ds: Dataset, devices: Sequence,
                 rand_fn: Optional[RandFn] = None):
        self._setup_common(cfg, ds, rand_fn)
        W = cfg.num_train_worker
        self.devices = make_data_mesh(W, devices)
        t_copy = Timer()
        for dev in self.devices:
            self._graph(dev)
            self._feat_table(dev)
            self._label(dev)
            device_sync(dev)
        Profiler.get().log_init("init_copy", t_copy.passed())
        seed_cap = self.plan.num_input_cap[0]
        self.shufflers = [
            AlignedDistShuffler(ds.train_set, cfg.batch_size, seed_cap, w, W,
                                base_seed=cfg.seed)
            for w in range(W)]
        self.num_local_step = self.shufflers[0].num_local_step
        self.num_step = self.num_local_step * W   # padding steps included
        Profiler.get().set_num_step(self.num_step)
        self.dedup_last_hop = cfg.model == "gcn"
        self._init_model(self.devices[0])
        self._restore()
        log.info("SGNNEngine: %d workers, %d local steps/epoch", W,
                 self.num_local_step)

    def run_epoch(self, epoch: int) -> dict:
        """Every local step: each worker samples and gathers its batch,
        then one data-parallel step over the W batches. At profile level 2
        or higher (or with a trace) each stage ends in a device sync and
        writes its time (the reference's de-fused profiled path,
        fgnn_tpu/parallel/factored.py:869-1017). The reference's
        whole-epoch ``lax.scan`` is XLA's and is not copied."""
        prof = Profiler.get()
        stages = self._prof_stages
        t_epoch = Timer()
        cap = self.plan.num_input_cap[0]
        rows = [epoch_rows(sh, dev, epoch, cap)
                for sh, dev in zip(self.shufflers, self.devices)]
        stats, ovfs, edges = [], [], []
        for local in range(self.num_local_step):
            skey = prof.step_key(epoch, local)
            t = Timer()
            batches, gens = [], []
            for w, dev in enumerate(self.devices):
                seeds, nums, steps = rows[w]
                index = epoch * SGNN_EPOCH_STRIDE + steps[local]
                batch = self.sample(dev, seeds[local], nums[local],
                                    self._draws(dev, epoch, steps[local],
                                                index),
                                    self.dedup_last_hop)
                if self.sanity is not None:
                    self.sanity.check_batch(batch, self.plan)
                batches.append(batch)
                gens.append(self._dropout_gen(dev, index))
                ovfs.append(batch.overflowed.to(self.devices[0]))
                edges.append(_edges(batch).to(self.devices[0]))
            if stages:
                self._stage(epoch, skey, "sample", t)
            feats = [self.feat_gather(self._feat_table(dev), b.input_nodes)
                     for b, dev in zip(batches, self.devices)]
            if stages:
                self._stage(epoch, skey, "copy", t)
            loss, acc = self._dp_step(list(zip(batches, feats)), self.devices,
                                      gens)
            if stages:
                self._stage(epoch, skey, "train", t)
            stats.append(torch.stack([loss.float(), acc.float()]))
        s = torch.stack(stats).cpu()
        self._surface_overflow(epoch, bool(torch.stack(ovfs).any()))
        n_edges = int(torch.stack(edges).sum())
        epoch_time = t_epoch.passed()
        prof.log_epoch_add(epoch, "epoch_total_time", epoch_time)
        self._maybe_save(epoch)
        return {
            "epoch": epoch,
            "epoch_time": epoch_time,
            "loss": float(s[:, 0].mean()),
            "acc": float(s[:, 1].mean()),
            "num_step": self.num_step,
            "sampled_edges": n_edges,
        }

    _STAGE_ITEMS = {
        "sample": ("epoch_sample_time", "L1_sample_time", "kL1Event_Sample"),
        "copy": ("epoch_extract_time", "L1_copy_time", "kL1Event_Copy"),
        "train": ("epoch_train_time", "L1_train_time", "kL1Event_Train"),
    }

    def _stage(self, epoch: int, skey: int, name: str, t: Timer) -> None:
        """End a profiled stage: sync every worker, write its epoch and
        step items and its trace lane, restart the timer."""
        for dev in set(self.devices):
            device_sync(dev)
        epoch_item, step_item, lane = self._STAGE_ITEMS[name]
        prof = Profiler.get()
        prof.log_epoch_add(epoch, epoch_item, t.passed())
        prof.log_step(skey, step_item, t.passed())
        if prof.trace_enabled:
            prof.trace_event(skey, lane, t._start * 1e6, Timer.now_us())
        t.reset()

    def evaluate(self, node_set: Optional[np.ndarray] = None,
                 rand: Optional[Callable[[int], Sequence[torch.Tensor]]] = None
                 ) -> float:
        """Test accuracy on worker 0 (train_accuracy.py analog)."""
        dev = self.devices[0]
        return self._evaluate(
            dev, dev, node_set, rand,
            lambda b: self.feat_gather(self._feat_table(dev), b.input_nodes))
