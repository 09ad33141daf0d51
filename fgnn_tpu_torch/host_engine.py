"""Host-sampling engine, arch0 (port of ``fgnn_tpu/host_engine.py``).

The source system's CPUEngine (cpu_engine.cc): sampling, dedup and the
feature gather run on the host; each step's batch and rows are uploaded and
the device trains on them. The samplers and the dedup are the port's C++
library (:mod:`fgnn_tpu_torch.ops.host_lib`, a copy of the reference's
``fgnn_tpu/native`` samplers, bit-equal to them). The NumPy hop functions
below are their plain versions, the reference's own NumPy samplers: the
engine uses them for a hop wider than ``host_lib.MAX_FANOUT``, as the
reference does, and tests use them with ``plain=True``.

What decides the numbers follows the reference:
  * the model is built without a compute dtype, so arch0 trains in float32
    whatever ``cfg.compute_dtype`` says, and its rows are gathered and
    uploaded in float32;
  * ``rng = default_rng(cfg.seed)`` draws every batch; the constructor
    samples one batch from it (the reference's parameter-shaping batch), so
    epoch 0's batches are the reference's;
  * the presample ranking draws from ``default_rng(cfg.seed + 41)``.

Every hop dedups (the host sampler has no no-dedup hop), so each layer's
``gather_src`` runs the row-gather kernel on a CUDA device; a static cache's
combine runs it once more. Unlike the reference, a batch whose new nodes
overflowed a unique cap reports ``overflowed`` (the reference reports
False and clips silently).

An epoch writes the reference's profiler items (fgnn_tpu/host_engine.py:
395-465): the L1 stage times, ``L2_extract_time`` at level 2 and the epoch
items, with a device sync after the copy and the train stage at level 2
or higher. Beyond the reference, the checker and node access read each host
batch.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .cache.manager import FeatureCache
from .cache.policy import build_ranking
from .config import CachePolicy, RunConfig, SampleType
from .data.schema import Dataset
from .data.synthetic import build_alias_tables
from .engine import OneChipEngine, device_sync
from .models.gnn import build_model
from .ops import host_lib
from .ops.extract import HostFeatures, label_gather
from .ops.padding import SamplePlan, make_plan
from .ops.reference_impl import calibrate_caps, np_sample_hop_vec
from .ops.sampling import Block, SampledBatch
from .ops.sanity import make_checker
from .parallel.shuffler import EpochShuffler
from .train.loop import make_optimizer, train_step
from .utils import Timer, get_logger
from .utils.profiler import Profiler

log = get_logger(__name__)

WEIGHTED = (SampleType.WEIGHTED_KHOP, SampleType.WEIGHTED_KHOP_PREFIX,
            SampleType.WEIGHTED_KHOP_HASH_DEDUP)


def _lib_seed(rng: np.random.Generator) -> int:
    """The seed of one hop's library call: the reference draws it whether
    or not its library is built, so the NumPy path draws it too."""
    return int(rng.integers(0, 2**62))


def _np_khop_hop(rng, indptr, indices, cur, f, replace, plain=False):
    """One uniform khop hop (cpu_sampling_khop0.cc analog): the library's
    sampler, or with ``plain`` (or ``f > MAX_FANOUT``) the reference's NumPy
    one. Returns ([S, f] int32 -1-padded, None)."""
    seed = _lib_seed(rng)
    if not plain and f <= host_lib.MAX_FANOUT:
        return host_lib.sample_khop(indptr, indices, cur, f, seed,
                                    replace), None
    S = cur.shape[0]
    valid_in = cur >= 0
    nbr = np.full((S, f), -1, dtype=np.int32)
    if valid_in.any():
        vs = cur[valid_in].astype(np.int64)
        got, gv = np_sample_hop_vec(rng, indptr, indices, vs, f, replace)
        nbr[valid_in] = np.where(gv, got, -1)
    return nbr, None


def _np_weighted_hop(rng, indptr, indices, gcum, cur, f, dedup=False,
                     plain=False):
    """Weighted hop by inverse CDF on the GLOBAL weight cumsum ``gcum``
    (cpu_sampling_weighted_khop.cc analog). ``dedup`` makes a row's picks
    distinct, the hash-dedup semantics: take-all when ``deg <= f``, else
    the first f distinct of 4f draws, then an exact rejection loop for
    short rows. The library's sampler unless ``plain`` (or ``f >
    MAX_FANOUT``). Returns ([S, f] int32 -1-padded, None)."""
    seed = _lib_seed(rng)
    if not plain and f <= host_lib.MAX_FANOUT:
        return host_lib.sample_weighted_khop(indptr, indices, gcum, cur, f,
                                             seed, dedup), None
    S = cur.shape[0]
    valid_in = cur >= 0
    safe = np.maximum(cur, 0).astype(np.int64)
    off = np.asarray(indptr)[safe]
    end = np.asarray(indptr)[safe + 1]
    deg = (end - off).astype(np.int64)
    gpad = np.concatenate([[0.0], gcum])
    base = gpad[off]
    tot = gpad[end] - base
    ok = valid_in & (deg > 0)

    def draw(cols):
        u = rng.random((S, cols)) * tot[:, None]
        e = np.searchsorted(gcum, base[:, None] + u, side="left")
        return np.clip(e, off[:, None], (end - 1)[:, None])

    if not dedup:
        e = draw(f)
        return np.where(ok[:, None], indices[e], -1).astype(np.int32), None

    # hash-dedup: f distinct picks (take-all when deg <= f)
    T = 4 * f
    e = draw(T)
    order = np.argsort(e, axis=1, kind="stable")
    sv = np.take_along_axis(e, order, axis=1)
    first = np.concatenate([np.ones((S, 1), bool), sv[:, 1:] != sv[:, :-1]],
                           axis=1)
    spos = np.sort(np.where(first, order, T), axis=1)[:, :f]
    picks = np.take_along_axis(e, np.minimum(spos, T - 1), axis=1)
    got = np.where(spos < T, picks, -1)
    want = np.minimum(deg, f)
    small = deg <= f
    if small.any():
        col = np.arange(f)[None, :]
        allp = off[:, None] + col
        got[small] = np.where(col < deg[small, None], allp[small], -1)
    # the exact rejection finish for rows still short (the reference loop)
    short = ok & ((got >= 0).sum(1) < want)
    for i in np.nonzero(short)[0]:
        have = set(int(x) for x in got[i] if x >= 0)
        while len(have) < int(want[i]):
            u = rng.random() * tot[i]
            x = int(np.clip(np.searchsorted(gcum, base[i] + u), off[i],
                            end[i] - 1))
            have.add(x)
        got[i] = list(have)[:f] + [-1] * (f - len(have))
    nbr = np.where(ok[:, None] & (got >= 0), indices[np.maximum(got, 0)], -1)
    return nbr.astype(np.int32), None


def _np_random_walk_hop(rng, indptr, indices, cur, K, W, L, restart,
                        plain=False):
    """PinSAGE hop (cpu_sampling_random_walk.cc + FrequencyHashmap analog):
    W walks of length L per vertex, each ending after a step with
    probability ``restart``, then per row the K most visited by multiplicity
    (ties to the earlier first visit). The library's sampler unless
    ``plain``. Returns ([S, K] neighbours, [S, K] float32 visit counts)."""
    seed = _lib_seed(rng)
    if not plain:
        return host_lib.sample_random_walk(indptr, indices, cur, W, L,
                                           restart, K, seed)
    S = cur.shape[0]
    node = np.broadcast_to(cur[:, None], (S, W)).astype(np.int32).copy()
    visits = np.full((S, W, L), -1, dtype=np.int32)
    E = len(indices)
    for step in range(L):
        alive = node >= 0
        safe = np.maximum(node, 0).astype(np.int64)
        off = np.asarray(indptr)[safe]
        deg = (np.asarray(indptr)[safe + 1] - off).astype(np.int64)
        pick = np.minimum((rng.random((S, W)) * deg).astype(np.int64),
                          np.maximum(deg - 1, 0))
        nxt = indices[np.clip(off + pick, 0, E - 1)]
        okw = alive & (deg > 0)
        vis = np.where(okw, nxt, -1).astype(np.int32)
        visits[:, :, step] = vis
        die = rng.random((S, W)) < restart
        node = np.where(okw & ~die, vis, -1)
    flat = visits.reshape(S, W * L)
    M = flat.shape[1]
    eq = flat[:, :, None] == flat[:, None, :]
    valid = flat >= 0
    count = (eq & valid[:, None, :]).sum(axis=2)
    iota = np.arange(M)
    first = (eq & (iota[None, None, :] < iota[None, :, None])).sum(axis=2) == 0
    score = np.where(valid & first, count, 0)
    k_eff = min(K, M)
    topi = np.argsort(-score, axis=1, kind="stable")[:, :k_eff]
    topv = np.take_along_axis(score, topi, axis=1)
    dst = np.take_along_axis(flat, topi, axis=1)
    okk = topv > 0
    dst = np.where(okk, dst, -1)
    w = np.where(okk, topv.astype(np.float32), 0.0)
    if k_eff < K:
        dst = np.pad(dst, ((0, 0), (0, K - k_eff)), constant_values=-1)
        w = np.pad(w, ((0, 0), (0, K - k_eff)))
    return dst.astype(np.int32), w


def _np_dedup_remap(cur, nbr_flat, cap, num_node):
    """The reference's NumPy dedup (a dense [num_node] table): the frontier
    keeps its slots, new ids follow ascending up to ``cap``. Returns
    ``(unique [cap], n_new, src_local)`` as ``host_lib.dedup_remap``."""
    S = cur.shape[0]
    new = np.unique(nbr_flat[nbr_flat >= 0])
    new = new[~np.isin(new, cur[cur >= 0])]
    n_new = min(len(new), cap - S)
    unique = np.full(cap, -1, dtype=np.int32)
    unique[:S] = cur
    unique[S:S + n_new] = new[:n_new]
    table = np.full(num_node + 1, -1, dtype=np.int32)
    pos = np.nonzero(unique >= 0)[0]
    table[unique[pos]] = pos
    src_local = np.where(nbr_flat >= 0, table[np.maximum(nbr_flat, 0)], -1)
    return unique, n_new, src_local


def np_multi_layer_sample(rng: np.random.Generator, indptr: np.ndarray,
                          indices: np.ndarray, seeds_pad: np.ndarray,
                          num_seeds: int, plan: SamplePlan,
                          replace: bool = False, hop_fn=None,
                          plain: bool = False) -> SampledBatch:
    """Host sampling of one batch (DoCPUSample analog, cpu_loops.cc:55-192)
    into the on-device sampler's padded layout, as CPU tensors.

    ``hop_fn(rng, cur, f, hop) -> (nbr [S, f], weights [S, f] or None)``
    overrides the uniform khop hop (weighted and random-walk variants).
    Every hop dedups, through the library or, with ``plain``, the NumPy
    table. ``overflowed`` is set when a hop's new nodes overflowed its cap.
    """
    cur = np.asarray(seeds_pad, dtype=np.int32).copy()
    num_cur = num_seeds
    overflowed = False
    blocks_rev: List[Block] = []
    for hop in range(plan.num_layer):
        f = plan.fanouts[hop]
        S = plan.num_input_cap[hop]
        cap = plan.num_unique_cap[hop]
        if hop_fn is None:
            nbr, wgt = _np_khop_hop(rng, indptr, indices, cur[:S], f, replace,
                                    plain)
        else:
            nbr, wgt = hop_fn(rng, cur[:S], f, hop)
        nbr_flat = nbr.reshape(-1)
        if plain:
            unique, n_new, src_local = _np_dedup_remap(
                cur[:S], nbr_flat, cap, len(indptr) - 1)
        else:
            unique, n_new, src_local = host_lib.dedup_remap(cur[:S], nbr_flat,
                                                            cap)
        # a valid pick without a local lost its node to the cap
        overflowed |= bool(((nbr_flat >= 0) & (src_local < 0)).any())
        dst_local = np.repeat(np.arange(S, dtype=np.int32), f)
        mask = (src_local >= 0) & (nbr_flat >= 0)
        blocks_rev.append(Block(
            src_local=torch.from_numpy(np.where(mask, src_local, -1)),
            dst_local=torch.from_numpy(np.where(mask, dst_local, -1)),
            mask=torch.from_numpy(mask),
            num_src=torch.tensor(num_cur + n_new, dtype=torch.int32),
            num_dst=torch.tensor(num_cur, dtype=torch.int32),
            weights=(None if wgt is None else torch.from_numpy(
                np.where(mask, wgt.reshape(-1), 0.0).astype(np.float32))),
            slots_per_dst=f,
        ))
        cur = unique
        num_cur = num_cur + n_new
    return SampledBatch(
        blocks=tuple(reversed(blocks_rev)),
        input_nodes=torch.from_numpy(cur),
        num_input=torch.tensor(num_cur, dtype=torch.int32),
        output_nodes=torch.from_numpy(
            np.ascontiguousarray(seeds_pad[: plan.batch_size], np.int32)),
        num_output=torch.tensor(num_seeds, dtype=torch.int32),
        overflowed=torch.tensor(overflowed),
    )


def global_weight_cumsum(indptr: np.ndarray, prefix: np.ndarray) -> np.ndarray:
    """The float64 cumsum over every edge weight, from the per-vertex
    prefix table: each vertex's first weight is its prefix value, the rest
    are the prefix's differences."""
    w = np.asarray(prefix, np.float64)
    d = np.empty_like(w)
    if w.size:
        np.subtract(w[1:], w[:-1], out=d[1:])
        d[0] = w[0]
    starts = indptr[:-1][np.diff(indptr) > 0]
    d[starts] = w[starts]
    return np.cumsum(d)


def batch_to(batch: SampledBatch, device: torch.device) -> SampledBatch:
    """A host batch on ``device``: each tensor through pinned memory and
    an asynchronous copy on a CUDA device (the pinned allocator keeps a
    buffer until its copy is done), unchanged on the CPU."""
    if device.type != "cuda":
        return batch

    def up(x):
        return None if x is None else x.pin_memory().to(device,
                                                        non_blocking=True)

    return SampledBatch(
        blocks=tuple(Block(
            src_local=up(b.src_local), dst_local=up(b.dst_local),
            mask=up(b.mask), num_src=up(b.num_src), num_dst=up(b.num_dst),
            weights=up(b.weights), slots_per_dst=b.slots_per_dst)
            for b in batch.blocks),
        input_nodes=up(batch.input_nodes), num_input=up(batch.num_input),
        output_nodes=up(batch.output_nodes), num_output=up(batch.num_output),
        overflowed=up(batch.overflowed))


class HostSamplingEngine:
    """arch0: sampling, dedup and the feature gather on the host, training
    on ``device`` (``"cpu"`` or a CUDA device; no default)."""

    def __init__(self, cfg: RunConfig, ds: Dataset,
                 device: torch.device | str):
        cfg.validate()
        self.cfg = cfg
        self.ds = ds
        self.device = dev = torch.device(device)
        prof = Profiler.get()
        prof.level = max(prof.level, cfg.profile_level)
        self.indptr = np.asarray(ds.indptr)
        self.indices = np.asarray(ds.indices)
        st = cfg.sample_type
        fan_sampling = ([cfg.num_neighbor] * cfg.num_layer_rw
                        if st == SampleType.RANDOM_WALK
                        else list(reversed(cfg.fanout)))
        caps = calibrate_caps(self.indptr, self.indices,
                              np.asarray(ds.train_set), cfg.batch_size,
                              fan_sampling, seed=cfg.seed,
                              replace=st == SampleType.KHOP1)
        self.plan = make_plan(cfg.batch_size, list(reversed(fan_sampling)),
                              ds.num_node, unique_caps=caps)

        # per-hop sampler by type (cpu_sampling_*.cc dispatch analog)
        self._hop_fn = None
        if st in WEIGHTED:
            if ds.prob_prefix_table is None:
                build_alias_tables(ds, seed=cfg.seed)
            self._gcum = global_weight_cumsum(self.indptr,
                                              ds.prob_prefix_table)
            dedup = st == SampleType.WEIGHTED_KHOP_HASH_DEDUP
            self._hop_fn = lambda rng, cur, f, hop: _np_weighted_hop(
                rng, self.indptr, self.indices, self._gcum, cur, f, dedup)
        elif st == SampleType.RANDOM_WALK:
            self._hop_fn = lambda rng, cur, K, hop: _np_random_walk_hop(
                rng, self.indptr, self.indices, cur, K, cfg.num_random_walk,
                cfg.random_walk_length, cfg.random_walk_restart_prob)

        self.dst_caps = tuple(reversed(self.plan.num_input_cap))
        self.shuffler = EpochShuffler(ds.train_set, cfg.batch_size,
                                      self.plan.num_input_cap[0],
                                      base_seed=cfg.seed)
        prof.set_num_step(self.shuffler.num_step)
        self.sanity = make_checker(cfg, ds.num_node)
        # no compute dtype: arch0 trains in float32, as the reference
        self.model = build_model(
            cfg.model, ds.feat_dim, cfg.num_hidden, ds.num_class,
            self.plan.num_layer, cfg.dropout,
            generator=torch.Generator().manual_seed(cfg.seed + 1)).to(dev)
        self.optimizer = make_optimizer(self.model.parameters(), cfg.lr,
                                        cfg.weight_decay)
        self.label_dev = torch.as_tensor(
            np.asarray(ds.label).astype(np.int64), device=dev)
        self.host_feat = HostFeatures(ds.feat, dev, mod=ds.feat_mod)
        self.dropout_gen = torch.Generator(dev).manual_seed(cfg.seed + 0x5eed)
        self.last_overflowed = False
        self.last_rows = (0, 0)
        self.last_extract_s = 0.0

        self.rng = np.random.default_rng(cfg.seed)
        # the reference samples its parameter-shaping batch from self.rng
        seeds0, n0, _ = next(self.shuffler.batches(0))
        self.sample(self.rng, seeds0, n0)

        # optional device feature cache: host sampling, hot rows on the
        # device, the host gathers only the misses (cpu_engine.cc:82-90)
        self.cache = None
        if cfg.use_cache:
            if cfg.cache_policy in (CachePolicy.PRESAMPLE,
                                    CachePolicy.PRESAMPLE_STATIC):
                ranking = self._presample_ranking()
            else:
                ranking = build_ranking(ds, cfg.cache_policy, cfg.seed)
            self.cache = FeatureCache(self.host_feat, ranking,
                                      cfg.cache_percentage, ds.num_node)
        log.info("HostSamplingEngine (arch0) on %s: %d steps/epoch, cache=%s",
                 dev, self.shuffler.num_step,
                 "off" if self.cache is None else
                 f"{cfg.cache_percentage:.0%}/{cfg.cache_policy.value}")

    # the same warning, or error under cfg.sanity_check, as the device engine
    _surface_overflow = OneChipEngine._surface_overflow

    def sample(self, rng: np.random.Generator, seeds: np.ndarray,
               num_seeds: int) -> SampledBatch:
        """One batch sampled on the host, as CPU tensors."""
        return np_multi_layer_sample(
            rng, self.indptr, self.indices, seeds, num_seeds, self.plan,
            replace=self.cfg.sample_type == SampleType.KHOP1,
            hop_fn=self._hop_fn)

    def _presample_ranking(self) -> np.ndarray:
        """PreSampler analog on the host sampler (pre_sampler.cc:57-132):
        ``presample_epoch`` epochs of the real sampler from their own
        generator, nodes ranked by access count, hottest first."""
        cfg = self.cfg
        freq = np.zeros(self.ds.num_node, dtype=np.int64)
        rng = np.random.default_rng(cfg.seed + 41)
        for ep in range(max(1, cfg.presample_epoch)):
            for seeds, n, _ in self.shuffler.batches(ep):
                ids = self.sample(rng, seeds, n).input_nodes.numpy()
                np.add.at(freq, ids[ids >= 0], 1)
        return np.argsort(-freq, kind="stable").astype(np.int32)

    def features(self, host_batch: SampledBatch,
                 batch: SampledBatch) -> torch.Tensor:
        """The batch's float32 input rows on the device: every row gathered
        on the host and uploaded, or with a cache only the misses, merged
        with the cached rows on the device. Sets ``last_rows`` to the
        step's (miss rows, feature rows) and ``last_extract_s`` to the host
        seconds of its gather (a cache's split and miss gather included):
        the Extract part of the reference's Table-1 split."""
        t = Timer()
        if self.cache is not None:
            index = self.cache.get_miss_cache_index(batch.input_nodes)
            rows, miss, hit = self.cache.upload_miss(index)
            self.last_extract_s = t.passed()
            self.last_rows = (miss, miss + hit)
            return self.cache.combine(index, rows, miss)
        host = self.host_feat
        n = int(host_batch.num_input)
        f = host.fetch(host_batch.input_nodes, host_batch.num_input.reshape(1))
        rows, _, ready = host.load(f, torch.float32, compact=False)
        self.last_extract_s = t.passed()
        host.ready(ready)
        self.last_rows = (n, n)
        return rows

    def train_on(self, batch: SampledBatch, feats: torch.Tensor):
        """One optimizer step on a device batch; device scalars (loss,
        acc)."""
        labels = label_gather(self.label_dev, batch.output_nodes)
        return train_step(self.model, self.optimizer, batch, feats, labels,
                          self.dst_caps, self.cfg.batch_size,
                          generator=self.dropout_gen)

    def step(self, seeds: np.ndarray, num_seeds: int):
        """Sample the next batch from ``self.rng``, gather, upload, train.
        Returns device scalars (loss, acc) and the host batch."""
        host_batch = self.sample(self.rng, seeds, num_seeds)
        batch = batch_to(host_batch, self.device)
        loss, acc = self.train_on(batch, self.features(host_batch, batch))
        return loss, acc, host_batch

    def run_epoch(self, epoch: int) -> dict:
        """One epoch; the reference's keys, with a cache also
        ``miss_bytes`` and ``feature_bytes`` (float32 rows). Syncs once,
        at the end, below profile level 2."""
        prof = Profiler.get()
        sync = self.cfg.profile_level >= 2
        prof.begin_node_access_epoch()
        if self.sanity is not None:
            self.sanity.reset()
        t_epoch = Timer()
        stats, rows, overflowed = [], [0, 0], False
        row_bytes = self.ds.feat_dim * 4
        for seeds, n, step in self.shuffler.batches(epoch):
            skey = prof.step_key(epoch, step)
            t = Timer()
            host_batch = self.sample(self.rng, seeds, n)
            batch = batch_to(host_batch, self.device)
            st = t.passed()
            prof.log_step(skey, "L1_sample_time", st)
            prof.log_epoch_add(epoch, "epoch_sample_time", st)
            if self.sanity is not None:
                self.sanity.check_batch(host_batch, self.plan)
            prof.log_node_access_batch(host_batch.input_nodes.numpy())
            # Table 1 splits Extract (the host gather, DoCPUFeatureExtract)
            # from Copy (the host-to-device transfer)
            t.reset()
            feats = self.features(host_batch, batch)
            if sync:
                device_sync(self.device)
            et = self.last_extract_s
            ct = t.passed() - et
            prof.log_step(skey, "L2_extract_time", et)
            prof.log_epoch_add(epoch, "epoch_extract_time", et)
            prof.log_step(skey, "L1_copy_time", ct + et)
            prof.log_epoch_add(epoch, "epoch_copy_time", ct)
            if self.cache is not None:
                miss, total = self.last_rows
                prof.log_epoch_add(epoch, "epoch_miss_bytes",
                                   float(miss * row_bytes))
                prof.log_epoch_add(epoch, "epoch_feature_bytes",
                                   float(total * row_bytes))
            t.reset()
            loss, acc = self.train_on(batch, feats)
            if sync:
                device_sync(self.device)
            prof.log_step(skey, "L1_train_time", t.passed())
            prof.log_epoch_add(epoch, "epoch_train_time", t.passed())
            stats.append(torch.stack([loss.float(), acc.float()]))
            rows = [a + b for a, b in zip(rows, self.last_rows)]
            overflowed |= bool(host_batch.overflowed)
        mean = (torch.stack(stats).cpu().mean(0) if stats   # the one sync
                else torch.zeros(2))
        epoch_time = t_epoch.passed()
        prof.log_epoch_add(epoch, "epoch_total_time", epoch_time)
        r = {
            "epoch": epoch,
            "epoch_time": epoch_time,
            "loss": float(mean[0]),
            "acc": float(mean[1]),
            "num_step": self.shuffler.num_step,
        }
        if self.cache is not None:
            r["miss_bytes"] = rows[0] * row_bytes
            r["feature_bytes"] = rows[1] * row_bytes
        self._surface_overflow(epoch, overflowed)
        return r

    def run_epochs(self, start_epoch: int, n: int) -> List[dict]:
        return [self.run_epoch(e) for e in range(start_epoch, start_epoch + n)]
