"""Balance-switcher engine, arch5 with the switcher role (port of
``fgnn_tpu/parallel/switcher.py``).

The source system's sampler GPUs finish their share of an epoch early; each
idle sampler then re-registers as a trainer (``sam.switch_init(worker, ctx,
cache_pct)``, balance_switcher/train_pinsage.py:280-309) and the epoch's
tail is trained by T + S GPUs. Here the epoch driver knows when sampling
has finished (the wave queue drains), so the tail trains in groups as wide
as the S + T devices, trainers first: one replica of the model a logical
worker, the gradients summed into the first. A device may repeat in that
list (one card can hold every role).

How much of the epoch goes to the wide groups is decided up front, as the
reference does: a one-time calibration probe times one sample wave, one
T-wide group and one (S + T)-wide group, and :func:`tail_reserve_policy`
reserves the groups the T trainers cannot finish before the samplers go
idle. ``FGNN_TPU_SWITCHER_FORCE=1`` engages a minimal tail when the probe
would decline.
"""
from __future__ import annotations

import copy
from typing import List, Optional, Sequence

import torch

from ..cache.manager import FeatureCache, miss_cache_index
from ..config import RunConfig, env_flag
from ..data.schema import Dataset
from ..engine import device_sync
from ..utils import Timer, get_logger
from .factored import FactoredEngine, step_generator

log = get_logger(__name__)

# seed of the calibration probe's draws (the reference's seed ^ 0xCA11B)
PROBE_SEED = 0xCA11B


def tail_reserve_policy(
    t_wave: float,
    num_waves: int,
    g_t: float,
    g_full: float,
    T: int,
    W: int,
    num_step: int,
    force: bool = False,
) -> int:
    """How many of the epoch's ``num_step`` batches to reserve for the full
    (T + S)-wide tail, from the calibration times: one sample wave
    (``t_wave``, ``num_waves`` an epoch), one T-wide group (``g_t``), one
    W-wide group (``g_full``).

    The reserve is the training backlog the T trainers cannot clear before
    the samplers go idle, ``K = total_groups - sample_total / g_t`` groups,
    i.e. ``K * T`` batches, engaged only when the full group pays per batch
    (``g_full / W <= g_t / T``, 5% slack). When training keeps pace
    (K <= 0) a minimal tail of ``min(W, num_step)`` batches still runs if a
    W-wide group is no slower than the T-wide groups it replaces, or when
    ``force``."""
    G = -(-num_step // T)                          # total T-groups
    sample_total = t_wave * num_waves
    k = G - int(sample_total / max(g_t, 1e-9))     # backlog groups
    k = max(0, min(k, G))
    per_t, per_full = g_t / T, g_full / W          # per-batch costs
    min_tail = min(W, num_step)
    backlog_pays = per_full <= per_t * 1.05
    min_tail_pays = (
        backlog_pays and g_full <= (-(-min_tail // T)) * g_t * 1.05
    )
    reserve = 0
    if backlog_pays:
        reserve = k * T
    if reserve == 0 and (min_tail_pays or force):
        reserve = min_tail
    return min(reserve, num_step)


class SwitcherEngine(FactoredEngine):
    """arch5 with ``have_switcher``: the sampler devices join training once
    their sampling work for the epoch is done."""

    _in_tail = False
    _tail_reserve_batches: Optional[int] = None

    def __init__(self, cfg: RunConfig, ds: Dataset, devices: Sequence,
                 **kw):
        super().__init__(cfg, ds, devices, **kw)
        self.full_devices: List[torch.device] = (
            self.roles.trainer_devices + self.roles.sampler_devices)
        self.num_full = len(self.full_devices)
        for dev in self.full_devices:
            self._label(dev)
            if self.feat_on_trainer:
                self._feat_table(dev)
        # the switcher's own feature residency: a cache sized by
        # switch_cache_percentage from the SAME ranking (sam.switch_init(...,
        # cache_percentage), train_pinsage.py:309; DoSwitchCacheFeatureCopy).
        # Tail groups split against it again: the index that came with a
        # batch was made against the trainers' cache.
        self._switch_caches = {}
        self.switch_cache = None
        if self.cache is not None and cfg.switch_cache_percentage > 0:
            self.switch_cache = self._switch_cache(self.roles.trainer_devices[0])
        log.info("SwitcherEngine: epoch tail trains on %d devices (%d "
                 "trainers + %d switchers)", self.num_full,
                 self.roles.num_trainer, self.roles.num_sampler)

    def _switch_cache(self, dev: torch.device) -> FeatureCache:
        if dev not in self._switch_caches:
            self._switch_caches[dev] = self._make_cache(
                dev, self.cfg.switch_cache_percentage)
        return self._switch_caches[dev]

    def _split(self, batch, index, dev):
        if self._in_tail and self.switch_cache is not None:
            cache = self._switch_cache(dev)
            return cache, cache.get_miss_cache_index(batch.input_nodes)
        return super()._split(batch, index, dev)

    # -- tail sizing ---------------------------------------------------------
    def _calibrate_tail_reserve(self) -> int:
        """One-time probe: the fastest of three runs each of one sample
        wave, one T-wide group and one full group, on a copy of the model
        and optimizer state that is put back afterwards, with draws no
        training step uses."""
        S, T = self.roles.num_sampler, self.roles.num_trainer
        W = self.num_full
        s_devs = self.roles.sampler_devices
        seeds, n, _ = next(iter(self.shufflers[0].batches(0)))
        gens = lambda dev, i: step_generator(dev, self.cfg.seed ^ PROBE_SEED, i)

        def one_wave():
            wave = []
            for s, dev in enumerate(s_devs):
                b = self.sample(dev, torch.as_tensor(seeds, device=dev), n,
                                gens(dev, s), True)
                ix = (miss_cache_index(self._cache_table(dev), b.input_nodes)
                      if self.cache is not None else None)
                wave.append((b, ix))
            for dev in set(s_devs):
                device_sync(dev)
            return wave

        one_wave()
        t_wave = float("inf")
        for _ in range(3):
            t = Timer()
            wave = one_wave()
            t_wave = min(t_wave, t.passed())
        t0_dev = self.roles.trainer_devices[0]
        batches = [self.transport.cross(wave[i % S], s_devs[i % S], t0_dev)
                   for i in range(max(T, W))]

        saved = (copy.deepcopy(self.model.state_dict()),
                 copy.deepcopy(self.optimizer.state_dict()))
        saved_epoch, saved_ord = self._cur_epoch, self._group_ordinal
        self._cur_epoch, self._rows, self._stats = -1, [0, 0], []

        def time_group(width, devices):
            best = float("inf")
            for _ in range(4):   # the fastest of four: the first warms up
                t = Timer()
                self._train_group(batches[:width], width, devices)
                for dev in set(devices):
                    device_sync(dev)
                best = min(best, t.passed())
            return best

        try:
            g_t = time_group(T, self._group_devices(T))
            self._in_tail = True
            g_full = time_group(W, self.full_devices)
        finally:
            self._in_tail = False
            self.model.load_state_dict(saved[0])
            self.optimizer.load_state_dict(saved[1])
            self._cur_epoch, self._group_ordinal = saved_epoch, saved_ord
            self._stats = []
        num_waves = max(sh.num_local_step for sh in self.shufflers)
        force = env_flag("FGNN_TPU_SWITCHER_FORCE")
        reserve = tail_reserve_policy(t_wave, num_waves, g_t, g_full, T, W,
                                      self.num_step, force=force)
        log.info(
            "switcher calibration: wave %.4fs x%d, T-group %.4fs x%d, "
            "full-group %.4fs -> reserve %d of %d batches for the tail%s",
            t_wave, num_waves, g_t, -(-self.num_step // T), g_full, reserve,
            self.num_step,
            " (declined: the full group measured slower per batch)"
            if reserve == 0 else "")
        return reserve

    def _main_loop_may_train(self, consumed: int) -> bool:
        if self._tail_reserve_batches is None:
            return True
        return consumed < self.num_step - self._tail_reserve_batches

    def run_epoch(self, epoch: int) -> dict:
        if self._tail_reserve_batches is None:
            self._tail_reserve_batches = self._calibrate_tail_reserve()
        return super().run_epoch(epoch)

    def _train_tail(self, pending) -> None:
        """The tail in groups of S + T, the last one short, when the
        calibration reserved one; else the T-wide groups of arch5."""
        if not pending:
            return
        if not self._tail_reserve_batches:
            return super()._train_tail(pending)
        W = self.num_full
        self.tail_batches = len(pending)
        self._in_tail = True
        try:
            while pending:
                group = [pending.popleft()
                         for _ in range(min(W, len(pending)))]
                self._train_group(group, W, self.full_devices)
        finally:
            self._in_tail = False
        log.debug("switcher tail: trained %d batches on %d devices",
                  self.tail_batches, W)
