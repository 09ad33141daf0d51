"""arch5 with a process per role (port of
``fgnn_tpu/parallel/factored_multihost.py``).

The source system dedicates whole GPUs to sampling or training, one process
each (DistEngine::SampleInit/TrainInit, dist_engine.cc:231-465; role
dispatch operation.cc:343-355). ``FactoredEngine`` drives every role device
from one process; this engine gives each role its processes, joined by
``torch.distributed`` (gloo; NCCL for the trainers' gradients):

* Ranks ``[0, num_sampler_hosts)`` sample, the others train. Each process
  takes its local role devices (``devices``; by default
  ``cuda:<rank mod visible cards>``, so two processes on one card share
  ``cuda:0``; the CPU only where ``devices`` names it). Sampler process p
  owns the global sampler slots
  ``[slot_offset[p], slot_offset[p + 1])``, one a local device; trainer
  process q the logical trainers ``[trainer_offset[q], ...)``.
* Every process builds every ``DistShuffler`` and walks every wave, so the
  schedule (which slots are live, their step ids, the T-wide groups) is
  shared state, and a batch's draws are keyed by its step as in
  ``FactoredEngine``: the run equals ``FactoredEngine`` on S + T devices
  bit for bit (tests/test_torch_multihost.py).
* A wave crosses by ``dist.broadcast`` from its sampler process, every rank
  taking part in every wave's broadcast in the same order (the reference's
  ``broadcast_one_to_all``). The sampler packs the wave's batches (and, in
  cache mode, their miss index) into fixed-layout byte images on its card
  (:class:`~.multihost.ByteCodec`, whose skeleton rank 0 broadcasts once at
  init), copies them to page-locked host memory and sends. Receivers post
  their receives up to ``max_copying_jobs`` waves ahead into a ring of
  host buffers; trainers upload each wave to their first device on a copy
  stream, as ``Transport`` does.
* With more than one trainer process the group's gradients cross by
  ``all_gather`` over the trainers' group and are summed in logical order
  on each trainer's card (:func:`~.multihost.gather_images`,
  :func:`~.multihost.apply_images`); one trainer process sums its replicas
  as ``FactoredEngine`` does. The group is NCCL's where each trainer
  process owns its cards, and the images cross card to card; where
  processes share a card (NCCL refuses two ranks on one) or run on the
  CPU, they cross through host memory over gloo. ``grad_route`` says
  which (:func:`~.multihost.grad_route`), chosen from the placement at
  init; the waves stay on the host ring either way.
* Init follows the reference (:228-240): rank 0 ranks the cache and
  broadcasts the ranking before the trainers build the ``FeatureCache``;
  the samplers keep only the node -> slot table and ship each batch's miss
  index. The reference's batch-0 broadcast (:279-294) fed flax's shape
  inference; the port's models initialise from a seeded generator, so it is
  gone.

Launch one process per role:

  FGNN_TPU_COORDINATOR=127.0.0.1:29777 FGNN_TPU_NUM_PROCESSES=2 \\
  FGNN_TPU_PROCESS_ID=<i> python -m \\
  fgnn_tpu_torch.examples.train_factored_multihost
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..cache.manager import cache_table_array, miss_cache_index
from ..config import CachePolicy, RunConfig
from ..data.schema import Dataset
from ..engine import device_sync
from ..ops.extract import label_gather
from ..train.loop import masked_cross_entropy
from ..utils import Timer, get_logger
from ..utils.profiler import Profiler
from .factored import (FactoredEngine, _GroupPipe, _edges, epoch_rows,
                       resolve_feat_on_trainer, step_generator)
from .mesh import RoleMesh
from .multihost import (ByteCodec, apply_images, default_device,
                        exchange_group, gather_images, grad_image,
                        host_buffer, placed, skeleton)
from .shuffler import DistShuffler, EpochShuffler

log = get_logger(__name__)

# the cache policies a sampler process can rank alone (the reference's list)
MULTIHOST_CACHE_POLICIES = (CachePolicy.PRESAMPLE, CachePolicy.DEGREE,
                            CachePolicy.DEGREE_HOP, CachePolicy.RANDOM,
                            CachePolicy.FAKE_OPTIMAL)


class _Uplink:
    """Host wave buffers in, device buffers out: a ring of receive buffers
    (page-locked when the device is a card) and the upload of one to the
    device on a copy stream, the consumer's stream waiting on an event. A
    ring slot is reused only after its upload has finished."""

    def __init__(self, nbytes: int, depth: int, device: torch.device):
        self.device = device
        cuda = device.type == "cuda"
        self.ring = [host_buffer(nbytes, cuda) for _ in range(depth)]
        self.done: List[Optional[torch.cuda.Event]] = [None] * depth
        self.stream = torch.cuda.Stream(device) if cuda else None

    def acquire(self, i: int) -> torch.Tensor:
        ev = self.done[i]
        if ev is not None:
            ev.synchronize()
            self.done[i] = None
        return self.ring[i]

    def upload(self, i: int, n: int) -> torch.Tensor:
        src = self.ring[i][:n]
        if self.stream is None:
            return src.to(self.device, copy=True)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = src.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(ev)
        out.record_stream(consumer)
        self.done[i] = ev
        return out


class MultihostFactoredEngine(FactoredEngine):
    """arch5 with a process per role: sampler process(es) -> broadcast ->
    trainer process(es). Subclasses ``FactoredEngine`` for the trainer-side
    machinery (features, the cache and its pipeline, the data-parallel
    step, checkpoints); init and the epoch loop are role-split.

    ``devices``: this process's role devices (default: one,
    :func:`~.multihost.default_device`, which raises where there is no
    card). ``feat_on_trainer``: as
    ``FactoredEngine``'s, decided on the first trainer process's first
    device and shared with every rank. ``cfg.num_sample_worker`` and
    ``cfg.num_train_worker`` are not read: the roles come from the
    processes and their devices."""

    # pylint: disable=super-init-not-called
    def __init__(self, cfg: RunConfig, ds: Dataset,
                 num_sampler_hosts: int = 1,
                 devices: Optional[Sequence] = None,
                 feat_on_trainer: Optional[bool] = None):
        if not dist.is_initialized():
            raise RuntimeError(
                "MultihostFactoredEngine needs torch.distributed "
                "(multihost.initialize_from_env); use FactoredEngine for "
                "every role in one process")
        # this process's devices first: without a card, the CPU only when
        # named
        local = [torch.device(d) for d in (devices or [default_device()])]
        world = dist.get_world_size()
        if not 1 <= num_sampler_hosts < world:
            raise ValueError(f"{num_sampler_hosts} sampler processes of "
                             f"{world}: each role needs a process")
        self._setup_common(cfg, ds, None)
        self.num_sampler_hosts = num_sampler_hosts
        self.proc = dist.get_rank()
        self.is_sampler_host = self.proc < num_sampler_hosts
        self.first_trainer = num_sampler_hosts
        self.local_devices = local
        if local[0].type == "cuda":
            # the process's own card: no context of it lands on cuda:0
            torch.cuda.set_device(local[0])
        self.roles = RoleMesh(local if self.is_sampler_host else [],
                              [] if self.is_sampler_host else local)
        prof = Profiler.get()
        t0 = Timer()
        self.dedup_last_hop = True

        # every rank's devices and the first trainer's table decision
        decision = -1
        if not self.is_sampler_host:
            try:
                decision = int(resolve_feat_on_trainer(
                    cfg, ds, self.compute_dtype, local[0], feat_on_trainer))
            except ValueError:
                decision = -2
        infos: List = [None] * world
        dist.all_gather_object(infos, (placed(local), decision))
        placements = [p for p, _ in infos]
        counts = [len(p) for p in placements]
        decision = infos[self.first_trainer][1]
        if decision == -2:
            # the first trainer refused its table: every rank raises that
            resolve_feat_on_trainer(cfg, ds, self.compute_dtype,
                                    torch.device("cpu"), False)
        self.feat_on_trainer = bool(decision)
        self.slot_counts = counts[:num_sampler_hosts]
        self.slot_offset = np.concatenate([[0], np.cumsum(self.slot_counts)])
        self.trainer_counts = counts[num_sampler_hosts:]
        self.trainer_offset = np.concatenate(
            [[0], np.cumsum(self.trainer_counts)])
        self.S = int(self.slot_offset[-1])
        self.T = int(self.trainer_offset[-1])
        q = self.proc - num_sampler_hosts
        self.t_lo = 0 if self.is_sampler_host else int(self.trainer_offset[q])
        self.t_hi = (0 if self.is_sampler_host
                     else int(self.trainer_offset[q + 1]))
        # the trainers' gradient exchange, over NCCL where each trainer
        # process owns its cards (every rank makes every group, in the
        # same order: dist.new_group is collective); one trainer process
        # exchanges nothing
        trainer_ranks = list(range(num_sampler_hosts, world))
        self.grad_route = None
        self.trainer_group = None
        if len(trainer_ranks) > 1:
            grp, self.grad_route = exchange_group(trainer_ranks, placements)
            if not self.is_sampler_host:
                self.trainer_group = grp
        self._grad_device = local[0] if self.grad_route == "nccl" else None

        seed_cap = self.plan.num_input_cap[0]
        self.shufflers = [
            DistShuffler(ds.train_set, cfg.batch_size, seed_cap, s, self.S,
                         base_seed=cfg.seed)
            for s in range(self.S)]
        self.num_step = self.shufflers[0].num_step
        prof.set_num_step(self.num_step)
        self.num_waves = max(sh.num_local_step for sh in self.shufflers)

        t_copy = Timer()
        if self.is_sampler_host:
            for dev in local:
                self._graph(dev)
                device_sync(dev)
        copy_s = t_copy.passed()

        # the cache: rank 0 ranks, every rank receives, before the trainers
        # init (dist_engine.cc:323-344); the samplers keep the node -> slot
        # table, the trainers the rows
        self.cache = None
        self._caches = {}
        self._cache_tables = {}
        use_cache = cfg.use_cache and not self.feat_on_trainer
        if use_cache:
            if cfg.cache_policy not in MULTIHOST_CACHE_POLICIES:
                raise ValueError(f"cache policy {cfg.cache_policy} is not "
                                 "supported across processes")
            ranking = torch.zeros(ds.num_node, dtype=torch.int64)
            if self.proc == 0:
                boot = EpochShuffler(ds.train_set, cfg.batch_size, seed_cap,
                                     base_seed=cfg.seed)
                ranking = torch.as_tensor(
                    self._ranking(local[0], boot, None), dtype=torch.int64)
            dist.broadcast(ranking, src=0)
            self.ranking = ranking.numpy()
            if self.is_sampler_host:
                table = cache_table_array(self.ranking, cfg.cache_percentage,
                                          ds.num_node)
                for dev in local:
                    self._cache_tables[dev] = torch.as_tensor(table,
                                                              device=dev)
            else:
                self.cache = self._cache(local[0])

        # the wave's byte layout: rank 0 samples a probe batch once and
        # broadcasts its skeleton
        probe = [None]
        if self.proc == 0:
            dev = local[0]
            seeds, n, step = next(self.shufflers[0].batches(0))
            b = self.sample(dev, torch.as_tensor(seeds, device=dev), n,
                            step_generator(dev, cfg.seed, step), True)
            ix = (miss_cache_index(self._cache_tables[dev], b.input_nodes)
                  if use_cache else None)
            probe = [skeleton((b, ix))]
        dist.broadcast_object_list(probe, src=0)
        self.codec = ByteCodec(probe[0])

        self.model = None
        self.optimizer = None
        self.ckpt = None
        self.start_epoch = 0
        if not self.is_sampler_host:
            t_copy.reset()
            for dev in local:
                self._label(dev)
                if self.feat_on_trainer:
                    self._feat_table(dev)
                device_sync(dev)
            copy_s += t_copy.passed()
            self._init_model(local[0])
            self._restore()
        start = torch.tensor([self.start_epoch], dtype=torch.int64)
        dist.broadcast(start, src=self.first_trainer)
        self.start_epoch = int(start)

        self._cur_epoch = 0
        self._group_ordinal = 0
        self._stats: List[torch.Tensor] = []
        self._rows = [0, 0]
        self._wsums: deque = deque()
        self._grad_codec = None
        depth = max(1, cfg.max_copying_jobs) + 1
        width = max(self.slot_counts)
        self.uplink = _Uplink(width * self.codec.nbytes, depth, local[0])
        # two staging slots: a wave is packed while the last one is sent
        self._staging = ([host_buffer(width * self.codec.nbytes,
                                      local[0].type == "cuda")
                          for _ in range(2)] if self.is_sampler_host else [])
        dist.barrier()
        prof.log_init("init_copy", copy_s)
        prof.log_init("init_other", max(0.0, t0.passed() - copy_s))
        log.info(
            "MultihostFactoredEngine rank %d of %d: %s on %s, %d sampler "
            "slots on %d process(es) + %d trainers, %d steps/epoch, "
            "%d bytes a batch, cache=%s, feat_on_trainer=%s, grad_route=%s",
            self.proc, world, "sampler" if self.is_sampler_host else "trainer",
            [str(d) for d in local], self.S, num_sampler_hosts, self.T,
            self.num_step, self.codec.nbytes,
            f"{cfg.cache_percentage:.0%}" if use_cache else "off",
            self.feat_on_trainer, self.grad_route)

    # -- the schedule ---------------------------------------------------------
    def _live(self, wave: int, p: int) -> List[int]:
        """The global slots of sampler process ``p`` that hold a batch in
        ``wave``: a slot past its range drops out, as in FactoredEngine."""
        return [s for s in range(int(self.slot_offset[p]),
                                 int(self.slot_offset[p + 1]))
                if wave < self.shufflers[s].num_local_step]

    def _schedule(self):
        """Every broadcast of the epoch in order: (wave, process, slots)."""
        for wv in range(self.num_waves):
            for p in range(self.num_sampler_hosts):
                live = self._live(wv, p)
                if live:
                    yield wv, p, live

    # -- the epoch -------------------------------------------------------------
    def run_epoch(self, epoch: int) -> dict:
        cfg = self.cfg
        self._cur_epoch = epoch
        self._rows = [0, 0]
        self._stats = []
        self._group_ordinal = 0
        self._wsums.clear()
        prof = Profiler.get()
        stages = self._prof_stages
        t_epoch = Timer()
        nb = self.codec.nbytes
        dev0 = self.local_devices[0]
        sampler = self.is_sampler_host
        mine = {}
        if sampler:
            lo = int(self.slot_offset[self.proc])
            cap = self.plan.num_input_cap[0]
            for s in range(lo, int(self.slot_offset[self.proc + 1])):
                dev = self.local_devices[s - lo]
                mine[s] = (dev, iter(list(zip(*epoch_rows(
                    self.shufflers[s], dev, epoch, cap)))))
        sched = list(self._schedule())
        depth = len(self.uplink.ring)
        posted: deque = deque()   # (schedule index, ring slot, work)
        sent: deque = deque()     # this process's broadcasts in flight
        nxt = [0]
        n_sent = [0]
        wave_bytes = 0
        wait_s = 0.0
        ovfs, edges = [], []
        pending: deque = deque()

        def post() -> None:
            """Post the receives of the next broadcasts while the ring has
            room, up to this process's own next wave: every rank issues
            the epoch's broadcasts in schedule order."""
            while nxt[0] < len(sched) and len(posted) < depth - 1:
                k = nxt[0]
                _, p, live = sched[k]
                if p == self.proc:
                    return
                slot = k % depth
                buf = self.uplink.acquire(slot)[:len(live) * nb]
                posted.append((k, slot, dist.broadcast(buf, src=p,
                                                       async_op=True)))
                nxt[0] += 1

        def send(k: int) -> None:
            """Sample this process's part of a wave, pack it on the card,
            copy it to host staging and start its broadcast; the staging
            slot's previous broadcast is waited for first."""
            _, p, live = sched[k]
            t = Timer()
            parts = []
            for s in live:
                dev, it = mine[s]
                seeds, num, step = next(it)
                batch = self.sample(
                    dev, seeds, num,
                    self._draws(dev, epoch, step, epoch * self.num_step + step),
                    True)
                idx = (miss_cache_index(self._cache_tables[dev],
                                        batch.input_nodes)
                       if self._cache_tables else None)
                ovfs.append(batch.overflowed.to(dev0))
                edges.append(_edges(batch).to(dev0))
                parts.append(self.codec.pack((batch, idx)))
            if len(sent) == len(self._staging):
                sent.popleft().wait()
            buf = self._staging[n_sent[0] % len(self._staging)][
                :len(live) * nb]
            n_sent[0] += 1
            for i, part in enumerate(parts):
                buf[i * nb:(i + 1) * nb].copy_(part, non_blocking=True)
            for dev in {d for d, _ in mine.values()}:
                device_sync(dev)
            if stages:
                prof.log_epoch_add(epoch, "epoch_sample_time", t.passed())
            sent.append(dist.broadcast(buf, src=p, async_op=True))
            nxt[0] += 1

        def receive() -> None:
            nonlocal wave_bytes, wait_s
            k, slot, work = posted.popleft()
            live = sched[k][2]
            t = Timer()
            work.wait()
            dt = t.passed()
            wait_s += dt
            wave_bytes += len(live) * nb
            if stages:
                prof.log_epoch_add(epoch, "epoch_copy_time", dt)
            if sampler:
                return
            wave = self.uplink.upload(slot, len(live) * nb)
            for i in range(len(live)):
                batch, idx = self.codec.unpack(wave[i * nb:(i + 1) * nb])
                if self.sanity is not None:
                    self.sanity.check_batch(batch, self.plan)
                # a copy: a view would hold the whole wave for the epoch
                ovfs.append(batch.overflowed.clone())
                edges.append(_edges(batch))
                pending.append((batch, idx))

        T = self.T
        pipelined = (not sampler and cfg.pipeline and not self.feat_on_trainer
                     and not stages)
        with ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix="fgnn-prep") as pool:
            self._pipe = _GroupPipe(self, pool) if pipelined else None
            try:
                for k in range(len(sched)):
                    post()
                    if sched[k][1] == self.proc:
                        send(k)
                        wave_bytes += len(sched[k][2]) * nb
                    else:
                        receive()
                    # groups of T in FIFO order, as FactoredEngine forms them
                    while len(pending) >= T:
                        group = [pending.popleft() for _ in range(T)]
                        self._train_group(group, T, self.local_devices)
                t = Timer()
                while sent:
                    sent.popleft().wait()
                wait_s += t.passed()
                if self._pipe is not None:
                    self._pipe.finish()
                if not sampler:
                    self._train_tail(pending)
                if self._pipe is not None:
                    self._pipe.finish()
            finally:
                self._pipe = None

        stats = torch.stack(self._stats).cpu() if self._stats else None
        overflowed = bool(torch.stack(ovfs).any()) if ovfs else False
        n_edges = int(torch.stack(edges).sum()) if edges else 0
        dist.barrier()
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
            "role": "sampler" if sampler else "trainer",
            "wave_bytes": wave_bytes,
            "wave_wait_s": wait_s,
        }
        if self.cache is not None:
            row = self.ds.feat_dim * self.cache.dtype.itemsize
            out["miss_bytes"] = self._rows[0] * row
            out["feature_bytes"] = self._rows[1] * row
        return out

    def _train_tail(self, pending: deque) -> None:
        T = self.T
        while pending:
            group = [pending.popleft() for _ in range(min(T, len(pending)))]
            self._train_group(group, T, self.local_devices)

    # -- a group, across trainer processes ----------------------------------
    def _train_group(self, group: list, width: int,
                     devices: Sequence[torch.device]) -> None:
        """Pad the group to the T logical trainers as FactoredEngine does;
        this process trains its logical workers ``[t_lo, t_hi)`` on its
        devices. The group's weight sum is taken over all T batches, which
        every trainer process holds."""
        group = list(group) + [group[0]] * (width - len(group))
        ws = [(b.num_output > 0).float().to(devices[0]) for b, _ in group]
        self._wsums.append(torch.stack(ws).sum().clamp(min=1.0))
        local = group[self.t_lo:self.t_hi]
        super()._train_group(local, len(local), devices)

    def _group_gens(self, width: int, devices) -> list:
        """Dropout generators keyed (epoch, group, logical worker) with the
        global S + T and this process's logical ids."""
        base = ((self._cur_epoch * self.num_step + self._group_ordinal)
                * (self.S + self.T))
        return [self._dropout_gen(dev, base + self.t_lo + i)
                for i, dev in enumerate(devices)]

    def _step_group(self, batches, feats, devices, gens) -> None:
        wsum = self._wsums.popleft()
        if self.trainer_group is None:
            loss, acc = self._dp_step(list(zip(batches, feats)), devices, gens)
        else:
            loss, acc = self._exchange_step(batches, feats, devices, gens,
                                            wsum)
        self._stats.append(torch.stack([loss.float(), acc.float()]))

    def _exchange_step(self, batches, feats, devices, gens, wsum):
        """``_dp_step`` across trainer processes: each local replica backs
        out its term l_i w_i / sum(w) (the sum over all T), its gradients
        cross in one all_gather, and every trainer process sums all T in
        logical order and takes the same Adam step."""
        B = self.cfg.batch_size
        dev0 = devices[0]
        self.optimizer.zero_grad(set_to_none=True)
        images = []
        for i, (batch, f, dev, gen) in enumerate(zip(batches, feats, devices,
                                                     gens)):
            model = self._replica(i, dev)
            if i:
                model.zero_grad(set_to_none=True)
            model.train()
            logits = model(batch, f, self.dst_caps, generator=gen)
            labels = label_gather(self._label(dev), batch.output_nodes)
            l, a = masked_cross_entropy(logits[:B], labels[:B])
            w = (batch.num_output > 0).float()
            (l * w / wsum.to(dev)).backward()
            image = grad_image(list(model.parameters()), l.detach() * w,
                               a * w)
            if self._grad_codec is None:
                self._grad_codec = ByteCodec(skeleton(image))
            images.append(self._grad_codec.pack(image))
        gathered = gather_images(images, self._grad_codec.nbytes,
                                 self.trainer_group, self.trainer_counts,
                                 self._grad_device)
        loss, acc = apply_images(self.model, gathered, self._grad_codec, dev0)
        self.optimizer.step()
        return loss / wsum, acc / wsum

    # -- checkpoints ----------------------------------------------------------
    def _maybe_save(self, epoch: int) -> None:
        """The first trainer process saves; every trainer restored at init."""
        if self.proc == self.first_trainer:
            super()._maybe_save(epoch)

    def _restore(self) -> None:
        super()._restore()
        if self.proc != self.first_trainer:
            self.ckpt = None

    def evaluate(self, node_set=None, rand=None) -> float:
        raise NotImplementedError(
            "evaluate() on the multihost factored engine: run accuracy "
            "reporting from a trainer process with its own sampler, or "
            "use the single-host engine for eval")
