"""A process per role (port of ``fgnn_tpu/parallel/multihost.py``).

The source system runs one process per GPU: sampler processes and trainer
processes joined by a shared-memory queue, a process-shared barrier, and a
shared-mmap ``ranking_nodes`` that sampler worker 0 fills before the
trainers init (dist_engine.cc:115-127, 323-344). The reference maps those
onto JAX's multi-process runtime; the port maps them onto
``torch.distributed`` over gloo, whose collectives move CPU tensors:

  fork + shm queue        -> ``dist.broadcast`` of a fixed-layout byte image
                             (:class:`ByteCodec`) staged in host memory
  DistSharedBarrier       -> ``dist.barrier``
  shared-mmap ranking     -> rank 0 presamples, ``dist.broadcast``
  DistShuffler host shard -> the same epoch-seeded permutation on every
                             process, each taking its step range
  gradient psum           -> ``dist.all_gather`` of each replica's flat
                             gradients, summed in logical order everywhere
                             (:func:`gather_images`, :func:`apply_images`;
                             no ring all-reduce, whose order would change
                             the sum's bits), over NCCL between cards that
                             each rank owns, else through host memory
                             (:func:`grad_route`, :func:`exchange_group`)

Initialisation reads the reference's variables, so one app runs in one
process or in several:

  FGNN_TPU_COORDINATOR=127.0.0.1:29777 FGNN_TPU_NUM_PROCESSES=2 \\
  FGNN_TPU_PROCESS_ID=<i> python -m fgnn_tpu_torch.examples.train_multihost

``FGNN_TPU_DIST_TIMEOUT`` (seconds, 600 by default) bounds every
collective, NCCL's too, so a lost peer fails the run instead of hanging it.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import subprocess
import tempfile
import time
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import env_int
from ..utils import get_logger

log = get_logger(__name__)

DEFAULT_TIMEOUT_S = 600
# byte offset granularity of a packed tensor: any dtype's view is aligned
ALIGN = 16


def initialize_from_env() -> bool:
    """``init_process_group("gloo")`` from the ``FGNN_TPU_*`` variables.
    Returns True when multi-process mode is active. Safe to call twice."""
    addr = os.environ.get("FGNN_TPU_COORDINATOR")
    if not addr:
        return False
    if dist.is_initialized():
        return True
    dist.init_process_group(
        "gloo", init_method=f"tcp://{addr}",
        world_size=int(os.environ["FGNN_TPU_NUM_PROCESSES"]),
        rank=int(os.environ["FGNN_TPU_PROCESS_ID"]),
        timeout=dist_timeout())
    log.info("multi-process: rank %d of %d", dist.get_rank(),
             dist.get_world_size())
    return True


def dist_timeout() -> datetime.timedelta:
    """``FGNN_TPU_DIST_TIMEOUT`` seconds (600 by default): every group's
    bound on a collective."""
    return datetime.timedelta(
        seconds=env_int("FGNN_TPU_DIST_TIMEOUT", DEFAULT_TIMEOUT_S))


def default_device(rank: Optional[int] = None) -> torch.device:
    """``cuda:<rank mod visible cards>``, so processes on a machine with
    fewer cards than processes share them. Raises where there is no card:
    a caller that wants the CPU names it."""
    rank = dist.get_rank() if rank is None else rank
    n = torch.cuda.device_count()
    if not n:
        raise RuntimeError(f"rank {rank}: no CUDA device; pass 'cpu' as "
                           "its device to run on the CPU")
    return torch.device("cuda", rank % n)


class Placed(NamedTuple):
    """A process's device as every process sees it: its name, and for a
    card its UUID, which tells two names of one card (``cuda`` and
    ``cuda:0``; two indices under different ``CUDA_VISIBLE_DEVICES``) from
    one name on two hosts. ``card`` is None for a device that is not a
    card."""
    name: str
    card: Optional[str]


def placed(local_devices: Sequence) -> List[Placed]:
    """This process's devices as :class:`Placed` (a card's UUID from its
    device properties)."""
    out = []
    for d in map(torch.device, local_devices):
        card = (str(torch.cuda.get_device_properties(d).uuid)
                if d.type == "cuda" else None)
        out.append(Placed(str(d), card))
    return out


def rank_devices(local_devices: Sequence) -> List[List[Placed]]:
    """Every process's devices, in rank order. A collective: every process
    calls it."""
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, placed(local_devices))
    return out


def global_data_mesh(local_devices: Sequence) -> List[Tuple[int, torch.device]]:
    """The data-parallel workers of every process, in rank order, as
    ``(rank, device)``: the port's counterpart of one mesh over every chip
    of every host. A collective: every process calls it."""
    return [(r, torch.device(d.name))
            for r, ds in enumerate(rank_devices(local_devices)) for d in ds]


def barrier(name: str = "fgnn") -> None:
    """DistSharedBarrier analog (the name is for the log)."""
    log.debug("barrier %s", name)
    dist.barrier()


def broadcast_from_host0(x: np.ndarray) -> np.ndarray:
    """Rank 0's array everywhere (the presample-ranking broadcast,
    dist_engine.cc:115-127); every rank passes an array of the same shape
    and dtype."""
    t = torch.from_numpy(np.ascontiguousarray(x)).clone()
    dist.broadcast(t, src=0)
    return t.numpy()


def host_step_range(num_step: int, host_id: Optional[int] = None,
                    num_hosts: Optional[int] = None) -> Tuple[int, int]:
    """Contiguous per-host step range (DistShuffler partitioning,
    dist_shuffler.cc:59-79: every worker gets num_step/num_worker steps,
    the last one the remainder)."""
    host_id = dist.get_rank() if host_id is None else host_id
    num_hosts = dist.get_world_size() if num_hosts is None else num_hosts
    per = num_step // num_hosts
    lo = host_id * per
    hi = num_step if host_id == num_hosts - 1 else lo + per
    return lo, hi


def presample_ranking_multihost(sample_fn, shuffler, num_node: int, device,
                                presample_epoch: int = 1,
                                seed: int = 0) -> np.ndarray:
    """Dist PreSampler analog: rank 0 runs the port's presample on
    ``device`` and ranks nodes by access frequency; every other rank
    receives the ranking (dist_engine.cc:323-344)."""
    if dist.get_rank() == 0:
        from ..cache.presample import presample_ranking

        ranking = presample_ranking(
            sample_fn, shuffler, num_node, device,
            presample_epoch=presample_epoch, seed=seed).astype(np.int64)
    else:
        ranking = np.zeros(num_node, np.int64)
    return broadcast_from_host0(ranking)


# -- launching a process per rank ------------------------------------------
def free_port() -> int:
    """A TCP port of this machine that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(cmds: Sequence[Sequence[str]], env: Optional[dict] = None,
                cwd: Optional[str] = None) -> List[subprocess.Popen]:
    """Start ``cmds[i]`` as rank i of ``len(cmds)``, all at once, joined
    through a free port of this machine (the ``FGNN_TPU_*`` variables that
    :func:`initialize_from_env` reads). Each one's output goes to a
    temporary file, ``proc.log``, which :func:`wait_ranks` reads."""
    port = free_port()
    procs = []
    for i, cmd in enumerate(cmds):
        e = dict(os.environ, **(env or {}))
        e.update(FGNN_TPU_COORDINATOR=f"127.0.0.1:{port}",
                 FGNN_TPU_NUM_PROCESSES=str(len(cmds)),
                 FGNN_TPU_PROCESS_ID=str(i))
        log_file = tempfile.TemporaryFile(mode="w+")
        proc = subprocess.Popen(list(cmd), stdout=log_file,
                                stderr=subprocess.STDOUT, text=True, env=e,
                                cwd=cwd)
        proc.log = log_file
        procs.append(proc)
    return procs


def wait_ranks(procs: Sequence[subprocess.Popen], timeout: float,
               grace: float = 20.0) -> List[Tuple[Optional[int], str]]:
    """Each rank's (return code, output), once all have ended. Every rank
    still running ``timeout`` seconds from now is killed, and so is every
    one still running ``grace`` seconds after a peer failed (its
    collectives would wait for the lost peer until their own timeout)."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                deadline = min(deadline, time.monotonic() + grace)
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
                p.log.seek(0, 2)
                p.log.write("\n[killed: still running at the deadline]")
    out = []
    for p in procs:
        p.log.seek(0)
        out.append((p.returncode, p.log.read()))
        p.log.close()
    return out


# -- fixed-layout byte images --------------------------------------------------
class Spec(NamedTuple):
    """A tensor's place in a skeleton: its shape and dtype."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def skeleton(obj):
    """``obj`` (tensors in dataclasses, tuples and lists) with every tensor
    replaced by its :class:`Spec`; other leaves kept. Picklable when the
    dataclasses are importable."""
    if isinstance(obj, torch.Tensor):
        return Spec(tuple(obj.shape), obj.dtype)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: skeleton(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    if isinstance(obj, (tuple, list)):
        return type(obj)(skeleton(x) for x in obj)
    return obj


def _leaves(obj, out: list) -> list:
    if isinstance(obj, (torch.Tensor, Spec)):
        out.append(obj)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _leaves(getattr(obj, f.name), out)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _leaves(x, out)
    return out


def _nbytes(spec: Spec) -> int:
    n = 1
    for s in spec.shape:
        n *= s
    return n * torch.empty((), dtype=spec.dtype).element_size()


class ByteCodec:
    """The byte image of every object shaped like one skeleton: each tensor
    at a fixed offset (aligned to :data:`ALIGN`), ``nbytes`` in all. A wave
    of k batches is k images end to end, so a receiver needs the skeleton
    once, never a pickle a step."""

    def __init__(self, skel):
        self.skeleton = skel
        self.offsets = []
        off = 0
        for spec in _leaves(skel, []):
            self.offsets.append(off)
            off += -(-_nbytes(spec) // ALIGN) * ALIGN
        self.nbytes = max(off, ALIGN)
        self._pads = {}

    def pack(self, obj) -> torch.Tensor:
        """One uint8 tensor of ``nbytes`` on the device of ``obj``'s
        tensors, built there (one copy moves it anywhere)."""
        parts = []
        for t in _leaves(obj, []):
            raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
            parts.append(raw)
            pad = -raw.numel() % ALIGN
            if pad:
                parts.append(self._pad(raw.device)[:pad])
        if not parts:
            return torch.zeros(self.nbytes, dtype=torch.uint8)
        out = torch.cat(parts)
        if out.numel() < self.nbytes:
            out = torch.cat([out, self._pad(out.device)[:self.nbytes
                                                        - out.numel()]])
        return out

    def _pad(self, dev: torch.device) -> torch.Tensor:
        if dev not in self._pads:
            self._pads[dev] = torch.zeros(ALIGN, dtype=torch.uint8, device=dev)
        return self._pads[dev]

    def unpack(self, buf: torch.Tensor):
        """The object over ``buf`` (``nbytes`` uint8): its tensors are views
        of ``buf``, on ``buf``'s device."""
        it = iter(self.offsets)

        def build(s):
            if isinstance(s, Spec):
                off = next(it)
                n = _nbytes(s)
                return buf[off:off + n].view(s.dtype).view(s.shape)
            if dataclasses.is_dataclass(s) and not isinstance(s, type):
                return dataclasses.replace(s, **{
                    f.name: build(getattr(s, f.name))
                    for f in dataclasses.fields(s)})
            if isinstance(s, (tuple, list)):
                return type(s)(build(x) for x in s)
            return s

        return build(self.skeleton)


def host_buffer(nbytes: int, pin: bool) -> torch.Tensor:
    """A uint8 host buffer, page-locked for a card's copies when ``pin``."""
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)


# -- the gradient exchange ----------------------------------------------------
def grad_route(placements: Sequence[Sequence[Placed]]) -> str:
    """How the gradient images of the ranks whose devices ``placements``
    lists (one list a rank, as :func:`rank_devices` gives them) cross:
    ``"nccl"`` when every device is a card and no card serves two ranks
    (NCCL refuses two ranks on one card), else ``"host"``, through host
    memory over gloo. Cards are told apart by UUID, not by name. A function
    of the placement alone, decided once at init; an NCCL failure fails
    the run and never falls back."""
    owner = {}
    for rank, devices in enumerate(placements):
        for d in devices:
            if d.card is None or owner.setdefault(d.card, rank) != rank:
                return "host"
    return "nccl"


def exchange_group(ranks: Sequence[int], placements: Sequence[Sequence]):
    """``(group, route)``: a group over ``ranks`` for the gradient images,
    NCCL on the route :func:`grad_route` picks for their ``placements``
    (every rank's, from :func:`rank_devices`), else the default gloo backend.
    A collective: every process calls it, members or not, in the same
    order. Each member's current card must be set before its first NCCL
    call (``torch.cuda.set_device``)."""
    route = grad_route([placements[r] for r in ranks])
    group = dist.new_group(list(ranks), timeout=dist_timeout(),
                           backend="nccl" if route == "nccl" else None)
    return group, route


def grad_image(params: Sequence[torch.nn.Parameter], loss: torch.Tensor,
               acc: torch.Tensor):
    """A replica's part of a step: each parameter's gradient (zeros where
    it has none, with a flag saying so) and its weighted loss and accuracy
    terms. Packs with :class:`ByteCodec` on the replica's device."""
    dev = loss.device
    present = torch.tensor([p.grad is not None for p in params],
                           dtype=torch.uint8).to(dev)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    return (grads, present, torch.stack([loss.float(), acc.float()]))


def gather_images(images: Sequence[torch.Tensor], nbytes: int, group,
                  counts: Sequence[int],
                  device: Optional[torch.device] = None) -> torch.Tensor:
    """Every worker's packed image, in logical order, as one uint8 tensor:
    ``images`` are this process's workers' (``nbytes`` each), ``counts``
    the workers of each process of ``group`` in rank order (the logical
    order). One ``all_gather`` of equal-sized buffers, in host memory, or
    on ``device`` (this process's card) where ``group`` is NCCL's."""
    width = max(counts)
    mine = torch.zeros(width * nbytes, dtype=torch.uint8, device=device)
    for i, img in enumerate(images):
        mine[i * nbytes:(i + 1) * nbytes].copy_(img)
    bufs = [torch.empty_like(mine) for _ in counts]
    dist.all_gather(bufs, mine, group=group)
    return torch.cat([b[:c * nbytes] for b, c in zip(bufs, counts)])


def apply_images(model: torch.nn.Module, images: torch.Tensor,
                 codec: ByteCodec, device: torch.device):
    """Set ``model``'s gradients to the sum of the :func:`grad_image`
    images in ``images`` (uint8, end to end, logical order; in host memory
    or on a card): ``p.grad`` is the left fold g_0 + g_1 + ... of the
    workers' gradients, skipping absent ones, as the single-process engine
    sums its replicas into the first. Returns the folded (loss, acc)
    terms, device scalars on ``device``; the caller divides by the weight
    sum and steps."""
    nb = codec.nbytes
    n = images.numel() // nb
    whole = images.to(device)
    params = list(model.parameters())
    for p in params:
        p.grad = None
    # the images' presence flags, read on the host in one copy
    flags = torch.stack([codec.unpack(images[k * nb:(k + 1) * nb])[1]
                         for k in range(n)]).cpu().tolist() if n else []
    loss = acc = None
    for k in range(n):
        grads, _, la = codec.unpack(whole[k * nb:(k + 1) * nb])
        for p, g, f in zip(params, grads, flags[k]):
            if f:
                p.grad = g if p.grad is None else p.grad + g
        loss = la[0] if loss is None else loss + la[0]
        acc = la[1] if acc is None else acc + la[1]
    return loss, acc
