"""Feature / label extraction (port of ``fgnn_tpu/ops/extract.py``).

The device-side feature gathers go through the Hopper row-gather kernel
(:mod:`fgnn_tpu_torch.ops.gather`); the label gather is a 1-D take, which
the reference leaves to XLA as well.

A feature table that stays in host memory (an ndarray or an ``np.memmap``)
is read by :func:`host_gather`, the counterpart of the reference's host
gather and of ``fgnn_tpu/native``'s OpenMP ``gather_f32``, and reaches the
device through :class:`HostFeatures`: pinned staging buffers and a copy
stream. The table itself is never pinned or copied whole; only the rows a
batch needs are.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from .gather import GatherRows


def device_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """output[i] = table[ids[i]]; padded ids (-1) produce zero rows."""
    return GatherRows.apply(table, ids)


def mock_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Empty-feat mode: index modulo the fake table size (GPUMockExtract)."""
    return GatherRows.apply(table, torch.where(ids >= 0, ids % table.shape[0], -1))


def label_gather(labels: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Labels for the batch seeds; padded ids -> -1."""
    out = labels[ids.clamp(min=0).long()]
    return torch.where(ids >= 0, out, -1)


def host_table(feat: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``feat``'s memory, without a copy. A read-only
    ``np.memmap`` is fine: the port only reads the table."""
    with warnings.catch_warnings():
        # torch warns that it cannot mark a read-only array read-only
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(feat)


def host_gather(feat: torch.Tensor, ids: torch.Tensor, mod: int = 0,
                n_real: Optional[int] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[i] = feat[ids[i]]`` on the host, for CPU tensors ``feat``
    ``[N, D]`` and integer ``ids`` ``[M]``. Zero rows where ``ids[i] < 0``
    and, with ``n_real``, for every ``i >= n_real`` (whose ids are not
    read). ``mod`` > 0 indexes modulo ``mod`` (empty-feat mode; pass
    ``ds.feat_mod``). ``out``, if given, is a ``[>= M, D]`` tensor of
    ``feat``'s dtype, pinned or not, written in its first M rows."""
    m = ids.shape[0]
    real = m if n_real is None else n_real
    out = (torch.empty((m, feat.shape[1]), dtype=feat.dtype) if out is None
           else out[:m])
    idx = ids[:real].long()
    if mod:
        idx = torch.where(idx >= 0, idx % mod, idx)
    pad = idx < 0
    torch.index_select(feat, 0, idx.clamp(min=0), out=out[:real])
    if bool(pad.any()):
        out[:real].masked_fill_(pad.unsqueeze(1), 0)
    out[real:].zero_()
    return out


@dataclasses.dataclass
class Fetch:
    """Ids on their way to the host: pinned copies of ``ids`` and
    ``counts`` and the event that says they have arrived."""

    ids: torch.Tensor
    counts: torch.Tensor
    arrived: Optional[torch.cuda.Event]
    consumer: Optional[torch.cuda.Stream]   # the stream that uses the rows
    slot: int


class _Slot:
    """One set of staging buffers: pinned ids, counts and rows in each
    staging dtype, an f32 scratch for a converting gather, and the event of
    the last upload that read the pinned rows."""

    def __init__(self):
        self.ids: Optional[torch.Tensor] = None
        self.counts: Optional[torch.Tensor] = None
        self.rows = {}
        self.scratch: Optional[torch.Tensor] = None
        self.uploaded: Optional[torch.cuda.Event] = None


def _grown(buf: Optional[torch.Tensor], shape, dtype, pin: bool) -> torch.Tensor:
    if buf is not None and buf.shape[0] >= shape[0]:
        return buf
    return torch.empty(shape, dtype=dtype, pin_memory=pin)


class HostFeatures:
    """A host-resident feature table, gathered on the CPU and copied to
    ``device`` in two stages:

    1. :meth:`fetch` (the thread that runs the device's work): queue the
       copy of a batch's ids and counts into pinned memory on the current
       stream, behind the work that produces them, and record an event.
    2. :meth:`load` (any thread, typically a worker): wait for that event,
       gather the rows on the host into pinned staging, convert them to the
       staging dtype, and copy them to the device on a copy stream. Returns
       the device rows and an event the consumer waits on (:meth:`ready`).

    ``slots`` staging sets (``SLOTS`` by default) are used in turn, so up to
    ``slots`` fetches may be outstanding (the pipelined epoch has two: batch
    k loading while batch k+1's ids arrive; a multi-device engine's group
    pipeline two groups): a slot's pinned rows are not rewritten before the
    upload that read them has finished. On a CPU device every stage is
    a plain host operation on fresh tensors.

    Host clock time of the gathers and CUDA-event time of the uploads are
    summed for :meth:`counters`; read and reset them between epochs, not
    while a worker loads.
    """

    SLOTS = 2

    def __init__(self, feat: np.ndarray, device: torch.device, mod: int = 0,
                 slots: int = SLOTS):
        self.feat = feat
        self.table = host_table(feat)
        if self.table.dtype != torch.float32:
            raise ValueError(f"host feature table must be float32, got "
                             f"{self.table.dtype}")
        self.device = torch.device(device)
        self.mod = mod
        self.cuda = self.device.type == "cuda"
        self.copy_stream = torch.cuda.Stream(self.device) if self.cuda else None
        self._slots = [_Slot() for _ in range(slots)]
        self._next = 0
        self.last_gather_s = 0.0   # host seconds of the last load's gather
        self.reset_counters()

    # -- measurement -----------------------------------------------------
    def reset_counters(self) -> None:
        self._gather_s = 0.0
        self._gather_rows = 0
        self._upload_bytes = 0
        self._upload_ms = 0.0
        # (start, end) events of uploads not yet added to _upload_ms
        self._uploads: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []

    def _fold_uploads(self, wait: bool) -> None:
        """Add the device time of finished uploads (all, if ``wait``)."""
        pending = []
        for start, end in self._uploads:
            if wait:
                end.synchronize()
            if wait or end.query():
                self._upload_ms += start.elapsed_time(end)
            else:
                pending.append((start, end))
        self._uploads = pending

    def counters(self) -> dict:
        """Since :meth:`reset_counters`: rows gathered, host seconds of the
        gathers (conversion included), bytes and device milliseconds of the
        uploads (CUDA events on the copy stream; waits for them)."""
        self._fold_uploads(wait=True)
        return {
            "gather_rows": self._gather_rows,
            "gather_bytes": self._gather_rows * self.table.shape[1] * 4,
            "gather_s": self._gather_s,
            "upload_bytes": self._upload_bytes,
            "upload_ms": self._upload_ms,
        }

    # -- the two stages --------------------------------------------------
    def fetch(self, ids: torch.Tensor, counts: torch.Tensor) -> Fetch:
        """Queue the device-to-host copy of ``ids`` ([cap] int32) and
        ``counts`` ([k] int32; ``counts[0]`` is the number of leading ids a
        compact :meth:`load` gathers). Ids already on the host (the host
        sampler's) are taken as they are."""
        slot = self._next
        self._next = (self._next + 1) % len(self._slots)
        if not self.cuda:
            return Fetch(ids, counts, None, None, slot)
        if ids.device.type == "cpu":
            return Fetch(ids, counts, None,
                         torch.cuda.current_stream(self.device), slot)
        s = self._slots[slot]
        s.ids = _grown(s.ids, ids.shape, torch.int32, True)
        s.counts = _grown(s.counts, counts.shape, torch.int32, True)
        host_ids = s.ids[:ids.shape[0]]
        host_counts = s.counts[:counts.shape[0]]
        host_ids.copy_(ids, non_blocking=True)
        host_counts.copy_(counts, non_blocking=True)
        stream = torch.cuda.current_stream(self.device)
        arrived = torch.cuda.Event()
        arrived.record(stream)
        return Fetch(host_ids, host_counts, arrived, stream, slot)

    def load(self, f: Fetch, dtype: torch.dtype, compact: bool = True
             ) -> Tuple[torch.Tensor, List[int], Optional[torch.cuda.Event]]:
        """Rows for a fetch: the first ``counts[0]`` ids if ``compact``,
        else every id (zero rows for ids < 0). Returns ``(rows on the
        device in dtype, counts as ints, ready event or None)``."""
        if f.arrived is not None:
            f.arrived.synchronize()
        counts = [int(c) for c in f.counts.tolist()]
        n = counts[0] if compact else f.ids.shape[0]
        ids = f.ids[:n]
        dim = self.table.shape[1]
        t0 = time.perf_counter()
        if not self.cuda:
            rows = host_gather(self.table, ids, self.mod)
            rows = rows.to(dtype)
            self._count(t0, n)
            return rows, counts, None
        s = self._slots[f.slot]
        if s.uploaded is not None:
            s.uploaded.synchronize()    # the pinned rows are free again
        pinned = s.rows.get(dtype)
        pinned = s.rows[dtype] = _grown(pinned, (f.ids.shape[0], dim), dtype,
                                        True)
        if dtype == torch.float32:
            host_gather(self.table, ids, self.mod, out=pinned)
        else:
            s.scratch = _grown(s.scratch, (f.ids.shape[0], dim),
                               torch.float32, False)
            gathered = host_gather(self.table, ids, self.mod, out=s.scratch)
            pinned[:n].copy_(gathered)   # rounds to nearest even
        self._count(t0, n)
        with torch.cuda.device(self.device), torch.cuda.stream(self.copy_stream):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rows = torch.empty((n, dim), dtype=dtype, device=self.device)
            rows.copy_(pinned[:n], non_blocking=True)
            end.record()
        # the rows were made on the copy stream and are used on the
        # consumer's: the allocator must not hand them out again before the
        # consumer's work on them is done
        rows.record_stream(f.consumer)
        s.uploaded = end
        self._fold_uploads(wait=False)
        self._uploads.append((start, end))
        self._upload_bytes += n * dim * rows.element_size()
        return rows, counts, end

    def ready(self, event: Optional[torch.cuda.Event]) -> None:
        """Make the current stream wait for an upload of :meth:`load`."""
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)

    def _count(self, t0: float, n: int) -> None:
        self.last_gather_s = time.perf_counter() - t0
        self._gather_s += self.last_gather_s
        self._gather_rows += n
