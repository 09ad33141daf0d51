"""Static feature cache (port of ``fgnn_tpu/cache/manager.py``).

GPUCacheManager of the source system (cuda/cuda_cache_manager_*): the
hottest ``cache_percentage * num_node`` vertices' features live in device
memory; a batch's other rows (its misses) are gathered on the host and
merged on the device.

The miss/hit split is the reference's: a stable sort on a miss/hit/padding
key puts the misses first, in input order. The combine runs the Hopper row
gather (``ops/gather.py``, the port of K1) over the cache for the hit rows,
which writes zero rows elsewhere without reading, then places the uploaded
miss rows at their input positions with one ``index_copy_``. The result is
bit-equal to ``where(hit, cache[slot], miss[rank])`` with zero padding
rows (:func:`combine_reference`).

The reference uploads a power-of-two bucket of miss rows to keep XLA's
compile cache small; the port has no compile cache and uploads exactly
``num_miss`` rows.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.extract import HostFeatures, host_gather
from ..ops.gather import gather_rows
from ..utils import Timer, get_logger
from ..utils.profiler import Profiler

log = get_logger(__name__)


@dataclasses.dataclass
class MissCacheIndex:
    """GetMissCacheIndex output (dist_loops.cc:271-323 analog)."""

    miss_ids: torch.Tensor   # [cap] int32 global ids, misses first, -1 pad
    rank: torch.Tensor       # [cap] int32: position of input i in miss-first order
    hit: torch.Tensor        # [cap] bool
    slot: torch.Tensor       # [cap] int32 cache slot where hit, else -1
    num_miss: torch.Tensor   # scalar int32
    num_hit: torch.Tensor    # scalar int32
    order: torch.Tensor      # [cap] int64: input position of miss-first entry r


def miss_first(input_nodes: torch.Tensor, miss: torch.Tensor,
               hit: torch.Tensor) -> dict:
    """The miss-first partition shared with the dynamic cache: a stable
    sort on (0 miss, 1 hit, 2 padding). Returns ``order``, ``rank`` (its
    inverse), ``miss_ids`` (the misses' ids first, -1 after), ``num_miss``
    and ``num_hit``."""
    key = torch.where(miss, 0, torch.where(hit, 1, 2)).to(torch.int32)
    _, order = torch.sort(key, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    miss_ids = torch.where(key[order] == 0, input_nodes[order], -1)
    return dict(order=order, rank=rank.to(torch.int32),
                miss_ids=miss_ids.to(torch.int32),
                num_miss=miss.sum().to(torch.int32),
                num_hit=hit.sum().to(torch.int32))


def miss_cache_index(cache_table: torch.Tensor,
                     input_nodes: torch.Tensor) -> MissCacheIndex:
    """Miss/hit split of ``input_nodes`` ([cap] int32, -1 padded) against
    ``cache_table`` (node id -> cache slot or -1, [num_node + 1] int32)."""
    valid = input_nodes >= 0
    slot = torch.where(valid, cache_table[input_nodes.clamp(min=0).long()], -1)
    hit = slot >= 0
    return MissCacheIndex(hit=hit, slot=slot.to(torch.int32),
                          **miss_first(input_nodes, valid & ~hit, hit))


def place_misses(out: torch.Tensor, order: torch.Tensor,
                 miss_rows: torch.Tensor, num_miss: int) -> torch.Tensor:
    """Write the ``num_miss`` uploaded miss rows at their input positions
    (``order[:num_miss]``), in place."""
    if num_miss:
        out.index_copy_(0, order[:num_miss], miss_rows[:num_miss])
    return out


def combine_reference(cache_data: torch.Tensor, index: MissCacheIndex,
                      miss_rows: torch.Tensor) -> torch.Tensor:
    """Plain torch version of :meth:`FeatureCache.combine`: the reference's
    ``where(hit, cache[slot], miss[rank])`` with zero padding rows."""
    cache_part = cache_data[index.slot.clamp(min=0).long()]
    rank = index.rank.long().clamp(max=max(miss_rows.shape[0] - 1, 0))
    miss_part = (miss_rows[rank] if miss_rows.shape[0]
                 else torch.zeros_like(cache_part))
    out = torch.where(index.hit[:, None], cache_part, miss_part)
    miss = index.rank < index.num_miss
    return torch.where((index.hit | miss)[:, None], out, 0)


def cache_table_array(ranking: np.ndarray, cache_percentage: float,
                      num_node: int) -> np.ndarray:
    """Node id -> cache slot (or -1), ``[num_node + 1]`` int32: the first
    ``int(cache_percentage * num_node)`` nodes of ``ranking`` in order. The
    sampler-side hashtable (SampleCacheTableInit, dist_engine.cc:193-229)."""
    num_cache = int(cache_percentage * num_node)
    table = np.full((num_node + 1,), -1, dtype=np.int32)
    if num_cache:
        table[np.asarray(ranking[:num_cache], dtype=np.int32)] = np.arange(
            num_cache, dtype=np.int32)
    return table


class FeatureCache:
    """Static feature cache (GPUCacheManager analog) over a host-resident
    table. ``dtype`` is the cache's and the staging dtype (bf16 halves the
    host-to-device miss traffic); float32 by default. An empty-feat table
    (``host.mod`` > 0) is indexed modulo its rows, as the host gather
    does."""

    def __init__(
        self,
        host: HostFeatures,
        ranking: np.ndarray,            # hottest-first node permutation
        cache_percentage: float,
        num_node: int,
        dtype: Optional[torch.dtype] = None,
    ):
        t = Timer()
        feat_host = host.feat
        self.host = host
        self.num_node = num_node
        self.num_cache = int(cache_percentage * num_node)
        self.cache_percentage = cache_percentage
        self.dtype = dtype or torch.float32
        dev = host.device
        cache_nodes = np.asarray(ranking[: self.num_cache], dtype=np.int32)
        self.cache_table = torch.as_tensor(
            cache_table_array(ranking, cache_percentage, num_node), device=dev)
        mod = host.mod
        if feat_host.shape[0] < num_node and not mod:
            raise ValueError(
                f"feature matrix has {feat_host.shape[0]} rows for "
                f"{num_node} nodes; only an empty_feat dataset's table is "
                "short (SAMGRAPH_EMPTY_FEAT analog), read modulo its rows"
            )
        if self.num_cache:
            rows = cache_nodes % mod if mod else cache_nodes
            hot = torch.from_numpy(np.ascontiguousarray(feat_host[rows],
                                                        dtype=np.float32))
        else:
            hot = torch.zeros((1, feat_host.shape[1]))
        # rounded to the cache dtype on the host, to nearest even
        self.cache_data = hot.to(self.dtype).to(dev)
        Profiler.get().log_init("init_build_cache", t.passed())
        log.info(
            "feature cache: %d/%d nodes (%.1f%%) = %.1f MB on %s in %.2fs",
            self.num_cache, num_node, 100 * cache_percentage,
            self.cache_data.numel() * self.cache_data.element_size() / 2**20,
            dev, t.passed(),
        )

    def get_miss_cache_index(self, input_nodes: torch.Tensor) -> MissCacheIndex:
        """Split ids into hits and misses (GetMissCacheIndex analog)."""
        return miss_cache_index(self.cache_table, input_nodes)

    def combine(self, index: MissCacheIndex, miss_rows: torch.Tensor,
                num_miss: int) -> torch.Tensor:
        """CombineMissData + CombineCacheData (device.cu:166-211): the hit
        rows by the row-gather kernel, then the ``num_miss`` uploaded rows
        at their positions."""
        hot = gather_rows(self.cache_data, torch.where(index.hit, index.slot, -1))
        return place_misses(hot, index.order, miss_rows, num_miss)

    # -- synchronous host leg (the pipelined epoch drives ``host`` itself) -
    def host_extract_miss(self, miss_ids: torch.Tensor,
                          num_miss: int) -> torch.Tensor:
        """ExtractMissData on the host: rows for a CPU tensor of miss ids,
        the first ``num_miss`` gathered and the tail zero, in the staging
        dtype."""
        return host_gather(self.host.table, miss_ids, self.host.mod,
                           n_real=num_miss).to(self.dtype)

    def upload_miss(self, index: MissCacheIndex, trace_key: Optional[int] = None
                    ) -> Tuple[torch.Tensor, int, int]:
        """Copy the miss ids to the host, gather exactly ``num_miss`` rows
        there and upload them; the current stream waits for the upload.
        Returns ``(rows on the device, num_miss, num_hit)``. With
        ``trace_key`` and a trace on, the host gather (the ids' copy
        included) and the upload get the reference's ExtractMiss and
        CopyMiss lanes; the upload's span ends once it is done."""
        prof = Profiler.get()
        tracing = trace_key is not None and prof.trace_enabled
        with (prof.trace_scope(trace_key, "kL3Event_Copy_CacheCopy_ExtractMiss")
              if tracing else contextlib.nullcontext()):
            f = self.host.fetch(index.miss_ids,
                                torch.stack([index.num_miss, index.num_hit]))
            rows, (num_miss, num_hit), ready = self.host.load(f, self.dtype)
        with (prof.trace_scope(trace_key, "kL3Event_Copy_CacheCopy_CopyMiss")
              if tracing else contextlib.nullcontext()):
            self.host.ready(ready)
            if tracing and ready is not None:
                ready.synchronize()
        return rows, num_miss, num_hit
