"""Dynamic feature cache, arch4 (port of ``fgnn_tpu/cache/dynamic.py``).

GPUDynamicCacheManager of the source system (cuda_cache_manager.h:81-132,
cuda_loops.cc:269-498): instead of a static hot set, the cache is the
previous batch's features, replaced every step, which exploits the overlap
of consecutive batches' input nodes.

As in the reference, the state is the previous batch's ids sorted, the row
of each in its feature block, and that block in float32. Membership is a
``torch.searchsorted`` against the sorted ids; the split is the static
cache's miss-first partition; the combine gathers the hit rows with the
Hopper row gather (K1) and places the uploaded miss rows with one
``index_copy_``, bit-equal to the reference's ``where`` of two takes
(:func:`combine_feats_reference`).

The split of batch k+1 needs only batch k's ids, not its features:
:meth:`DynamicFeatureCache.split_and_advance` advances the id half of the
state at once, so the host gather of batch k+1's misses can run while batch
k trains, and :meth:`DynamicFeatureCache.combine` fills in the feature half.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..ops.extract import HostFeatures, host_gather
from ..ops.gather import gather_rows
from .manager import miss_first, place_misses

INT_MAX = 2**31 - 1


@dataclasses.dataclass
class DynCacheState:
    ids_sorted: torch.Tensor   # [cap] int32, ascending, INT_MAX padded
    row: torch.Tensor          # [cap] int64: feats row of ids_sorted[i]
    feats: torch.Tensor        # [cap, F] float32: the previous batch's features


@dataclasses.dataclass
class DynSplit:
    """One batch's hit/miss classification against the previous batch."""

    input_nodes: torch.Tensor
    hit: torch.Tensor
    cache_row: torch.Tensor    # [cap] int32 row in the previous block, 0 if miss
    rank: torch.Tensor
    miss_ids: torch.Tensor
    num_miss: torch.Tensor
    num_hit: torch.Tensor
    order: torch.Tensor        # [cap] int64: input position of miss-first entry r


def init_state(cap: int, feat_dim: int, device) -> DynCacheState:
    return DynCacheState(
        ids_sorted=torch.full((cap,), INT_MAX, dtype=torch.int32, device=device),
        row=torch.zeros((cap,), dtype=torch.int64, device=device),
        feats=torch.zeros((cap, feat_dim), dtype=torch.float32, device=device),
    )


def ids_from(input_nodes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The id half of the next state, known as soon as the batch is
    sampled: the ids sorted (padding as INT_MAX, last) and their rows."""
    q = torch.where(input_nodes < 0, INT_MAX, input_nodes)
    ids_sorted, order = torch.sort(q, stable=True)
    return ids_sorted, order


def split_hits(ids_sorted: torch.Tensor, row: torch.Tensor,
               input_nodes: torch.Tensor) -> DynSplit:
    """Hit/miss split of ``input_nodes`` against the previous batch's ids."""
    cap = ids_sorted.shape[0]
    q = torch.where(input_nodes < 0, INT_MAX, input_nodes)
    p = torch.searchsorted(ids_sorted, q).clamp(0, cap - 1)
    hit = (ids_sorted[p] == q) & (q != INT_MAX)
    cache_row = torch.where(hit, row[p], 0).to(torch.int32)
    miss = (input_nodes >= 0) & ~hit
    return DynSplit(input_nodes=input_nodes, hit=hit, cache_row=cache_row,
                    **miss_first(input_nodes, miss, hit))


def combine_feats(prev_feats: torch.Tensor, split: DynSplit,
                  miss_rows: torch.Tensor, num_miss: int) -> torch.Tensor:
    """The hit rows from the previous batch's features (row gather, zero
    rows elsewhere), then the ``num_miss`` uploaded miss rows at their
    positions. The result is the next state's feature half, in input
    order."""
    hot = gather_rows(prev_feats, torch.where(split.hit, split.cache_row, -1))
    return place_misses(hot, split.order, miss_rows, num_miss)


def combine_feats_reference(prev_feats: torch.Tensor, split: DynSplit,
                            miss_rows: torch.Tensor) -> torch.Tensor:
    """Plain torch version of :func:`combine_feats`: the reference's
    ``where(hit, prev[cache_row], miss[rank])``, zero where the id is -1."""
    cache_part = prev_feats[split.cache_row.long()]
    rank = split.rank.long().clamp(max=max(miss_rows.shape[0] - 1, 0))
    miss_part = (miss_rows[rank] if miss_rows.shape[0]
                 else torch.zeros_like(cache_part))
    out = torch.where(split.hit[:, None], cache_part, miss_part)
    return torch.where((split.input_nodes >= 0)[:, None], out, 0)


class DynamicFeatureCache:
    """The engine-facing arch4 cache.

    Staged for the prefetch pipeline: :meth:`split_and_advance` (device,
    advances the id state), the host gather of the misses (``host``, safe
    on a worker thread: it touches no cache state), :meth:`combine`
    (device, advances the feature state). :meth:`extract` chains them
    synchronously: the same math by construction.
    """

    dtype = torch.float32   # the staging dtype: the state is float32

    def __init__(self, host: HostFeatures, cap: int):
        self.host = host
        self.state = init_state(cap, host.table.shape[1], host.device)
        self.last_num_miss = 0
        self.last_num_hit = 0

    def split_and_advance(self, input_nodes: torch.Tensor) -> DynSplit:
        """Classify this batch against the previous batch's ids, then make
        this batch's ids the id state (its features arrive at combine)."""
        split = split_hits(self.state.ids_sorted, self.state.row, input_nodes)
        self.state.ids_sorted, self.state.row = ids_from(input_nodes)
        return split

    def gather_miss(self, miss_ids: torch.Tensor, n_miss: int) -> torch.Tensor:
        """ExtractMissData on the host: rows for a CPU tensor of miss ids,
        the first ``n_miss`` gathered, the tail zero, float32."""
        return host_gather(self.host.table, miss_ids, self.host.mod,
                           n_real=n_miss)

    def combine(self, split: DynSplit, miss_rows: torch.Tensor,
                num_miss: int) -> torch.Tensor:
        """Merge hits and misses and install the result as the feature
        state (the id half was advanced at split time)."""
        out = combine_feats(self.state.feats, split, miss_rows, num_miss)
        self.state.feats = out
        return out

    def extract(self, input_nodes: torch.Tensor) -> torch.Tensor:
        """Split, gather and upload the misses, combine: one batch's
        features, synchronously. Sets ``last_num_miss``/``last_num_hit``."""
        split = self.split_and_advance(input_nodes)
        f = self.host.fetch(split.miss_ids,
                            torch.stack([split.num_miss, split.num_hit]))
        rows, (n_miss, n_hit), ready = self.host.load(f, self.dtype)
        self.host.ready(ready)
        self.last_num_miss, self.last_num_hit = n_miss, n_hit
        return self.combine(split, rows, n_miss)
