"""Dedup + dense renumbering (port of ``fgnn_tpu/ops/hashtable.py``).

Same contract as the reference's :func:`unique_and_remap`: seeds keep their
input positions as locals, new ids are appended in ascending global id,
locals at or past ``out_cap`` become -1, and an overflow flag reports the
clipping. Padding (-1) maps to INT_MAX before the sort, so it sorts last.
"""
from __future__ import annotations

from typing import Tuple

import torch

INT_MAX = 2**31 - 1
_POS_BITS = 31


def _to_sentinel(x: torch.Tensor) -> torch.Tensor:
    """-1 padding -> INT_MAX (as int64) so padded entries sort last."""
    return torch.where(x < 0, INT_MAX, x.long())


def unique_and_remap(
    seeds: torch.Tensor,
    num_seeds: torch.Tensor,
    neighbors: torch.Tensor,
    out_cap: int,
    with_counts: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Fused FillWithDuplicates + GPUMapEdges in one sort.

    Sorts the concatenated ``[seeds | neighbors]`` once by the packed int64
    key ``value << 32 | is_neighbor << 31 | position`` (the reference packs
    ``tag << 24 | pos`` into a second int32 key because JAX runs without
    x64). Group leaders get locals (seed leaders keep their input position,
    new leaders ``S + rank``), members take their leader's, and the locals
    go back through the sort permutation.

    Returns ``(unique [out_cap] int32 -1-padded seeds-first, num_unique,
    nbr_local [E] int32 (-1 for padding and clipped ids), overflowed)``.

    ``with_counts=True`` appends ``counts [out_cap] int32``, the block's src
    out-degree that GCN's norm='both' needs: each unique local's group size
    in the same sort, less the seed itself for a seed-led group (a duplicate
    seed in the group still counts, as in the reference); 0 for padded and
    duplicate seed slots, and for leaders clipped at ``out_cap``.
    """
    S = seeds.shape[0]
    E = neighbors.shape[0]
    assert out_cap >= S
    assert S + E < (1 << _POS_BITS), "position field overflow"
    device = seeds.device
    arr = torch.cat([_to_sentinel(seeds), _to_sentinel(neighbors)])
    n = S + E
    pos = torch.arange(n, dtype=torch.int64, device=device)
    tag = (pos >= S).long()
    key = (arr << 32) | (tag << _POS_BITS) | pos
    skey, _ = torch.sort(key, stable=True)
    sa = skey >> 32
    st = (skey >> _POS_BITS) & 1
    sp = skey & ((1 << _POS_BITS) - 1)

    first = torch.ones(n, dtype=torch.bool, device=device)
    first[1:] = sa[1:] != sa[:-1]
    is_pad = sa == INT_MAX
    new_leader = first & (st == 1) & ~is_pad
    new_rank = torch.cumsum(new_leader, 0) - 1
    leader_local = torch.where(st == 0, sp, S + new_rank)

    # propagate each group's leader position forward, then take its local
    lead_idx = torch.cummax(torch.where(first, pos, 0), 0).values
    local_sorted = torch.where(is_pad, -1, leader_local[lead_idx])
    local_sorted = torch.where(local_sorted >= out_cap, -1, local_sorted)
    num_new = new_leader.sum()
    overflowed = (S + num_new) > out_cap

    # unscatter through the (permutation) sort order
    local_all = torch.empty(n, dtype=torch.int64, device=device)
    local_all[sp] = local_sorted
    nbr_local = local_all[S:].int()

    # unique list: seeds block + new leaders at S + rank; the rest (and
    # leaders past out_cap) land in a trash slot that is cut off
    unique = torch.full((out_cap + 1,), INT_MAX, dtype=torch.int64, device=device)
    unique[:S] = _to_sentinel(seeds)
    tgt = torch.where(new_leader & (S + new_rank < out_cap), S + new_rank, out_cap)
    unique[tgt] = torch.where(new_leader, sa, INT_MAX)
    unique = unique[:out_cap]
    num_unique = num_seeds + torch.clamp(num_new, max=out_cap - S)
    unique = torch.where(unique == INT_MAX, -1, unique).int()
    if not with_counts:
        return unique, num_unique.int(), nbr_local, overflowed

    # group size at each leader: distance to the next group start, found
    # by a reverse cummin (torch has none: flip, cummin, flip)
    starts = torch.where(first, pos, n)
    nxt = torch.flip(torch.cummin(torch.flip(starts, (0,)), 0).values, (0,))
    nxt_after = torch.cat([nxt[1:], nxt.new_full((1,), n)])
    cnt = torch.where(is_pad, 0, nxt_after - pos - (st == 0).long())
    cnt = torch.where((st == 0) & ~first, 0, cnt)     # duplicate seed slots
    # every seed slot writes its own position; new leaders kept under the
    # cap write their local; the rest land in a trash slot that is cut off
    tgt = torch.where(
        st == 0, sp,
        torch.where(first & ~is_pad & (leader_local < out_cap),
                    leader_local, out_cap))
    counts = torch.zeros(out_cap + 1, dtype=torch.int64, device=device)
    counts[tgt] = cnt
    return (unique, num_unique.int(), nbr_local, overflowed,
            counts[:out_cap].int())
