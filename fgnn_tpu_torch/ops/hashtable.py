"""Dedup + dense renumbering (port of ``fgnn_tpu/ops/hashtable.py``).

Same contract as the reference's :func:`unique_and_remap`: seeds keep their
input positions as locals, new ids are appended in ascending global id,
locals at or past ``out_cap`` become -1, and an overflow flag reports the
clipping. Padding (-1) maps to INT_MAX before the sort, so it sorts last.
:func:`unique_and_remap_direct` gives the same results without a sort,
through a direct-index table over the graph's nodes.

:func:`unique_with_seeds` and :func:`lookup_local_ids` are the reference's
unfused FillWithDuplicates and SearchO2N, which only the profile-level-3
measurement pass runs (``OneChipEngine._profile_l3``).
"""
from __future__ import annotations

from typing import Tuple

import torch

INT_MAX = 2**31 - 1
_POS_BITS = 31


def _to_sentinel(x: torch.Tensor) -> torch.Tensor:
    """-1 padding -> INT_MAX (as int64) so padded entries sort last."""
    return torch.where(x < 0, INT_MAX, x.long())


def unique_with_seeds(
    seeds: torch.Tensor,
    num_seeds,
    neighbors: torch.Tensor,
    out_cap: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FillWithDuplicates: ``(unique [out_cap] int32 -1-padded, seeds first
    in input order then the new ids ascending; num_unique; overflowed)``.

    The reference's arithmetic, its edge included: new ids go to a buffer
    of ``max(out_cap - S, 1)``, so with ``out_cap == S`` one new id still
    counts in ``num_unique`` though none is appended. ``overflowed`` says
    that new ids were dropped. The distinct count is read on the host.
    """
    S = seeds.shape[0]
    device = seeds.device
    seeds_s = _to_sentinel(seeds)
    nbr_s = _to_sentinel(neighbors)
    sorted_seeds = torch.sort(seeds_s).values
    pos = torch.searchsorted(sorted_seeds, nbr_s).clamp(max=S - 1)
    cand = torch.where(sorted_seeds[pos] == nbr_s, INT_MAX, nbr_s)

    new_cap = max(out_cap - S, 1)
    distinct = torch.unique(cand)                     # ascending
    distinct = distinct[distinct != INT_MAX]
    num_new = min(distinct.shape[0], new_cap)
    uniq_new = torch.full((new_cap,), INT_MAX, dtype=torch.int64,
                          device=device)
    uniq_new[:num_new] = distinct[:num_new]

    unique = torch.full((out_cap,), INT_MAX, dtype=torch.int64, device=device)
    unique[:S] = seeds_s
    unique[S:] = uniq_new[:out_cap - S]
    num_unique = torch.as_tensor(num_seeds, dtype=torch.int32,
                                 device=device) + num_new
    overflowed = torch.tensor(distinct.shape[0] > num_new, device=device)
    return (torch.where(unique == INT_MAX, -1, unique).int(), num_unique,
            overflowed)


def lookup_local_ids(
    unique: torch.Tensor,
    num_seeds_static: int,
    queries: torch.Tensor,
) -> torch.Tensor:
    """SearchO2N / GPUMapEdges: the local id of each query in ``unique``
    (laid out as :func:`unique_with_seeds` gives it: seeds in
    ``[0, num_seeds_static)`` in any order, the rest ascending); -1 for a
    query not there and for padding."""
    S = num_seeds_static
    seeds_s = _to_sentinel(unique[:S])
    rest = _to_sentinel(unique[S:])
    q = _to_sentinel(queries)

    sorted_seeds, order = torch.sort(seeds_s, stable=True)
    p = torch.searchsorted(sorted_seeds, q).clamp(max=S - 1)
    hit_seed = sorted_seeds[p] == q
    local = torch.where(hit_seed, order[p], -1)
    # the appended region is ascending already, and empty when the unique
    # cap equals the seed cap
    if rest.shape[0]:
        p2 = torch.searchsorted(rest, q).clamp(max=rest.shape[0] - 1)
        local = torch.where(~hit_seed & (rest[p2] == q), S + p2, local)
    return torch.where(q == INT_MAX, -1, local).int()


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


def unique_and_remap_direct(
    seeds: torch.Tensor,
    num_seeds: torch.Tensor,
    neighbors: torch.Tensor,
    out_cap: int,
    num_node: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-free :func:`unique_and_remap` (without counts) through a
    direct-index table of ``num_node`` entries: the source system's
    ``SXN_NAIVE_HASHMAP`` OrderedHashTable (cuda_hashtable.h:70-94).

    Scatters mark the seeds' positions and the neighbours seen, an
    inclusive cumsum over the table ranks the new ids in ascending order,
    and gathers read each neighbour's local back. Same outputs as
    :func:`unique_and_remap` for a frontier of distinct seeds; O(num_node
    + E) work and ``num_node`` int32 and bool of scratch per call.
    """
    S = seeds.shape[0]
    device = seeds.device
    seeds_ok = seeds >= 0
    nbr_ok = neighbors >= 0
    # padding writes and reads slot num_node, which no real id uses
    seed_slot = torch.where(seeds_ok, seeds, num_node).long()
    nbr_slot = torch.where(nbr_ok, neighbors, num_node).long()

    seed_local = torch.full((num_node + 1,), -1, dtype=torch.int32,
                            device=device)
    seed_local[seed_slot] = torch.arange(S, dtype=torch.int32, device=device)
    seed_local[num_node] = -1
    present = torch.zeros(num_node + 1, dtype=torch.bool, device=device)
    present[nbr_slot] = True
    present = present & (seed_local < 0)
    present[num_node] = False

    # dense ranks of the new ids, in ascending id
    rank = torch.cumsum(present, 0, dtype=torch.int32)       # inclusive
    num_new = rank[-1]
    new_local = S + rank - 1                                  # where present

    as_seed = seed_local[nbr_slot]
    local = torch.where(as_seed >= 0, as_seed, new_local[nbr_slot])
    local = torch.where(local >= out_cap, -1, local)          # clipped
    nbr_local = torch.where(nbr_ok, local, -1)

    # unique list: the seeds block, then the new ids at their ranks; the
    # rest (and ids past out_cap) land in a trash slot that is cut off
    unique = torch.full((out_cap + 1,), INT_MAX, dtype=torch.int64,
                        device=device)
    unique[:S] = _to_sentinel(seeds)
    tgt = torch.where(present & (new_local < out_cap), new_local, out_cap)
    unique[tgt.long()] = torch.where(
        present, torch.arange(num_node + 1, device=device), INT_MAX)
    unique = unique[:out_cap]
    unique = torch.where(unique == INT_MAX, -1, unique).int()
    overflowed = (S + num_new) > out_cap
    num_unique = num_seeds + torch.clamp(num_new, max=out_cap - S)
    return unique, num_unique.int(), nbr_local, overflowed
