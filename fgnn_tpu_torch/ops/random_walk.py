"""PinSAGE random-walk sampling and per-seed top-K by visit count (port of
``fgnn_tpu/ops/random_walk.py``).

Each hop runs W walks of length L from every frontier node, counts each
visited node's visits per seed and keeps the K most visited as that seed's
neighbours, the visit counts as edge weights (``WeightedSAGEConv``). The
reference's lane-select gather (``take_1d_blocked``) is left out: plain
indexing is the gather here.

Randomness: a hop's draws are one ``[L, 2, n, W]`` float32 tensor, index 0
of a step its pick, index 1 its death draw (:func:`walk_uniform_shapes`).
``rand`` is a :class:`torch.Generator` on the tensors' device or that
tensor; injecting the reference's own draws gives the same visits, top-K
and blocks exactly.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch

from .hashtable import unique_and_remap
from .padding import SamplePlan
from .sampling import (Block, CSRGraph, Rand, SampledBatch, _append_slots,
                       _uniforms)


def walk_uniform_shapes(plan: SamplePlan, num_random_walk: int,
                        walk_length: int) -> List[Tuple[int, int, int, int]]:
    """Shape of the uniforms each hop of :func:`random_walk_topk` draws."""
    return [(walk_length, 2, plan.num_input_cap[h], num_random_walk)
            for h in range(plan.num_layer)]


def random_walk_visits(
    graph: CSRGraph,
    seeds: torch.Tensor,
    num_random_walk: int,
    walk_length: int,
    restart_prob: float,
    rand: Rand,
) -> torch.Tensor:
    """All nodes visited by W walks of length L from each seed.

    seeds: [n] int32, -1 padded. Returns [n, W*L] int32 visited ids, walk
    major (slot ``w * L + step``), -1 for dead slots. A step picks
    ``min(floor(u * float32(deg)), deg - 1)``; a node of degree 0 records
    -1 and ends its walk; after each step the walk dies with probability
    ``restart_prob`` (the source's "restart" kills the walk).
    """
    n, W, L = seeds.shape[0], num_random_walk, walk_length
    u = _uniforms(rand, (L, 2, n, W), seeds.device)
    indptr, indices = graph.indptr, graph.indices
    E = indices.shape[0]
    p = torch.tensor(restart_prob, dtype=torch.float32, device=seeds.device)
    node = torch.where(seeds >= 0, seeds, -1)[:, None].expand(n, W)
    visits = []
    for step in range(L):
        safe = node.clamp(min=0).long()
        off = indptr[safe]
        deg = (indptr[safe + 1] - off).to(torch.int32)
        pick = torch.minimum(
            torch.floor(u[step, 0] * deg.to(torch.float32)).to(torch.int32),
            deg - 1)
        nxt = indices[(off + pick.clamp(min=0)).clamp(0, E - 1)]
        ok = (node >= 0) & (deg > 0)
        visited = torch.where(ok, nxt, -1)
        node = torch.where(ok & ~(u[step, 1] < p), visited, -1)
        visits.append(visited)
    return torch.stack(visits, dim=2).reshape(n, W * L)


def topk_by_frequency(visits: torch.Tensor,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row, the k distinct visited ids with the most visits.

    visits: [n, M] int32, -1 = dead. Returns (ids [n, k] int32 -1-padded,
    weights [n, k] float32 visit counts, 0 where padded). Each id scores at
    its first slot; among equal scores the lower slot comes first, the
    order of ``jax.lax.top_k``, kept here by a stable descending sort
    (``torch.topk`` promises no order among ties).
    """
    n, M = visits.shape
    eq = visits[:, :, None] == visits[:, None, :]             # [n, M, M]
    valid = visits >= 0
    count = (eq & valid[:, None, :]).sum(2)
    slot = torch.arange(M, device=visits.device)
    earlier = slot[None, :] < slot[:, None]                   # [M, M]
    first = ~(eq & earlier).any(2)
    score = torch.where(valid & first, count, 0)
    k_eff = min(k, M)
    topv, topi = torch.sort(score, dim=1, descending=True, stable=True)
    topv, topi = topv[:, :k_eff], topi[:, :k_eff]
    ok = topv > 0
    ids = torch.where(ok, visits.gather(1, topi), -1)
    w = torch.where(ok, topv.to(torch.float32), 0.0)
    if k_eff < k:
        pad = k - k_eff
        ids = torch.cat([ids, ids.new_full((n, pad), -1)], 1)
        w = torch.cat([w, w.new_zeros((n, pad))], 1)
    return ids, w


def random_walk_topk(
    graph: CSRGraph,
    seeds: torch.Tensor,
    num_seeds,
    plan: SamplePlan,
    *,
    num_random_walk: int = 4,
    random_walk_length: int = 3,
    restart_prob: float = 0.5,
    dedup_last_hop: bool = True,
    rand: Union[torch.Generator, Sequence[torch.Tensor]],
) -> SampledBatch:
    """Multi-layer PinSAGE sampling.

    Every hop has fanout ``plan.fanouts[hop]`` (K) and regular blocks of K
    slots a frontier node; its ``weights`` are the visit counts, 0 on
    masked slots. Each hop but a no-dedup last one runs the one-sort
    ``unique_and_remap``; ``dedup_last_hop=False`` appends the last hop's
    slots after the frontier instead, so its ``gather_src`` is a slice
    (``src_slice_offset``), as ``multi_layer_sample`` does.

    ``rand``: a generator, or one uniforms tensor per hop with the shapes
    of :func:`walk_uniform_shapes`.
    """
    if seeds.shape[0] != plan.num_input_cap[0]:
        raise ValueError(
            f"seeds cap {seeds.shape[0]} != plan {plan.num_input_cap[0]}")
    device = seeds.device
    num_seeds = torch.as_tensor(num_seeds, dtype=torch.int32, device=device)
    cur = seeds
    num_cur = num_seeds
    blocks_rev: List[Block] = []
    overflowed = torch.zeros((), dtype=torch.bool, device=device)

    for hop in range(plan.num_layer):
        K = plan.fanouts[hop]
        no_dedup = hop == plan.num_layer - 1 and not dedup_last_hop
        visits = random_walk_visits(
            graph, cur, num_random_walk, random_walk_length, restart_prob,
            rand if isinstance(rand, torch.Generator) else rand[hop])
        ids, w = topk_by_frequency(visits, K)
        nbrs = ids.reshape(-1)
        weights = w.reshape(-1)
        valid = nbrs >= 0

        if no_dedup:
            unique, num_unique, src_local = _append_slots(cur, num_cur, nbrs,
                                                          valid)
        else:
            unique, num_unique, src_local, ovf = unique_and_remap(
                cur, num_cur, nbrs, plan.num_unique_cap[hop])
            overflowed = overflowed | ovf

        dst_local = torch.arange(
            plan.num_input_cap[hop], dtype=torch.int32, device=device
        ).repeat_interleave(K)
        mask = valid & (src_local >= 0)
        blocks_rev.append(Block(
            src_local=torch.where(mask, src_local, -1),
            dst_local=torch.where(mask, dst_local, -1),
            mask=mask,
            num_src=num_unique,
            num_dst=num_cur,
            weights=torch.where(mask, weights, 0.0),
            slots_per_dst=K,
            src_slice_offset=cur.shape[0] if no_dedup else None,
        ))
        cur = unique
        num_cur = num_unique

    return SampledBatch(
        blocks=tuple(reversed(blocks_rev)),
        input_nodes=cur,
        num_input=num_cur,
        output_nodes=seeds[: plan.batch_size],
        num_output=num_seeds,
        overflowed=overflowed,
    )
