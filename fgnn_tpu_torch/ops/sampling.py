"""Neighbourhood sampling, main-path subset (port of
``fgnn_tpu/ops/sampling.py``).

Static shapes as in the reference: every hop emits a fixed number of edge
slots, -1 padded, with a validity mask. Ported: uniform sampling without
replacement (KHOP0/KHOP2) by Floyd's algorithm, the one-sort dedup hop and
the degree-tiered no-dedup last hop. The TPU workarounds of the reference
(``take_1d_blocked`` lane selects over a lane-padded ``indices``, the region
fetch) are left out: plain indexing is the gather here.

Randomness: every sampler takes its ``[n, fanout]`` float32 uniforms as
``rand``, either a :class:`torch.Generator` on the tensors' device or the
tensor itself. The injected form lets a test feed the reference's exact
``jax.random.uniform(fold_in(key, hop), shape)`` draws; then picks, locals
and masks match the reference exactly.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import torch

from ..config import SampleType
from .hashtable import unique_and_remap
from .padding import SamplePlan

Rand = Union[torch.Generator, torch.Tensor]


@dataclasses.dataclass
class CSRGraph:
    """Device-resident CSR topology."""

    indptr: torch.Tensor   # [N+1] int64
    indices: torch.Tensor  # [E] int32
    prob_table: Optional[torch.Tensor] = None
    alias_table: Optional[torch.Tensor] = None
    prob_prefix_table: Optional[torch.Tensor] = None


@dataclasses.dataclass
class Block:
    """One sampled bipartite layer; edges point neighbour(src) -> seed(dst).

    Static layout fields, as in the reference:
      * ``slots_per_dst``: regular block, slot ``d * K + j`` belongs to dst d;
      * ``src_slice_offset``: no-dedup layout, slot j's src row is
        ``h[src_slice_offset + j]`` (a slice, no gather);
      * ``tier_split`` / ``dst_invperm``: degree-tiered layout
        ``[cap_0 x w_0 | cap_1 x w_1 | ...]`` over a degree-partitioned
        frontier; ``dst_invperm`` restores the original dst order after the
        per-tier aggregation. ``dst_local`` holds original positions.
    """

    src_local: torch.Tensor   # [E_cap] int32, -1 padded
    dst_local: torch.Tensor   # [E_cap] int32, -1 padded
    mask: torch.Tensor        # [E_cap] bool
    num_src: torch.Tensor     # scalar int32
    num_dst: torch.Tensor     # scalar int32
    weights: Optional[torch.Tensor] = None
    src_out_deg: Optional[torch.Tensor] = None
    slots_per_dst: Optional[int] = None
    src_slice_offset: Optional[int] = None
    tier_split: Optional[Tuple[Tuple[int, int], ...]] = None
    dst_invperm: Optional[torch.Tensor] = None   # [V] int32


@dataclasses.dataclass
class SampledBatch:
    """One mini-batch's sampled graph; ``blocks[0]`` is the input side."""

    blocks: Tuple[Block, ...]
    input_nodes: torch.Tensor    # [final_cap] int32 global ids, -1 padded
    num_input: torch.Tensor      # scalar int32
    output_nodes: torch.Tensor   # [B] int32 global seed ids, -1 padded
    num_output: torch.Tensor     # scalar int32
    overflowed: torch.Tensor     # scalar bool: a layer clipped its cap


def _uniforms(rand: Rand, shape: Tuple[int, ...], device) -> torch.Tensor:
    if isinstance(rand, torch.Generator):
        return torch.rand(shape, generator=rand, device=device)
    if tuple(rand.shape) != tuple(shape) or rand.dtype != torch.float32:
        raise ValueError(
            f"injected uniforms have {rand.dtype} {tuple(rand.shape)}, "
            f"the sampler needs float32 {tuple(shape)}"
        )
    return rand.to(device)


def _floyd_without_replacement(
    u: torch.Tensor, deg: torch.Tensor, fanout: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform sample of min(deg, fanout) distinct slots from [0, deg).

    Robert Floyd's algorithm over the static fanout: for j in [0, f):
    J = deg-f+j; t = min(floor(u_j * float32(J+1)), J); pick t unless
    already picked, else J. The draw is taken in float32 as in the
    reference, so injected uniforms give the same picks.
    """
    n = deg.shape[0]
    big = deg >= fanout
    picks = torch.full((n, fanout), -1, dtype=torch.int32, device=deg.device)
    for j in range(fanout):
        J = deg - fanout + j
        t = torch.minimum(
            torch.floor(u[:, j] * (J + 1).to(torch.float32)).to(torch.int32), J
        )
        if j:
            collided = (picks[:, :j] == t[:, None]).any(dim=1)
            t = torch.where(collided, J, t)
        small_pick = torch.where(j < deg, j, -1).to(torch.int32)
        picks[:, j] = torch.where(big, t, small_pick)
    return picks, picks >= 0


def _offsets_degrees(graph: CSRGraph, nodes: torch.Tensor):
    node_ok = nodes >= 0
    safe = torch.where(node_ok, nodes, 0).long()
    off = graph.indptr[safe]
    deg = (graph.indptr[safe + 1] - off).to(torch.int32)
    return node_ok, off, torch.where(node_ok, deg, 0)


def _neighbours(graph: CSRGraph, flat: torch.Tensor) -> torch.Tensor:
    flat = flat.clamp(0, graph.indices.shape[0] - 1)
    return graph.indices[flat.reshape(-1)]


def sample_layer(
    graph: CSRGraph,
    inputs: torch.Tensor,
    fanout: int,
    sample_type: SampleType,
    rand: Rand,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample one hop.

    inputs: [N_cap] int32 seed ids, -1 padded. Returns (neighbours
    [N_cap*fanout] int32 -1-padded, slot i*fanout+j is seed i's j-th pick;
    valid [N_cap*fanout] bool). The reference also returns a region-fetch
    overflow flag, which is always False without the region fetch.
    """
    if sample_type not in (SampleType.KHOP0, SampleType.KHOP2):
        raise NotImplementedError(
            f"sample_layer: {sample_type} is not ported yet (ROADMAP.md A12)"
        )
    n = inputs.shape[0]
    node_ok, off, deg = _offsets_degrees(graph, inputs)
    u = _uniforms(rand, (n, fanout), inputs.device)
    idx, valid = _floyd_without_replacement(u, deg, fanout)
    nbr = _neighbours(graph, off[:, None] + idx.clamp(min=0).long())
    valid = valid.reshape(-1) & node_ok.repeat_interleave(fanout)
    return torch.where(valid, nbr, -1), valid


def _tiered_last_hop(
    graph: CSRGraph,
    cur: torch.Tensor,
    num_cur: torch.Tensor,
    tier_layout: Sequence[Tuple[int, int]],
    rand: Rand,
    with_out_degrees: bool = False,
):
    """Degree-tiered no-dedup last hop (uniform without replacement).

    ``tier_layout`` = ((cap_0, w_0), (cap_1, w_1), ...), caps summing to the
    frontier cap, widths descending. Tier 0 Floyd-samples at the full
    fanout; every lower tier holds vertices with deg <= its width and takes
    all their neighbours (the same distribution). The frontier is ordered
    by a stable sort on the tier class, which gives the reference's
    (class, position) order. ``rand`` feeds tier 0's ``[cap_0, w_0]`` draw.

    Returns ``(block, unique, num_unique, ovf)``; ``ovf`` flags a
    tier-prefix cap exceeded. ``with_out_degrees`` sets the block's
    ``src_out_deg``: 1 for each valid slot (its own src), 0 elsewhere.
    """
    V = cur.shape[0]
    caps = [c for c, _ in tier_layout]
    widths = [w for _, w in tier_layout]
    assert sum(caps) == V, (caps, V)
    device = cur.device
    _, off, deg = _offsets_degrees(graph, cur)

    # tier class: 0 for deg > widths[1], else the narrowest take-all tier
    # whose width covers deg (padding has deg 0: last tier, no picks)
    c = torch.zeros(V, dtype=torch.int32, device=device)
    for t in widths[1:]:
        c += (deg <= t).to(torch.int32)
    _, order = torch.sort(c, stable=True)
    deg_p = deg[order]
    off_p = off[order]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(V, device=device)

    ovf = torch.zeros((), dtype=torch.bool, device=device)
    pref = 0
    for j in range(len(caps) - 1):
        pref += caps[j]
        ovf = ovf | ((c <= j).sum() > pref)

    nbrs, valids, dsts = [], [], []
    pos = 0
    for i, (cap_i, w_i) in enumerate(zip(caps, widths)):
        deg_i = deg_p[pos:pos + cap_i]
        off_i = off_p[pos:pos + cap_i]
        if i == 0:
            u = _uniforms(rand, (cap_i, w_i), device)
            idx_i, valid_i = _floyd_without_replacement(u, deg_i, w_i)
            flat = off_i[:, None] + idx_i.clamp(min=0).long()
        else:
            col = torch.arange(w_i, device=device)
            valid_i = col[None, :] < torch.clamp(deg_i, max=w_i)[:, None]
            flat = off_i[:, None] + col[None, :]
        nbrs.append(_neighbours(graph, flat))
        valids.append(valid_i.reshape(-1))
        dsts.append(order[pos:pos + cap_i, None].expand(cap_i, w_i).reshape(-1))
        pos += cap_i

    valid = torch.cat(valids)
    nbr = torch.cat(nbrs)
    slot = torch.arange(valid.shape[0], dtype=torch.int32, device=device)
    unique = torch.cat([cur, torch.where(valid, nbr, -1)])
    num_unique = num_cur + valid.sum().to(torch.int32)
    blk = Block(
        src_local=torch.where(valid, V + slot, -1),
        dst_local=torch.where(valid, torch.cat(dsts).to(torch.int32), -1),
        mask=valid,
        num_src=num_unique,
        num_dst=num_cur,
        src_slice_offset=V,
        src_out_deg=_slot_out_degrees(V, valid) if with_out_degrees else None,
        tier_split=tuple(tuple(t) for t in tier_layout),
        dst_invperm=inv.to(torch.int32),
    )
    return blk, unique, num_unique, ovf


def _append_slots(cur: torch.Tensor, num_cur: torch.Tensor, nbrs: torch.Tensor,
                  valid: torch.Tensor):
    """A no-dedup hop's src space: the sampled slots appended after the
    frontier, so slot j's src is ``S + j`` (``gather_src`` is a slice).
    Returns ``(unique, num_unique, src_local)``."""
    S = cur.shape[0]
    slot = torch.arange(nbrs.shape[0], dtype=torch.int32, device=cur.device)
    return (torch.cat([cur, torch.where(valid, nbrs, -1)]),
            num_cur + valid.sum().to(torch.int32),
            torch.where(valid, S + slot, -1))


def _slot_out_degrees(frontier: int, valid: torch.Tensor) -> torch.Tensor:
    """Src out-degrees of a no-dedup hop: each appended slot is its own
    src, used by exactly its own edge; frontier entries are never a src."""
    return torch.cat([valid.new_zeros(frontier, dtype=torch.int32),
                      valid.to(torch.int32)])


def _tiered(plan: SamplePlan, sample_type: SampleType,
            dedup_last_hop: bool) -> bool:
    return (not dedup_last_hop and plan.tier_layout is not None
            and sample_type in (SampleType.KHOP0, SampleType.KHOP2))


def uniform_shapes(plan: SamplePlan, sample_type: SampleType,
                   dedup_last_hop: bool) -> List[Tuple[int, int]]:
    """Shape of the uniforms each hop of :func:`multi_layer_sample` draws."""
    shapes = [(plan.num_input_cap[h], plan.fanouts[h])
              for h in range(plan.num_layer)]
    if _tiered(plan, sample_type, dedup_last_hop):
        shapes[-1] = tuple(plan.tier_layout[0])
    return shapes


def multi_layer_sample(
    graph: CSRGraph,
    seeds: torch.Tensor,
    num_seeds,
    plan: SamplePlan,
    sample_type: SampleType,
    dedup_last_hop: bool = True,
    with_out_degrees: bool = False,
    *,
    rand: Union[torch.Generator, Sequence[torch.Tensor]],
) -> SampledBatch:
    """Sample all hops + dedup + local-id remap.

    Per hop: sample, then (unless this is the no-dedup last hop) the
    one-sort ``unique_and_remap``; the final unique list is the batch's
    ``input_nodes``. ``dedup_last_hop=False`` skips the last hop's dedup:
    ``input_nodes`` becomes ``[frontier | sampled neighbours]`` and each
    edge's src is its own slot, so the model's source gather is a slice;
    with a tier layout in the plan that hop is tiered.

    ``with_out_degrees=True`` sets every block's ``src_out_deg`` (GCN's
    norm='both' reads it): from the dedup sort's counts on a dedup hop, and
    one per valid slot on a no-dedup last hop.

    ``rand``: a generator, or one uniforms tensor per hop with the shapes
    of :func:`uniform_shapes`.
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
        fanout = plan.fanouts[hop]
        last = hop == plan.num_layer - 1
        hop_rand = rand if isinstance(rand, torch.Generator) else rand[hop]

        if last and _tiered(plan, sample_type, dedup_last_hop):
            blk, cur, num_cur, t_ovf = _tiered_last_hop(
                graph, cur, num_cur, plan.tier_layout, hop_rand,
                with_out_degrees,
            )
            overflowed = overflowed | t_ovf
            blocks_rev.append(blk)
            continue

        nbrs, valid = sample_layer(graph, cur, fanout, sample_type, hop_rand)
        S = cur.shape[0]
        counts = None
        if last and not dedup_last_hop:
            unique, num_unique, src_local = _append_slots(cur, num_cur, nbrs,
                                                          valid)
            if with_out_degrees:
                counts = _slot_out_degrees(S, valid)
        else:
            unique, num_unique, src_local, ovf, *rest = unique_and_remap(
                cur, num_cur, nbrs, plan.num_unique_cap[hop],
                with_counts=with_out_degrees,
            )
            counts = rest[0] if rest else None
            overflowed = overflowed | ovf

        dst_local = torch.arange(
            S, dtype=torch.int32, device=device
        ).repeat_interleave(fanout)
        mask = valid & (src_local >= 0)
        blocks_rev.append(Block(
            src_local=torch.where(mask, src_local, -1),
            dst_local=torch.where(mask, dst_local, -1),
            mask=mask,
            num_src=num_unique,
            num_dst=num_cur,
            src_out_deg=counts,
            slots_per_dst=fanout,
            src_slice_offset=S if (last and not dedup_last_hop) else None,
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
