"""Neighbourhood sampling (port of ``fgnn_tpu/ops/sampling.py``).

Static shapes as in the reference: every hop emits a fixed number of edge
slots, -1 padded, with a validity mask. Ported: uniform sampling without
replacement (KHOP0/KHOP2) by Floyd's algorithm and with replacement
(KHOP1), the weighted samplers over the dataset's per-edge tables (alias,
prefix-sum binary search, and the hash-dedup sampler's take-all / Gumbel
top-k / first-k-distinct branches), the one-sort dedup hop with its
direct-index alternative, and the degree-tiered no-dedup last hop. The TPU
workarounds of the reference (``take_1d_blocked`` lane selects over a
lane-padded ``indices``, the region fetch, the hash-dedup sampler's
two-row weight window) are left out: plain indexing is the gather here.

Randomness: every sampler takes its float32 uniforms of one hop as
``rand``, either a :class:`torch.Generator` on the tensors' device or the
``[n, width]`` tensor itself (:func:`draw_width`). The injected form lets a
test feed the reference's exact ``jax.random.uniform`` draws; then picks,
locals and masks match the reference exactly. A sampler that takes several
draws reads them as column blocks of the one tensor, in the reference's
order: the alias sampler ``[u1 | u2]`` (``split(key)``), the hash-dedup
sampler ``[gumbel (128 columns) | alias u1 | alias u2]``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import torch

from ..config import SampleType, env_int
from .hashtable import unique_and_remap, unique_and_remap_direct
from .padding import SamplePlan

Rand = Union[torch.Generator, torch.Tensor]

# direct-index dedup (the source system's SXN_NAIVE_HASHMAP): used by every
# dedup hop without counts on a graph of at most this many nodes; 0, the
# reference's default, keeps the one-sort dedup everywhere
DIRECT_REMAP_MAX_NODES = env_int("FGNN_TPU_DIRECT_REMAP_MAX_NODES", 0)
# oversampling rounds of the hash-dedup sampler's stream branch: T = ROUNDS
# * fanout alias draws, the first `fanout` distinct kept
HASHDEDUP_ROUNDS = env_int("FGNN_TPU_HASHDEDUP_ROUNDS", 4)
# degree bound of the hash-dedup sampler's exact Gumbel branch
GUMBEL_MAX_DEG = 128

# the per-edge tables each weighted sampler reads
WEIGHT_TABLES = {
    SampleType.WEIGHTED_KHOP: ("prob_table", "alias_table"),
    SampleType.WEIGHTED_KHOP_PREFIX: ("prob_prefix_table",),
    SampleType.WEIGHTED_KHOP_HASH_DEDUP: ("prob_table", "alias_table",
                                          "prob_prefix_table"),
}


@dataclasses.dataclass
class CSRGraph:
    """Device-resident CSR topology."""

    indptr: torch.Tensor   # [N+1] int64
    indices: torch.Tensor  # [E] int32
    prob_table: Optional[torch.Tensor] = None
    alias_table: Optional[torch.Tensor] = None
    prob_prefix_table: Optional[torch.Tensor] = None

    @property
    def num_node(self) -> int:
        return self.indptr.shape[0] - 1


def check_weight_tables(holder, sample_type: SampleType) -> None:
    """Raise ``ValueError`` when ``holder`` (a ``Dataset`` or a
    :class:`CSRGraph`) lacks a table that ``sample_type`` reads."""
    missing = [t for t in WEIGHT_TABLES.get(sample_type, ())
               if getattr(holder, t) is None]
    if missing:
        raise ValueError(
            f"{sample_type.value} samples over the per-edge tables "
            f"{', '.join(missing)}, which are missing: build them with "
            "fgnn_tpu_torch.data.build_alias_tables(ds)")


def draw_width(sample_type: SampleType, fanout: int) -> int:
    """Columns of one hop's ``[n, width]`` uniforms for ``sample_type``."""
    if sample_type == SampleType.WEIGHTED_KHOP:
        return 2 * fanout
    if sample_type == SampleType.WEIGHTED_KHOP_HASH_DEDUP:
        return GUMBEL_MAX_DEG + 2 * HASHDEDUP_ROUNDS * fanout
    return fanout


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

    @property
    def num_edge_cap(self) -> int:
        return self.src_local.shape[0]


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


def _with_replacement(u: torch.Tensor, deg: torch.Tensor, fanout: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KHOP1: ``fanout`` uniform slots of [0, deg) with replacement,
    ``min(floor(u * float32(deg)), deg - 1)``."""
    idx = torch.floor(u * deg[:, None].to(torch.float32)).to(torch.int32)
    idx = torch.minimum(idx, deg[:, None] - 1)
    valid = (deg > 0)[:, None].expand(idx.shape)
    return torch.where(valid, idx, -1), valid


def _weighted_alias(u: torch.Tensor, deg: torch.Tensor, off: torch.Tensor,
                    graph: CSRGraph, fanout: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alias-method weighted sampling with replacement
    (cuda_sampling_weighted_khop.cu): a uniform slot j from ``u[:, :f]``,
    kept if ``u[:, f:] < prob[off + j]``, else ``alias[off + j]``."""
    u1, u2 = u[:, :fanout], u[:, fanout:]
    slot = torch.minimum(
        torch.floor(u1 * deg[:, None].to(torch.float32)).to(torch.int32),
        deg[:, None] - 1)
    flat = (off[:, None] + slot).clamp(0, graph.indices.shape[0] - 1)
    idx = torch.where(u2 < graph.prob_table[flat], slot,
                      graph.alias_table[flat])
    valid = (deg > 0)[:, None].expand(idx.shape)
    return torch.where(valid, idx, -1), valid


def _weighted_prefix(u: torch.Tensor, deg: torch.Tensor, off: torch.Tensor,
                     graph: CSRGraph, fanout: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted sampling with replacement by binary search on the
    per-vertex prefix sums (cuda_sampling_weighted_khop_prefix.cu): the
    smallest j with ``prefix[off + j] >= u * total``, in float32 and over
    32 steps, as the reference."""
    prefix = graph.prob_prefix_table
    E = prefix.shape[0]
    n = deg.shape[0]
    last = (off + deg - 1).clamp(0, E - 1)
    total = torch.where(deg > 0, prefix[last], 0.0)
    u = u * total[:, None]
    lo = torch.zeros((n, fanout), dtype=torch.int32, device=deg.device)
    hi = deg[:, None].expand(n, fanout)
    for _ in range(32):
        mid = (lo + hi) // 2
        go_right = prefix[(off[:, None] + mid).clamp(0, E - 1)] < u
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    idx = torch.minimum(lo, deg[:, None] - 1)
    valid = (deg > 0)[:, None].expand(idx.shape)
    return torch.where(valid, idx, -1), valid


def _first_k_distinct(idx: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row, the first k distinct values of ``idx`` in draw order (a
    weighted sample without replacement, given the stream holds k distinct
    values). Short rows pad with -1/False."""
    n, T = idx.shape
    sv, order = torch.sort(idx, dim=-1, stable=True)   # by value, ties by pos
    first = torch.ones_like(sv, dtype=torch.bool)
    first[:, 1:] = sv[:, 1:] != sv[:, :-1]
    # first-occurrence positions of each distinct value; T = "no value"
    spos = torch.sort(torch.where(first, order, T), dim=-1).values[:, :k]
    valid = spos < T
    picks = idx.gather(1, spos.clamp(max=T - 1))
    return torch.where(valid, picks, -1), valid


def _weighted_gumbel_dedup(u: torch.Tensor, deg: torch.Tensor,
                           off: torch.Tensor, graph: CSRGraph, fanout: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted sampling without replacement, the hash-dedup sampler
    (cuda_sampling_weighted_khop_hash_dedup.cu), by degree:

      deg <= fanout       : every slot once;
      fanout < deg <= 128 : exact, the top ``fanout`` of
                            ``log w_j + Gumbel_j`` over the vertex's
                            weights, ``w_j`` the prefix table's differences;
      deg > 128           : ``HASHDEDUP_ROUNDS * fanout`` alias draws, the
                            first ``fanout`` distinct kept (shortfall rows
                            keep fewer edges).

    ``u[:, :128]`` feeds the Gumbel noise, ``u[:, 128:]`` the alias draws.
    The top-k is a stable descending sort: among equal scores the lower
    slot first, the order of ``jax.lax.top_k`` (``torch.topk`` promises no
    order among ties).
    """
    G = GUMBEL_MAX_DEG
    if fanout > G:
        raise ValueError(f"hash-dedup sampling needs fanout <= {G}, got "
                         f"{fanout}")
    prefix = graph.prob_prefix_table
    device = deg.device
    col = torch.arange(fanout, dtype=torch.int32, device=device)
    small = col[None, :] < deg[:, None]

    # Gumbel branch: w_0 = prefix[off], w_j = prefix[off+j] - prefix[off+j-1]
    wcol = torch.arange(G, device=device)
    win = prefix[(off[:, None] + wcol).clamp(0, prefix.shape[0] - 1)]
    w = torch.cat([win[:, :1], win[:, 1:] - win[:, :-1]], dim=1)
    in_deg = wcol[None, :] < deg.clamp(max=G)[:, None]
    gumbel = -torch.log(-torch.log(u[:, :G].clamp(1e-20, 1.0)))
    score = torch.where(in_deg, torch.log(w.clamp(min=1e-20)) + gumbel,
                        -torch.inf)
    gumbel_picks = torch.sort(score, dim=1, descending=True,
                              stable=True).indices[:, :fanout].to(torch.int32)

    # stream branch: oversample, then the first `fanout` distinct
    draws, _ = _weighted_alias(u[:, G:], deg, off, graph,
                               HASHDEDUP_ROUNDS * fanout)
    stream_picks, stream_ok = _first_k_distinct(draws, fanout)

    big = deg[:, None] > fanout
    huge = deg[:, None] > G
    picks = torch.where(huge, stream_picks,
                        torch.where(big, gumbel_picks, col[None, :]))
    valid = torch.where(huge, stream_ok, big | small)
    return torch.where(valid, picks, -1), valid


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

    inputs: [N_cap] int32 seed ids, -1 padded. ``rand``: the hop's
    ``[N_cap, draw_width(sample_type, fanout)]`` uniforms or a generator.
    Returns (neighbours [N_cap*fanout] int32 -1-padded, slot i*fanout+j is
    seed i's j-th pick; valid [N_cap*fanout] bool). The reference also
    returns a region-fetch overflow flag, which is always False without the
    region fetch.
    """
    n = inputs.shape[0]
    check_weight_tables(graph, sample_type)
    node_ok, off, deg = _offsets_degrees(graph, inputs)
    u = _uniforms(rand, (n, draw_width(sample_type, fanout)), inputs.device)
    if sample_type in (SampleType.KHOP0, SampleType.KHOP2):
        idx, valid = _floyd_without_replacement(u, deg, fanout)
    elif sample_type == SampleType.KHOP1:
        idx, valid = _with_replacement(u, deg, fanout)
    elif sample_type == SampleType.WEIGHTED_KHOP:
        idx, valid = _weighted_alias(u, deg, off, graph, fanout)
    elif sample_type == SampleType.WEIGHTED_KHOP_HASH_DEDUP:
        idx, valid = _weighted_gumbel_dedup(u, deg, off, graph, fanout)
    elif sample_type == SampleType.WEIGHTED_KHOP_PREFIX:
        idx, valid = _weighted_prefix(u, deg, off, graph, fanout)
    else:
        raise ValueError(f"sample_layer does not handle {sample_type}")
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
    shapes = [(plan.num_input_cap[h], draw_width(sample_type, plan.fanouts[h]))
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
    one-sort ``unique_and_remap`` (the direct-index one on a graph of at
    most ``DIRECT_REMAP_MAX_NODES`` nodes, where no counts are asked for);
    the final unique list is the batch's
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
        elif with_out_degrees:
            unique, num_unique, src_local, ovf, counts = unique_and_remap(
                cur, num_cur, nbrs, plan.num_unique_cap[hop], with_counts=True)
            overflowed = overflowed | ovf
        else:
            if graph.num_node <= DIRECT_REMAP_MAX_NODES:
                unique, num_unique, src_local, ovf = unique_and_remap_direct(
                    cur, num_cur, nbrs, plan.num_unique_cap[hop],
                    graph.num_node)
            else:
                unique, num_unique, src_local, ovf = unique_and_remap(
                    cur, num_cur, nbrs, plan.num_unique_cap[hop])
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
