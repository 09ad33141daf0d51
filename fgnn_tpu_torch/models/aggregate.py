"""Mask-aware message passing over padded blocks (port of
``fgnn_tpu/models/aggregate.py``).

Row gathers (``gather_src`` where it gathers, and the tiered ``dst_invperm``
unpermute) go through the Hopper row-gather kernel; the reductions, the
weighted mean and the edge softmax are torch ops, as the reference leaves
them to XLA.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.gather import GatherRows
from ..ops.sampling import Block


def _regular(block: Block, dst_cap: int) -> bool:
    K = block.slots_per_dst
    return K is not None and block.mask.shape[0] == dst_cap * K


def _tiered(block: Block) -> bool:
    ts = block.tier_split
    return ts is not None and block.mask.shape[0] == sum(v * k for v, k in ts)


def _per_tier(x: torch.Tensor, tier_split) -> list:
    """``x [E_cap, ...]`` cut into each tier's ``[v, k, ...]`` view by one
    split: its backward joins the tiers' gradients with one cat, where a
    slice per tier would build a zero-filled gradient of the whole of x for
    every tier and add them up."""
    parts = torch.split(x, [v * k for v, k in tier_split])
    return [p.reshape(v, k, *x.shape[1:]) for p, (v, k) in zip(parts, tier_split)]


def gather_src(h_src: torch.Tensor, block: Block) -> torch.Tensor:
    """Per-edge source rows [E_cap, D]; padded edges get zero rows (the
    aggregation masks them either way)."""
    if block.src_slice_offset is not None:
        # no-dedup layout: slot j's src row IS h[offset + j]
        off = block.src_slice_offset
        return h_src[off: off + block.src_local.shape[0]]
    return GatherRows.apply(h_src, block.src_local)


def segment_agg(
    messages: torch.Tensor,
    block: Block,
    dst_cap: int,
    *,
    mode: str = "sum",
    edge_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Aggregate per-edge messages [E_cap, D] into [dst_cap, D] rows.

    mode: 'sum' | 'mean' | 'weighted_mean'. Regular blocks reduce a dense
    reshape; tiered blocks reduce per tier, concatenate in tier order and
    unpermute with one ``dst_invperm`` row gather; anything else
    scatter-adds by ``dst_local``.

    'weighted_mean' weighs each valid edge by ``edge_weights`` [E_cap]
    (float32) and divides by ``max(sum w, 1)``. As in the reference the
    float32 weights promote the messages: the result is float32 even for
    bf16 messages.
    """
    if mode not in ("sum", "mean", "weighted_mean"):
        raise ValueError(f"unknown segment_agg mode {mode!r}")
    weighted = mode == "weighted_mean"
    if weighted and edge_weights is None:
        raise ValueError("segment_agg: weighted_mean needs edge_weights")
    mask = block.mask
    D = messages.shape[-1]

    def dense(m, msg, w):
        """Sum and denominator of ``[v, k]`` slots: mask m, messages msg
        [v, k, D], weights w [v, k] (weighted mode only)."""
        if weighted:
            w = torch.where(m, w, 0.0)
            return (msg * w[..., None]).sum(1), w.sum(1)
        return (torch.where(m[..., None], msg, 0).sum(1),
                m.sum(1).to(messages.dtype))

    if _regular(block, dst_cap):
        K = block.slots_per_dst
        agg, den = dense(
            mask.reshape(dst_cap, K), messages.reshape(dst_cap, K, D),
            edge_weights.reshape(dst_cap, K) if weighted else None)
        if mode == "sum":
            return agg
        return agg / den.clamp(min=1)[:, None]

    if _tiered(block):
        ts = block.tier_split
        assert dst_cap == sum(v for v, _ in ts), (dst_cap, ts)
        sums, dens = zip(*map(
            dense, _per_tier(mask, ts), _per_tier(messages, ts),
            _per_tier(edge_weights, ts) if weighted else [None] * len(ts)))
        agg = torch.cat(sums)
        if mode != "sum":
            agg = agg / torch.cat(dens).clamp(min=1)[:, None]
        return GatherRows.apply(agg.contiguous(), block.dst_invperm)

    dst = torch.where(mask, block.dst_local, dst_cap).long()   # trash row
    if weighted:
        per_edge = torch.where(mask, edge_weights, 0.0)
        msgs = messages * per_edge[:, None]
    else:
        per_edge = mask.to(messages.dtype)
        msgs = torch.where(mask[:, None], messages, 0)
    agg = msgs.new_zeros((dst_cap + 1, D)).index_add_(0, dst, msgs)[:dst_cap]
    if mode == "sum":
        return agg
    den = per_edge.new_zeros(dst_cap + 1).index_add_(0, dst, per_edge)[:dst_cap]
    return agg / den.clamp(min=1)[:, None]


def segment_softmax(scores: torch.Tensor, block: Block,
                    dst_cap: int) -> torch.Tensor:
    """Edge softmax over each dst's valid in-edges (GAT attention).

    scores: [E_cap, H]; returns [E_cap, H], 0 on padded edges. As in the
    reference: padded scores become ``finfo(dtype).min``, a dst with no
    valid edge takes 0 as its max, and the denominator is at least 1e-16.
    Regular and tiered blocks reduce a dense reshape (per tier, in the
    block's own edge order, so nothing is unpermuted); anything else runs
    a segment max and a segment sum by ``dst_local``.
    """
    mask = block.mask
    H = scores.shape[-1]
    neg_inf = torch.finfo(scores.dtype).min

    def dense(m, s):
        """Softmax over dim 1 of s [v, k, H] under mask m [v, k, 1]."""
        s = torch.where(m, s, neg_inf)
        smax = s.amax(1, keepdim=True)
        smax = torch.where(smax == neg_inf, 0.0, smax)
        ex = torch.where(m, torch.exp(s - smax), 0.0)
        return ex / ex.sum(1, keepdim=True).clamp(min=1e-16)

    if _regular(block, dst_cap):
        K = block.slots_per_dst
        return dense(mask.reshape(dst_cap, K, 1),
                     scores.reshape(dst_cap, K, H)).reshape(dst_cap * K, H)

    if _tiered(block):
        ts = block.tier_split
        return torch.cat([
            dense(m[..., None], sc).reshape(-1, H)
            for m, sc in zip(_per_tier(mask, ts), _per_tier(scores, ts))])

    dst = torch.where(mask, block.dst_local, dst_cap).long()   # trash row
    masked = torch.where(mask[:, None], scores, neg_inf)
    smax = masked.new_full((dst_cap + 1, H), neg_inf).scatter_reduce(
        0, dst[:, None].expand(-1, H), masked, "amax")
    smax = torch.where(smax == neg_inf, 0.0, smax)
    ex = torch.where(mask[:, None], torch.exp(masked - smax[dst]), 0.0)
    denom = ex.new_zeros((dst_cap + 1, H)).index_add_(0, dst, ex)
    return ex / denom[dst].clamp(min=1e-16)


def in_degrees(block: Block, dst_cap: int) -> torch.Tensor:
    """Valid in-edge count per dst, float32 [dst_cap]."""
    mask = block.mask
    if _regular(block, dst_cap):
        return mask.reshape(dst_cap, block.slots_per_dst).sum(1).float()
    if _tiered(block):
        parts = [m.sum(1) for m in _per_tier(mask, block.tier_split)]
        return torch.cat(parts).float()[block.dst_invperm.long()]
    dst = torch.where(mask, block.dst_local, dst_cap).long()
    return torch.zeros(dst_cap + 1, device=mask.device).index_add_(
        0, dst, mask.float())[:dst_cap]


def out_degrees(block: Block, src_cap: int) -> torch.Tensor:
    """Valid out-edge count per src, float32 [src_cap]: the sampler's
    ``src_out_deg`` where it emitted one, else a masked scatter-add."""
    if block.src_out_deg is not None:
        return block.src_out_deg[:src_cap].float()
    mask = block.mask
    src = torch.where(mask, block.src_local, src_cap).long()
    return torch.zeros(src_cap + 1, device=mask.device).index_add_(
        0, src, mask.float())[:src_cap]
