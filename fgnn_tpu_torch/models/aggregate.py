"""Mask-aware message passing over padded blocks (port of
``fgnn_tpu/models/aggregate.py``).

Row gathers (``gather_src`` where it gathers, and the tiered ``dst_invperm``
unpermute) go through the Hopper row-gather kernel; the reductions are torch
ops, as the reference leaves them to XLA.
"""
from __future__ import annotations

import torch

from ..ops.gather import GatherRows
from ..ops.sampling import Block


def _regular(block: Block, dst_cap: int) -> bool:
    K = block.slots_per_dst
    return K is not None and block.mask.shape[0] == dst_cap * K


def _tiered(block: Block) -> bool:
    ts = block.tier_split
    return ts is not None and block.mask.shape[0] == sum(v * k for v, k in ts)


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
) -> torch.Tensor:
    """Aggregate per-edge messages [E_cap, D] into [dst_cap, D] rows.

    mode: 'sum' | 'mean'. Regular blocks reduce a dense reshape; tiered
    blocks reduce per tier, concatenate in tier order and unpermute with one
    ``dst_invperm`` row gather; anything else scatter-adds by ``dst_local``.
    """
    if mode not in ("sum", "mean"):
        raise NotImplementedError(
            f"segment_agg mode {mode!r} is not ported yet (ROADMAP.md A10)"
        )
    mask = block.mask
    D = messages.shape[-1]
    if _regular(block, dst_cap):
        K = block.slots_per_dst
        m = mask.reshape(dst_cap, K)
        agg = torch.where(m[..., None], messages.reshape(dst_cap, K, D), 0).sum(1)
        if mode == "mean":
            cnt = m.sum(1).to(messages.dtype)
            agg = agg / cnt.clamp(min=1)[:, None]
        return agg

    if _tiered(block):
        ts = block.tier_split
        assert dst_cap == sum(v for v, _ in ts), (dst_cap, ts)
        sums, dens = [], []
        lo = 0
        for v, k in ts:
            m = mask[lo: lo + v * k].reshape(v, k)
            msg = messages[lo: lo + v * k].reshape(v, k, D)
            sums.append(torch.where(m[..., None], msg, 0).sum(1))
            dens.append(m.sum(1).to(messages.dtype))
            lo += v * k
        agg = torch.cat(sums)
        if mode == "mean":
            agg = agg / torch.cat(dens).clamp(min=1)[:, None]
        return GatherRows.apply(agg.contiguous(), block.dst_invperm)

    dst = torch.where(mask, block.dst_local, dst_cap).long()   # trash row
    msgs = torch.where(mask[:, None], messages, 0)
    agg = messages.new_zeros((dst_cap + 1, D)).index_add_(0, dst, msgs)[:dst_cap]
    if mode == "mean":
        cnt = messages.new_zeros(dst_cap + 1).index_add_(
            0, dst, mask.to(messages.dtype))[:dst_cap]
        agg = agg / cnt.clamp(min=1)[:, None]
    return agg


def in_degrees(block: Block, dst_cap: int) -> torch.Tensor:
    """Valid in-edge count per dst, float32 [dst_cap]."""
    mask = block.mask
    if _regular(block, dst_cap):
        return mask.reshape(dst_cap, block.slots_per_dst).sum(1).float()
    if _tiered(block):
        parts = []
        lo = 0
        for v, k in block.tier_split:
            parts.append(mask[lo: lo + v * k].reshape(v, k).sum(1))
            lo += v * k
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
