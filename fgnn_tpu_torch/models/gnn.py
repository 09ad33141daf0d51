"""GNN models (port of ``fgnn_tpu/models/gnn.py``): GraphSAGE, GCN, PinSAGE
and GAT.

Each layer consumes one sampled :class:`Block` (input side first) and the
full src-space features ``h`` [src_cap, D]; destination rows are the prefix
``h[:dst_cap]``. Parameters are float32; with a compute ``dtype`` (bf16 on
the main path) inputs, weights and biases are cast to it at each product,
as flax ``Dense(dtype=...)`` does.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.gather import GatherRows
from ..ops.sampling import Block, SampledBatch
from .aggregate import (gather_segment_agg, gather_src, in_degrees,
                        out_degrees, segment_agg, segment_softmax)


def lecun_normal_(weight: torch.Tensor, generator: Optional[torch.Generator]):
    """flax's default kernel init: truncated normal (+-2 sd), variance
    1/fan_in. ``weight`` is a torch ``[out, in]`` Linear weight."""
    fan_in = weight.shape[1]
    # sd of a unit normal truncated to [-2, 2]; flax divides it out
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)


def glorot_uniform_(param: torch.Tensor,
                    generator: Optional[torch.Generator]):
    """flax's ``glorot_uniform`` on a ``(..., fan_in, fan_out)`` parameter:
    uniform in +-sqrt(6 / (fan_in + fan_out)), the leading axes a receptive
    field."""
    *rest, fan_in, fan_out = param.shape
    field = math.prod(rest)
    limit = math.sqrt(6.0 / (field * (fan_in + fan_out)))
    with torch.no_grad():
        param.uniform_(-limit, limit, generator=generator)


def _dense(layer: nn.Linear, x: torch.Tensor,
           dtype: Optional[torch.dtype]) -> torch.Tensor:
    if dtype is None:
        return layer(x)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def dropout(h: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1-p, scale by 1/(1-p)."""
    keep_prob = 1.0 - p
    keep = torch.rand(h.shape, generator=generator, device=h.device) < keep_prob
    return torch.where(keep, h / keep_prob, 0)


class SAGEConv(nn.Module):
    """DGL SAGEConv with the 'mean' aggregator."""

    def __init__(self, in_dim: int, out_dim: int, activation=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc_self = nn.Linear(in_dim, out_dim, bias=True)
        self.fc_neigh = nn.Linear(in_dim, out_dim, bias=False)
        self.activation = activation
        self.dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        lecun_normal_(self.fc_self.weight, generator)
        lecun_normal_(self.fc_neigh.weight, generator)
        nn.init.zeros_(self.fc_self.bias)

    def forward(self, block: Block, h: torch.Tensor, dst_cap: int) -> torch.Tensor:
        agg = gather_segment_agg(h, block, dst_cap, mode="mean")
        out = (_dense(self.fc_self, h[:dst_cap], self.dtype)
               + _dense(self.fc_neigh, agg, self.dtype))
        if self.activation is not None:
            out = self.activation(out)
        return out


class GraphConv(nn.Module):
    """DGL GraphConv, norm='both', allow_zero_in_degree.

    Submodule ``weight`` (a bias-free Linear) and parameter ``bias`` carry
    the flax names, so ``GraphConv_i/weight/kernel`` maps to
    ``layers.i.weight.weight``. As in the reference, ``h * rsqrt(deg)``
    promotes a bf16 product to float32: the aggregation, the bias and the
    layer's output are float32, and the next layer's product casts back.
    """

    def __init__(self, in_dim: int, out_dim: int, activation=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Linear(in_dim, out_dim, bias=False)
        self.bias = nn.Parameter(torch.zeros(out_dim))
        self.activation = activation
        self.dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        lecun_normal_(self.weight.weight, generator)
        nn.init.zeros_(self.bias)

    def forward(self, block: Block, h: torch.Tensor, dst_cap: int) -> torch.Tensor:
        src_cap = h.shape[0]
        h = _dense(self.weight, h, self.dtype)
        h = h * torch.rsqrt(out_degrees(block, src_cap).clamp(min=1))[:, None]
        agg = gather_segment_agg(h, block, dst_cap, mode="sum")
        agg = agg * torch.rsqrt(in_degrees(block, dst_cap).clamp(min=1))[:, None]
        agg = agg + self.bias
        if self.activation is not None:
            agg = self.activation(agg)
        return agg


class WeightedSAGEConv(nn.Module):
    """PinSAGE conv: ``Q`` (Linear + ReLU) on every src row, a mean of the
    neighbours weighted by the block's visit counts, then ``W`` (Linear +
    ReLU) on ``[agg | h_dst]``, L2-normalised (a norm of 0 becomes 1).

    Dropout acts inside the conv, on ``Q``'s and ``W``'s inputs: two masks
    a layer. The weighted mean is float32 (float32 weights promote bf16
    messages, as in the reference), so the concat is float32 and ``W``'s
    product casts it to the compute dtype; the norm is taken on ``W``'s
    output in that dtype.
    """

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 dropout: float = 0.5, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.Q = nn.Linear(in_dim, hidden_dim, bias=True)
        self.W = nn.Linear(hidden_dim + in_dim, out_dim, bias=True)
        self.dropout = dropout
        self.dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for layer in (self.Q, self.W):
            lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, block: Block, h: torch.Tensor, dst_cap: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if block.weights is None:
            raise ValueError("WeightedSAGEConv needs a block with edge weights")
        drop = self.training and self.dropout > 0
        h_dst = h[:dst_cap]
        x = dropout(h, self.dropout, generator) if drop else h
        n = F.relu(_dense(self.Q, x, self.dtype))
        agg = segment_agg(gather_src(n, block), block, dst_cap,
                          mode="weighted_mean", edge_weights=block.weights)
        x = torch.cat([agg, h_dst.to(agg.dtype)], 1)
        if drop:
            x = dropout(x, self.dropout, generator)
        z = F.relu(_dense(self.W, x, self.dtype))
        z_norm = torch.linalg.vector_norm(z, dim=1, keepdim=True)
        return z / torch.where(z_norm == 0, 1.0, z_norm)


class GATConv(nn.Module):
    """DGL GATConv: multi-head additive attention, ``[dst_cap, H, D]`` out.

    ``fc`` (no bias) gives ``feat [N, H, D]``; ``attn_l`` / ``attn_r`` are
    float32 ``(1, H, D)`` parameters, so the scores ``el``/``er`` are
    float32 even for bf16 ``feat``, and so are the messages
    ``feat[src] * alpha``. Every per-edge row gather (``feat[src]``,
    ``el[src]``, ``er[dst]``) goes through the row-gather kernel, or is a
    slice on a no-dedup block; padded edges read zero rows where the
    reference reads row 0, and their attention is 0 in both.
    """

    def __init__(self, in_dim: int, out_dim: int, num_heads: int,
                 attn_drop: float = 0.0, negative_slope: float = 0.2,
                 activation=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc = nn.Linear(in_dim, num_heads * out_dim, bias=False)
        self.attn_l = nn.Parameter(torch.zeros(1, num_heads, out_dim))
        self.attn_r = nn.Parameter(torch.zeros(1, num_heads, out_dim))
        self.num_heads = num_heads
        self.out_dim = out_dim
        self.attn_drop = attn_drop
        self.negative_slope = negative_slope
        self.activation = activation
        self.dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        lecun_normal_(self.fc.weight, generator)
        glorot_uniform_(self.attn_l, generator)
        glorot_uniform_(self.attn_r, generator)

    def forward(self, block: Block, h: torch.Tensor, dst_cap: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        H, D = self.num_heads, self.out_dim
        feat = _dense(self.fc, h, self.dtype)                 # [N, H*D]
        feat3 = feat.view(-1, H, D)
        el = (feat3 * self.attn_l).sum(-1)                    # [N, H] f32
        er = (feat3 * self.attn_r).sum(-1)
        e = F.leaky_relu(
            gather_src(el, block)
            + GatherRows.apply(er[:dst_cap], block.dst_local),
            self.negative_slope)                              # [E, H]
        alpha = segment_softmax(e, block, dst_cap)
        if self.training and self.attn_drop > 0:
            alpha = dropout(alpha, self.attn_drop, generator)
        E = alpha.shape[0]
        msgs = gather_src(feat, block).view(E, H, D) * alpha[:, :, None]
        out = segment_agg(msgs.view(E, H * D), block, dst_cap, mode="sum")
        out = out.view(dst_cap, H, D)
        if self.activation is not None:
            out = self.activation(out)
        return out


class _ConvStack(nn.Module):
    """``num_layers`` convs of class ``conv``, ReLU after all but the last,
    dropout on the input of all but the first."""

    conv = None

    def __init__(self, in_dim: int, hidden_dim: int, num_classes: int,
                 num_layers: int, dropout: float = 0.5,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [num_classes]
        self.layers = nn.ModuleList(
            self.conv(dims[i], dims[i + 1],
                      activation=F.relu if i < num_layers - 1 else None,
                      dtype=dtype)
            for i in range(num_layers)
        )
        self.dropout = dropout
        self.dtype = dtype
        for layer in self.layers:
            layer.reset_parameters(generator)

    def forward(self, batch: SampledBatch, feats: torch.Tensor,
                dst_caps: Sequence[int],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the dropout masks (training mode only)."""
        h = feats if self.dtype is None else feats.to(self.dtype)
        for i, (layer, block) in enumerate(zip(self.layers, batch.blocks)):
            if i != 0 and self.training and self.dropout > 0:
                h = dropout(h, self.dropout, generator)
            h = layer(block, h, dst_caps[i])
        return h


class GraphSAGE(_ConvStack):
    conv = SAGEConv


class GCN(_ConvStack):
    conv = GraphConv


class PinSAGE(nn.Module):
    """``num_layers`` ``WeightedSAGEConv(hidden, dim)``: every layer's
    ``Q`` is ``hidden`` wide, the last layer's output ``num_classes``;
    dropout acts inside the convs."""

    def __init__(self, in_dim: int, hidden_dim: int, num_classes: int,
                 num_layers: int, dropout: float = 0.5,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        ins = [in_dim] + [hidden_dim] * (num_layers - 1)
        outs = [hidden_dim] * (num_layers - 1) + [num_classes]
        self.layers = nn.ModuleList(
            WeightedSAGEConv(i, hidden_dim, o, dropout, dtype=dtype)
            for i, o in zip(ins, outs))
        self.dtype = dtype
        for layer in self.layers:
            layer.reset_parameters(generator)

    def forward(self, batch: SampledBatch, feats: torch.Tensor,
                dst_caps: Sequence[int],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = feats if self.dtype is None else feats.to(self.dtype)
        for layer, block, dst_cap in zip(self.layers, batch.blocks, dst_caps):
            h = layer(block, h, dst_cap, generator)
        return h


class GAT(nn.Module):
    """GATConv stack: dropout on the input of every layer, the first
    included; hidden layers use ELU and flatten their heads (the next
    layer's input is ``hidden * num_heads`` wide); the last layer has
    ``num_out_heads`` and averages them."""

    def __init__(self, in_dim: int, hidden_dim: int, num_classes: int,
                 num_layers: int, num_heads: int = 8, num_out_heads: int = 1,
                 dropout: float = 0.6, attn_drop: float = 0.6,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        heads = [num_heads] * (num_layers - 1) + [num_out_heads]
        ins = [in_dim] + [hidden_dim * num_heads] * (num_layers - 1)
        self.layers = nn.ModuleList(
            GATConv(ins[i], num_classes if i == num_layers - 1 else hidden_dim,
                    heads[i], attn_drop=attn_drop,
                    activation=None if i == num_layers - 1 else F.elu,
                    dtype=dtype)
            for i in range(num_layers))
        self.dropout = dropout
        self.dtype = dtype
        for layer in self.layers:
            layer.reset_parameters(generator)

    def forward(self, batch: SampledBatch, feats: torch.Tensor,
                dst_caps: Sequence[int],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = feats if self.dtype is None else feats.to(self.dtype)
        last = len(self.layers) - 1
        for i, (layer, block) in enumerate(zip(self.layers, batch.blocks)):
            if self.training and self.dropout > 0:
                h = dropout(h, self.dropout, generator)
            o = layer(block, h, dst_caps[i], generator)
            h = o.mean(1) if i == last else o.reshape(o.shape[0], -1)
        return h


def build_model(name: str, in_dim: int, hidden: int, num_classes: int,
                num_layers: int, dropout: float = 0.5,
                dtype: Optional[torch.dtype] = None,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """dtype: compute dtype (e.g. torch.bfloat16); params stay float32.
    ``generator`` draws the initial weights. GAT keeps its reference
    defaults: 8 heads, 1 output head, attention dropout 0.6."""
    name = name.lower()
    models = {"graphsage": GraphSAGE, "sage": GraphSAGE, "gcn": GCN,
              "pinsage": PinSAGE, "gat": GAT}
    if name not in models:
        raise ValueError(f"unknown model {name}")
    return models[name](in_dim, hidden, num_classes, num_layers,
                        dropout=dropout, dtype=dtype, generator=generator)
