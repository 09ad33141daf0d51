"""GNN models (port of ``fgnn_tpu/models/gnn.py``): GraphSAGE and GCN so far.

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

from ..ops.sampling import Block, SampledBatch
from .aggregate import gather_src, in_degrees, out_degrees, segment_agg


def lecun_normal_(weight: torch.Tensor, generator: Optional[torch.Generator]):
    """flax's default kernel init: truncated normal (+-2 sd), variance
    1/fan_in. ``weight`` is a torch ``[out, in]`` Linear weight."""
    fan_in = weight.shape[1]
    # sd of a unit normal truncated to [-2, 2]; flax divides it out
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)


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
        msgs = gather_src(h, block)
        agg = segment_agg(msgs, block, dst_cap, mode="mean")
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
        agg = segment_agg(gather_src(h, block), block, dst_cap, mode="sum")
        agg = agg * torch.rsqrt(in_degrees(block, dst_cap).clamp(min=1))[:, None]
        agg = agg + self.bias
        if self.activation is not None:
            agg = self.activation(agg)
        return agg


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


def build_model(name: str, in_dim: int, hidden: int, num_classes: int,
                num_layers: int, dropout: float = 0.5,
                dtype: Optional[torch.dtype] = None,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """dtype: compute dtype (e.g. torch.bfloat16); params stay float32.
    ``generator`` draws the initial weights."""
    name = name.lower()
    stacks = {"graphsage": GraphSAGE, "sage": GraphSAGE, "gcn": GCN}
    if name in stacks:
        return stacks[name](in_dim, hidden, num_classes, num_layers, dropout,
                            dtype=dtype, generator=generator)
    if name in ("pinsage", "gat"):
        raise NotImplementedError(
            f"model {name!r} is not ported to fgnn_tpu_torch yet "
            "(ROADMAP.md queue A)"
        )
    raise ValueError(f"unknown model {name}")
