"""Feature / label extraction (port of ``fgnn_tpu/ops/extract.py``).

The feature gathers go through the Hopper row-gather kernel
(:mod:`fgnn_tpu_torch.ops.gather`); the label gather is a 1-D take, which
the reference leaves to XLA as well.
"""
from __future__ import annotations

import torch

from .gather import GatherRows


def device_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """output[i] = table[ids[i]]; padded ids (-1) produce zero rows."""
    return GatherRows.apply(table, ids)


def mock_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Empty-feat mode: index modulo the fake table size (GPUMockExtract)."""
    return GatherRows.apply(table, torch.where(ids >= 0, ids % table.shape[0], -1))


def label_gather(labels: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Labels for the batch seeds; padded ids -> -1."""
    out = labels[ids.clamp(min=0).long()]
    return torch.where(ids >= 0, out, -1)
