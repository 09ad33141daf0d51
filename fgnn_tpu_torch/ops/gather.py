"""Row gather: ``out[i] = table[ids[i]]``, a zero row where ``ids[i] < 0``.

Python side of ``csrc/gather_rows.cu``, the Hopper kernel that replaces the
TPU's Pallas gathers ``fgnn_tpu/ops/pallas_gather2.py::gather_rows_v2`` and
``fgnn_tpu/ops/pallas_gather.py::gather_rows`` / ``gather_rows_padded``. It
takes any number of ids (no block multiple) and issues no table read for a
padding id.

Contract: ``table`` is a contiguous ``[N, D]`` tensor of any dtype, ``ids`` a
contiguous ``[M]`` int32 tensor with every id in ``[-1, N)``. Ids at or past
``N`` are outside the contract: the kernel would read past the table.

On a CPU tensor :func:`gather_rows` runs the plain version,
:func:`gather_rows_reference`. On a CUDA tensor it launches the kernel or
raises; it never falls back.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_lib

KERNEL = "gather_rows"


def gather_rows_reference(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain torch version: the semantics of ``device_gather``."""
    out = table[ids.clamp(min=0).long()]
    return out.masked_fill((ids < 0).unsqueeze(1), 0)


def _check(table: torch.Tensor, ids: torch.Tensor) -> None:
    if table.device.type != "cuda" or ids.device != table.device:
        raise ValueError(
            f"gather_rows: table on {table.device} and ids on {ids.device}; "
            "both must be on the same CUDA device"
        )
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(
            f"gather_rows: table must be a contiguous 2-D tensor, got shape "
            f"{tuple(table.shape)} contiguous={table.is_contiguous()}"
        )
    if ids.dtype != torch.int32 or ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError(
            f"gather_rows: ids must be a contiguous 1-D int32 tensor, got "
            f"{ids.dtype} shape {tuple(ids.shape)}"
        )
    if ids.shape[0] >= 2**34:  # 32 threads a row, 256 a block, 2^31 blocks
        raise ValueError(f"gather_rows: {ids.shape[0]} ids exceed the grid")
    if table.shape[1] * table.element_size() >= 2**31:
        raise ValueError("gather_rows: a table row must be under 2^31 bytes")


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = cuda_lib.load(KERNEL).fgnn_gather_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``[M, D]`` rows of ``table``; zero rows where ``ids < 0``."""
    if table.device.type == "cpu" and ids.device.type == "cpu":
        return gather_rows_reference(table, ids)
    _check(table, ids)
    m, d = ids.shape[0], table.shape[1]
    out = torch.empty((m, d), dtype=table.dtype, device=table.device)
    if m == 0 or d == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), ids.data_ptr(), out.data_ptr(), m,
                 d * table.element_size(), stream)
    if err != 0:
        raise RuntimeError(f"gather_rows: kernel launch failed, CUDA error {err}")
    cuda_lib.count_launch(KERNEL)
    return out


class GatherRows(torch.autograd.Function):
    """Differentiable :func:`gather_rows`.

    The backward is the JAX reference's: XLA's scatter-add of the output
    gradient into the table rows, here ``index_add_`` of the valid rows into
    zeros. It accumulates in float32 and casts back to the table's dtype, so
    bf16 rows that many ids share do not lose their small terms.
    """

    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(ids)
        ctx.num_rows = table.shape[0]
        return gather_rows(table, ids)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        if not ctx.needs_input_grad[0]:
            return None, None
        (ids,) = ctx.saved_tensors
        valid = (ids >= 0).unsqueeze(1)
        grad = torch.zeros((ctx.num_rows, grad_out.shape[1]),
                           dtype=torch.float32, device=grad_out.device)
        grad.index_add_(0, ids.clamp(min=0).long(),
                        grad_out.float().masked_fill(~valid, 0))
        return grad.to(grad_out.dtype), None
