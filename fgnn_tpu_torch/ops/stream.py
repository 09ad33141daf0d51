"""Streaming pass ``x + 1`` over a contiguous float32 array, one block per
chunk of rows.

Python side of ``csrc/stream_add_one.cu``, the Hopper kernel that replaces
K3, the TPU's inline Pallas ``copy_kernel`` in
``tools/gather_campaign.py::stream_campaign``. Like K3 it exists to measure
the card's contiguous copy ceiling (``tools/gather_campaign.py stream``).
``chunk_rows`` keeps the meaning of the Pallas chunk: the rows one block
owns. Unlike Pallas, N need not be a multiple of it.

On a CPU tensor :func:`stream_add_one` runs the plain version,
:func:`stream_add_one_reference`. On a CUDA tensor it launches the kernel or
raises; it never falls back.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_lib

KERNEL = "stream_add_one"


def stream_add_one_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain torch version: the Pallas body ``o = x + 1.0``."""
    return x + 1.0


def _check(x: torch.Tensor, chunk_rows: int) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"stream_add_one: float32 only (as K3), got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(
            f"stream_add_one: x must be a contiguous 2-D tensor, got shape "
            f"{tuple(x.shape)} contiguous={x.is_contiguous()}"
        )
    if chunk_rows <= 0 or chunk_rows * max(x.shape[1], 1) >= 2**31:
        raise ValueError(
            f"stream_add_one: a chunk of {chunk_rows} rows of {x.shape[1]} "
            "elements must hold 1 to 2^31 - 1 elements"
        )


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = cuda_lib.load(KERNEL).fgnn_stream_add_one
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def stream_add_one(x: torch.Tensor, chunk_rows: int = 512) -> torch.Tensor:
    """``x + 1`` into a new ``[N, D]`` float32 tensor."""
    _check(x, chunk_rows)
    if x.device.type == "cpu":
        return stream_add_one_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"stream_add_one: x on {x.device}, needs a CUDA device")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), x.numel(),
                 chunk_rows * x.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"stream_add_one: kernel launch failed, CUDA error {err}")
    cuda_lib.count_launch(KERNEL)
    return out
