"""Streaming pass ``x + 1`` over a contiguous float32 array.

Python side of ``csrc/stream_add_one.cu``, the Hopper kernel that replaces
K3, the TPU's inline Pallas ``copy_kernel`` in
``tools/gather_campaign.py::stream_campaign``. Like K3 it exists to measure
the card's contiguous copy ceiling (``tools/gather_campaign.py stream``).
The kernel moves the array in fixed stage tiles by TMA bulk copies through
a shared-memory ring, on a persistent grid sized from the card's SM count
(:func:`launch_config` reports the launch). ``chunk_rows``, the Pallas
chunk that the campaign sweeps, is checked as before and sets nothing: on
the TPU it only sized the VMEM double buffer. N need not be a multiple of
it.

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
def _lib():
    lib = cuda_lib.load(KERNEL)
    lib.fgnn_stream_add_one.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int64, ctypes.c_int64,
                                        ctypes.c_void_p]
    lib.fgnn_stream_add_one.restype = ctypes.c_int
    lib.fgnn_stream_add_one_config.argtypes = [ctypes.c_int64, ctypes.c_void_p]
    lib.fgnn_stream_add_one_config.restype = ctypes.c_int
    return lib


def launch_config(n: int, device) -> dict:
    """The launch the kernel makes for ``n`` float32 elements from a 16-byte
    aligned base on CUDA ``device``."""
    cfg = (ctypes.c_int64 * 6)()
    with torch.cuda.device(device):
        err = _lib().fgnn_stream_add_one_config(n, cfg)
    if err != 0:
        raise RuntimeError(f"stream_add_one: device query failed, CUDA error {err}")
    keys = ("grid", "tiles", "tile_bytes", "stages", "ctas_per_sm", "sms")
    return dict(zip(keys, cfg))


def _launch(x: torch.Tensor, out: torch.Tensor, chunk_rows: int) -> None:
    """``out = x + 1`` on the card, for ``out`` of x's shape at any address."""
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().fgnn_stream_add_one(x.data_ptr(), out.data_ptr(),
                                         x.numel(), chunk_rows * x.shape[1],
                                         stream)
    if err != 0:
        raise RuntimeError(f"stream_add_one: kernel set-up or launch failed, CUDA error {err}")
    cuda_lib.count_launch(KERNEL)


def stream_add_one(x: torch.Tensor, chunk_rows: int = 512) -> torch.Tensor:
    """``x + 1`` into a new ``[N, D]`` float32 tensor."""
    _check(x, chunk_rows)
    if x.device.type == "cpu":
        return stream_add_one_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"stream_add_one: x on {x.device}, needs a CUDA device")
    out = torch.empty_like(x)
    if x.numel() > 0:
        _launch(x, out, chunk_rows)
    return out
