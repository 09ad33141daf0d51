"""Segment sums of rows and the row scatter-add: the regular-block
aggregation and the gather's backward as Hopper kernels.

Python side of two kernels that replace no TPU kernel (no ``pallas_call``
computes either); they take over torch ops of K1's path that an H100
profile of GCN's training step put first:

* K4 ``csrc/segment_sum_rows.cu``, :func:`segment_sum_rows`: ``out[d] =
  sum of rows[d*K + k] over k < K where mask[d*K + k]`` for a regular block
  (slot ``d*K + k`` belongs to dst ``d``), the forward of ``segment_agg``'s
  regular branch. :func:`segment_sum_rows_by_ptr` is the same kernel on
  explicit segments: ``out[r] = sum of rows[idx[j]] over ptr[r] <= j <
  ptr[r+1] where idx[j] >= 0``, in ascending ``j``.
* K5 ``csrc/scatter_add_rows.cu``, :func:`scatter_add_rows`: K1's
  transpose, ``grad[ids[i]] += grad_out[i // K]`` for every slot ``i`` with
  ``ids[i] >= 0`` (and ``mask[i]``), accumulated in float32 and cast back.
  ``K = 1`` is ``GatherRows``' backward; ``K > 1`` reads each dst's
  gradient row once and adds it into that dst's K sources, so no ``[E, D]``
  gradient is built. Its adds are float32 atomics; under
  ``torch.are_deterministic_algorithms_enabled()`` it sorts the valid
  slots by target row instead (:func:`sorted_segments`) and sums each row
  with K4's explicit mode, in ascending slot order: bit-equal from run to
  run.

:class:`GatherSegmentSum` chains K1 and K4 for a regular, gathered block
and takes K5 as its backward.

Contracts: float32 or bfloat16 rows, contiguous; ``mask`` bool, ``ids``
int32, ``ptr`` and ``idx`` int64, all contiguous and 1-D; ids in ``[-1,
num_rows)``, idx in ``[-1, rows)``, ``ptr[0] == 0`` and nondecreasing.
Ids past the contract would make the kernels read or write past a buffer.

On CPU tensors each function runs its plain version (``*_reference``),
which is the torch code these kernels took over; on CUDA tensors it
launches its kernel or raises, and never falls back.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import cuda_lib, gather

SEGMENT_KERNEL = "segment_sum_rows"
SCATTER_KERNEL = "scatter_add_rows"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# -- plain versions -------------------------------------------------------------

def segment_sum_rows_reference(rows: torch.Tensor, mask: torch.Tensor,
                               dst_cap: int, K: int) -> torch.Tensor:
    """``[dst_cap, D]``: the masked sum of each dst's K slots, as
    ``segment_agg``'s regular branch computed it."""
    D = rows.shape[1]
    return torch.where(mask.reshape(dst_cap, K)[..., None],
                       rows.reshape(dst_cap, K, D), 0).sum(1)


def segment_sum_rows_by_ptr_reference(rows: torch.Tensor, ptr: torch.Tensor,
                                      idx: torch.Tensor) -> torch.Tensor:
    """``[len(ptr) - 1, D]``: each explicit segment's rows summed in float32
    in ascending entry order, cast to ``rows.dtype``."""
    num_rows = ptr.shape[0] - 1
    seg = torch.repeat_interleave(
        torch.arange(num_rows, device=ptr.device), ptr.diff())
    entries = idx[: seg.shape[0]]
    valid = (entries >= 0).unsqueeze(1)
    out = torch.zeros((num_rows, rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    out.index_add_(0, seg, rows[entries.clamp(min=0)].float().masked_fill(
        ~valid, 0))
    return out.to(rows.dtype)


def scatter_add_rows_reference(grad_out: torch.Tensor, ids: torch.Tensor,
                               num_rows: int, K: int = 1,
                               mask: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """``[num_rows, D]``: the masked ``index_add_`` of the slots' rows into
    float32 zeros, cast back; for ``K = 1`` without a mask, ``GatherRows``'
    backward as it was."""
    valid = ids >= 0
    if mask is not None:
        valid = valid & mask
    rows = grad_out
    if K != 1:
        rows = grad_out.unsqueeze(1).expand(-1, K, -1).reshape(
            -1, grad_out.shape[1])
    grad = torch.zeros((num_rows, grad_out.shape[1]), dtype=torch.float32,
                       device=grad_out.device)
    grad.index_add_(0, ids.clamp(min=0).long(),
                    rows.float().masked_fill(~valid.unsqueeze(1), 0))
    return grad.to(grad_out.dtype)


def sorted_segments(ids: torch.Tensor, num_rows: int, K: int = 1,
                    mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scatter ``grad[ids[i]] += grad_out[i // K]`` as explicit segments
    over ``grad``'s rows: ``(ptr [num_rows + 1], idx)`` with row ``r``'s
    slots in ascending order at ``idx[ptr[r]:ptr[r+1]]``, each as the row
    of ``grad_out`` it reads. A stable sort of the valid ids (padding takes
    the key ``num_rows`` and sorts past every segment); no host sync."""
    valid = ids >= 0
    if mask is not None:
        valid = valid & mask
    keys = torch.where(valid, ids, num_rows)
    sorted_keys, order = torch.sort(keys, stable=True)
    ptr = torch.searchsorted(
        sorted_keys,
        torch.arange(num_rows + 1, dtype=keys.dtype, device=keys.device))
    return ptr, torch.div(order, K, rounding_mode="floor")


# -- kernels --------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _segment_kernels():
    lib = cuda_lib.load(SEGMENT_KERNEL)
    regular = lib.fgnn_segment_sum_rows
    regular.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                        ctypes.c_int, ctypes.c_void_p]
    by_ptr = lib.fgnn_segment_sum_rows_by_ptr
    by_ptr.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_void_p]
    regular.restype = by_ptr.restype = ctypes.c_int
    return regular, by_ptr


@functools.lru_cache(maxsize=None)
def _scatter_kernel():
    fn = cuda_lib.load(SCATTER_KERNEL).fgnn_scatter_add_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_rows(name: str, rows: torch.Tensor, *others: torch.Tensor) -> None:
    if rows.device.type != "cuda" or any(t.device != rows.device
                                         for t in others):
        raise ValueError(
            f"{name}: tensors on {[str(t.device) for t in (rows, *others)]}; "
            "all must be on the same CUDA device")
    if rows.dtype not in _DTYPES or rows.dim() != 2 or not rows.is_contiguous():
        raise ValueError(
            f"{name}: rows must be a contiguous 2-D float32 or bfloat16 "
            f"tensor, got {rows.dtype} shape {tuple(rows.shape)} "
            f"contiguous={rows.is_contiguous()}")


def _check_index(name: str, what: str, t: torch.Tensor, dtype: torch.dtype,
                 n: Optional[int] = None) -> None:
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous() \
            or (n is not None and t.shape[0] != n):
        raise ValueError(
            f"{name}: {what} must be a contiguous 1-D {dtype} tensor"
            + ("" if n is None else f" of {n}")
            + f", got {t.dtype} shape {tuple(t.shape)}")


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")
    cuda_lib.count_launch(name)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def segment_sum_rows(rows: torch.Tensor, mask: torch.Tensor, dst_cap: int,
                     K: int) -> torch.Tensor:
    """``[dst_cap, D]`` in ``rows.dtype``: each dst's valid slots of
    ``rows [dst_cap * K, D]`` summed in float32 (K4, regular mode)."""
    if rows.device.type == "cpu" and mask.device.type == "cpu":
        return segment_sum_rows_reference(rows, mask, dst_cap, K)
    _check_rows(SEGMENT_KERNEL, rows, mask)
    if rows.shape[0] != dst_cap * K or K <= 0:
        raise ValueError(f"{SEGMENT_KERNEL}: {rows.shape[0]} rows are not "
                         f"dst_cap {dst_cap} x K {K}")
    _check_index(SEGMENT_KERNEL, "mask", mask, torch.bool, rows.shape[0])
    D = rows.shape[1]
    out = torch.empty((dst_cap, D), dtype=rows.dtype, device=rows.device)
    if dst_cap == 0 or D == 0:
        return out
    regular, _ = _segment_kernels()
    with torch.cuda.device(rows.device):
        err = regular(rows.data_ptr(), mask.data_ptr(), K, out.data_ptr(),
                      dst_cap, D, _DTYPES[rows.dtype], _stream(rows))
    _launched(SEGMENT_KERNEL, err)
    return out


def segment_sum_rows_by_ptr(rows: torch.Tensor, ptr: torch.Tensor,
                            idx: torch.Tensor) -> torch.Tensor:
    """``[len(ptr) - 1, D]`` in ``rows.dtype``: each explicit segment's
    rows summed in float32 in ascending entry order (K4, explicit mode);
    every segment is written, zero where it is empty."""
    if rows.device.type == "cpu" and ptr.device.type == "cpu" \
            and idx.device.type == "cpu":
        return segment_sum_rows_by_ptr_reference(rows, ptr, idx)
    _check_rows(SEGMENT_KERNEL, rows, ptr, idx)
    _check_index(SEGMENT_KERNEL, "ptr", ptr, torch.int64)
    _check_index(SEGMENT_KERNEL, "idx", idx, torch.int64)
    num_rows, D = ptr.shape[0] - 1, rows.shape[1]
    out = torch.empty((num_rows, D), dtype=rows.dtype, device=rows.device)
    if num_rows <= 0 or D == 0:
        return out
    _, by_ptr = _segment_kernels()
    with torch.cuda.device(rows.device):
        err = by_ptr(rows.data_ptr(), ptr.data_ptr(), idx.data_ptr(),
                     out.data_ptr(), num_rows, D, _DTYPES[rows.dtype],
                     _stream(rows))
    _launched(SEGMENT_KERNEL, err)
    return out


def scatter_add_rows(grad_out: torch.Tensor, ids: torch.Tensor,
                     num_rows: int, K: int = 1,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[num_rows, D]`` in ``grad_out.dtype``: ``grad[ids[i]] +=
    grad_out[i // K]`` over the valid slots, summed in float32 (K5; under
    deterministic algorithms, :func:`sorted_segments` and K4's explicit
    mode)."""
    if grad_out.device.type == "cpu" and ids.device.type == "cpu":
        return scatter_add_rows_reference(grad_out, ids, num_rows, K, mask)
    others = (ids,) if mask is None else (ids, mask)
    _check_rows(SCATTER_KERNEL, grad_out, *others)
    if K <= 0:
        raise ValueError(f"{SCATTER_KERNEL}: K {K} must be positive")
    num_dst, D = grad_out.shape
    _check_index(SCATTER_KERNEL, "ids", ids, torch.int32, num_dst * K)
    if mask is not None:
        _check_index(SCATTER_KERNEL, "mask", mask, torch.bool, num_dst * K)
    if torch.are_deterministic_algorithms_enabled():
        ptr, idx = sorted_segments(ids, num_rows, K, mask)
        return segment_sum_rows_by_ptr(grad_out, ptr, idx)
    grad = torch.zeros((num_rows, D), dtype=torch.float32,
                       device=grad_out.device)
    if num_dst == 0 or D == 0:
        return grad.to(grad_out.dtype)
    fn = _scatter_kernel()
    with torch.cuda.device(grad_out.device):
        err = fn(grad_out.data_ptr(), ids.data_ptr(),
                 None if mask is None else mask.data_ptr(), grad.data_ptr(),
                 num_dst, K, D, _DTYPES[grad_out.dtype], _stream(grad_out))
    _launched(SCATTER_KERNEL, err)
    return grad.to(grad_out.dtype)


class GatherSegmentSum(torch.autograd.Function):
    """``out[d] = sum of h[src_local[d*K + k]] over k < K where
    mask[d*K + k]``, for a regular block whose sources are gathered.

    Forward: K1 gathers the ``[E, D]`` messages (``gather_rows``, counted as
    K1), K4 sums them; the messages are freed after it. It saves only
    ``src_local``, ``mask``, K and ``h``'s row count. Backward: K5 in
    regular mode, straight from the ``[dst_cap, D]`` gradient.
    """

    @staticmethod
    def forward(ctx, h: torch.Tensor, src_local: torch.Tensor,
                mask: torch.Tensor, dst_cap: int, K: int) -> torch.Tensor:
        ctx.save_for_backward(src_local, mask)
        ctx.num_rows = h.shape[0]
        ctx.K = K
        return segment_sum_rows(gather.gather_rows(h, src_local), mask,
                                dst_cap, K)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        src_local, mask = ctx.saved_tensors
        grad = scatter_add_rows(grad_out.contiguous(), src_local,
                                ctx.num_rows, ctx.K, mask)
        return grad, None, None, None, None
