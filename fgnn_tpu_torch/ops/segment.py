"""Segment sums of rows and the row scatter-add: the regular-block
aggregation and the gather's backward as Hopper kernels.

Python side of two kernels that replace no TPU kernel (no ``pallas_call``
computes either); they take over torch ops of K1's path that an H100
profile of GCN's training step put first:

* K4 ``csrc/segment_sum_rows.cu``, :func:`segment_sum_rows`: ``out[d] =
  sum of rows[d*K + k] over k < K where mask[d*K + k]`` for a regular block
  (slot ``d*K + k`` belongs to dst ``d``), the forward of ``segment_agg``'s
  regular branch.
* K5 ``csrc/scatter_add_rows.cu``, :func:`scatter_add_rows`: K1's
  transpose, ``grad[r] = sum of grad_out[i // K] over the slots i with
  ids[i] == r`` (and ``mask[i]``), accumulated in float32 and written once
  in ``grad_out``'s dtype. ``K = 1`` is ``GatherRows``' backward; ``K > 1``
  is ``GatherSegmentSum``'s, so no ``[E, D]`` gradient is built. The kernel
  builds the transpose as a CSR (counts, scan, fill) and pulls each output
  row's gradient rows into registers: no zero fill, no float atomics, no
  float32 copy of the output. Under
  ``torch.are_deterministic_algorithms_enabled()`` the CSR comes from a
  stable sort instead (:func:`sorted_segments`) and feeds the same sum
  (:func:`csr_sum_rows`), in ascending slot order: bit-equal from run to
  run.

:class:`GatherSegmentSum` chains K1 and K4 for a regular, gathered block
and takes K5 as its backward.

Contracts: float32 or bfloat16 rows, contiguous; ``mask`` bool, ``ids``,
``ptr`` and ``idx`` int32, all contiguous and 1-D; ids in ``[-1,
num_rows)``, idx in ``[-1, rows)``, ``ptr[0] == 0`` and nondecreasing up to
at most ``len(idx)``; K5's rows and slots under 2^31. Ids past the contract
would make the kernels read or write past a buffer.

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


def segment_sum_rows_by_ptr_reference(rows: torch.Tensor, ptr: torch.Tensor,
                                      idx: torch.Tensor) -> torch.Tensor:
    """``[len(ptr) - 1, D]``: each explicit segment's rows summed in float32
    in ascending entry order, cast to ``rows.dtype``; the plain version of
    :func:`csr_sum_rows`."""
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


def sorted_segments(ids: torch.Tensor, num_rows: int, K: int = 1,
                    mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scatter ``grad[ids[i]] += grad_out[i // K]`` as explicit segments
    over ``grad``'s rows: int32 ``(ptr [num_rows + 1], idx)`` with row
    ``r``'s slots in ascending order at ``idx[ptr[r]:ptr[r+1]]``, each as
    the row of ``grad_out`` it reads. A stable sort of the valid ids
    (padding takes the key ``num_rows`` and sorts past every segment); no
    host sync."""
    valid = ids >= 0
    if mask is not None:
        valid = valid & mask
    keys = torch.where(valid, ids, num_rows)
    sorted_keys, order = torch.sort(keys, stable=True)
    ptr = torch.searchsorted(
        sorted_keys,
        torch.arange(num_rows + 1, dtype=keys.dtype, device=keys.device),
        out_int32=True)
    return ptr, torch.div(order, K, rounding_mode="floor").to(torch.int32)


# -- kernels --------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _segment_kernel():
    fn = cuda_lib.load(SEGMENT_KERNEL).fgnn_segment_sum_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _scatter_kernels():
    """K5's three C symbols: the workspace size, the entry point on ids
    (stages count, scan, fill, sum) and the one on a given CSR (sum)."""
    lib = cuda_lib.load(SCATTER_KERNEL)
    workspace = lib.fgnn_scatter_add_rows_workspace
    workspace.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                          ctypes.c_int]
    workspace.restype = ctypes.c_int64
    by_ids = lib.fgnn_scatter_add_rows
    by_ids.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_void_p]
    by_ptr = lib.fgnn_scatter_add_rows_by_ptr
    by_ptr.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p]
    by_ids.restype = by_ptr.restype = ctypes.c_int
    return workspace, by_ids, by_ptr


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
    if rows.data_ptr() % rows.element_size():
        raise ValueError(f"{name}: rows at {rows.data_ptr():#x} are not "
                         f"aligned to their {rows.element_size()}-byte "
                         "elements")


def _check_index(name: str, what: str, t: torch.Tensor, dtype: torch.dtype,
                 n: Optional[int] = None) -> None:
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous() \
            or (n is not None and t.shape[0] != n):
        raise ValueError(
            f"{name}: {what} must be a contiguous 1-D {dtype} tensor"
            + ("" if n is None else f" of {n}")
            + f", got {t.dtype} shape {tuple(t.shape)}")


def _check_scatter_sizes(num_rows: int, num_slots: int) -> None:
    """K5 counts rows and slots in int32."""
    if not 0 <= num_rows < 2**31 - 1 or num_slots >= 2**31 - 1:
        raise ValueError(
            f"{SCATTER_KERNEL}: {num_rows} rows and {num_slots} slots; each "
            "must be under 2^31 - 1")


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")
    cuda_lib.count_launch(name)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def segment_sum_rows(rows: torch.Tensor, mask: torch.Tensor, dst_cap: int,
                     K: int) -> torch.Tensor:
    """``[dst_cap, D]`` in ``rows.dtype``: each dst's valid slots of
    ``rows [dst_cap * K, D]`` summed in float32 (K4)."""
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
    fn = _segment_kernel()
    with torch.cuda.device(rows.device):
        err = fn(rows.data_ptr(), mask.data_ptr(), K, out.data_ptr(),
                 dst_cap, D, _DTYPES[rows.dtype], _stream(rows))
    _launched(SEGMENT_KERNEL, err)
    return out


def csr_sum_rows(rows: torch.Tensor, ptr: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """``[len(ptr) - 1, D]`` in ``rows.dtype``: ``out[r] = sum of
    rows[idx[j]] over ptr[r] <= j < ptr[r+1] where idx[j] >= 0``, in float32
    in ascending ``j`` (K5's sum stage; a row of more than 128 entries in
    chunks of 128 whose partial sums are folded in order). Every row is
    written, zero where it is empty."""
    if rows.device.type == "cpu" and ptr.device.type == "cpu" \
            and idx.device.type == "cpu":
        return segment_sum_rows_by_ptr_reference(rows, ptr, idx)
    _check_rows(SCATTER_KERNEL, rows, ptr, idx)
    _check_index(SCATTER_KERNEL, "ptr", ptr, torch.int32)
    _check_index(SCATTER_KERNEL, "idx", idx, torch.int32)
    num_rows, D = ptr.shape[0] - 1, rows.shape[1]
    _check_scatter_sizes(num_rows, idx.shape[0])
    out = torch.empty((num_rows, D), dtype=rows.dtype, device=rows.device)
    if num_rows == 0 or D == 0:
        return out
    workspace, _, by_ptr = _scatter_kernels()
    ws = torch.empty(workspace(num_rows, idx.shape[0], D, 0),
                     dtype=torch.uint8, device=rows.device)
    with torch.cuda.device(rows.device):
        err = by_ptr(rows.data_ptr(), ptr.data_ptr(), idx.data_ptr(),
                     out.data_ptr(), ws.data_ptr(), num_rows, idx.shape[0],
                     D, _DTYPES[rows.dtype], _stream(rows))
    _launched(SCATTER_KERNEL, err)
    return out


def scatter_add_rows(grad_out: torch.Tensor, ids: torch.Tensor,
                     num_rows: int, K: int = 1,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[num_rows, D]`` in ``grad_out.dtype``: ``grad[r] = sum of
    grad_out[i // K] over the valid slots i with ids[i] == r``, summed in
    float32 (K5; under deterministic algorithms, :func:`sorted_segments`
    and :func:`csr_sum_rows`). One K5 launch is counted a call."""
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
    _check_scatter_sizes(num_rows, num_dst * K)
    if torch.are_deterministic_algorithms_enabled():
        ptr, idx = sorted_segments(ids, num_rows, K, mask)
        return csr_sum_rows(grad_out, ptr, idx)
    out = torch.empty((num_rows, D), dtype=grad_out.dtype,
                      device=grad_out.device)
    if num_rows == 0 or D == 0:
        return out
    workspace, by_ids, _ = _scatter_kernels()
    ws = torch.empty(workspace(num_rows, num_dst * K, D, 1),
                     dtype=torch.uint8, device=grad_out.device)
    with torch.cuda.device(grad_out.device):
        err = by_ids(grad_out.data_ptr(), ids.data_ptr(),
                     None if mask is None else mask.data_ptr(),
                     out.data_ptr(), ws.data_ptr(), num_dst, K, num_rows, D,
                     _DTYPES[grad_out.dtype], _stream(grad_out))
    _launched(SCATTER_KERNEL, err)
    return out


class GatherSegmentSum(torch.autograd.Function):
    """``out[d] = sum of h[src_local[d*K + k]] over k < K where
    mask[d*K + k]``, for a regular block whose sources are gathered.

    Forward: K1 gathers the ``[E, D]`` messages (``gather_rows``, counted as
    K1), K4 sums them; the messages are freed after it. It saves only
    ``src_local``, ``mask``, K and ``h``'s row count. Backward: K5 with
    the block's K and mask, straight from the ``[dst_cap, D]`` gradient.
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
