"""K5, the row scatter-add (``scatter_add_rows``), on CPU tensors against
the JAX reference's gather backward, from the same numpy inputs.

The reference: ``jax.vjp`` of ``fgnn_tpu.ops.extract.device_gather`` for
``K = 1`` (``GatherRows``' backward), and of that gather followed by the
masked reshape-sum of a regular block for ``K = 5`` (``GatherSegmentSum``'s
backward). The port: ``scatter_add_rows`` itself and under deterministic
algorithms, its deterministic pieces (``sorted_segments``, then K5's sum
stage ``csr_sum_rows``), and the autograd functions whose backward it is.
On the CPU each wrapper runs its plain version; the kernels are held
against those plain versions on the card (``chip_smoke.py`` phase 38).

Tolerance, per array, ``max |port - ref| <= tol * max |ref|``: float32
1e-6 (another summation order), bfloat16 2e-2 (the port rounds its float32
sum to bf16 once). bf16 inputs reach JAX as float32, which holds them
exactly: the port accumulates in float32, where XLA's bf16 scatter-add
would round every partial sum.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgnn_tpu.ops.extract import device_gather
from fgnn_tpu_torch.ops import segment
from fgnn_tpu_torch.ops.gather import GatherRows

torch.set_num_threads(2)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-6, "bfloat16": 2e-2}
CHUNK = 128   # slots K5 sums into one row before it splits the row


def _case(name, rng):
    """``(ids, mask or None, K, num_rows)`` of one scatter as numpy."""
    if name == "permutation":        # a tiered block's dst_invperm
        n = 90
        return rng.permutation(n).astype(np.int32), None, 1, n
    if name == "repeats with padding":
        ids = rng.integers(0, 40, 150).astype(np.int32)
        ids[rng.random(150) < 0.25] = -1
        return ids, None, 1, 40
    if name == "masked block":       # masked slots keep a valid id
        ids = rng.integers(0, 30, 24 * 5).astype(np.int32)
        mask = rng.random(ids.shape[0]) < 0.7
        ids[~mask & (rng.random(ids.shape[0]) < 0.5)] = -1
        return ids, mask, 5, 30
    if name == "rows without slots":  # only the first third receive any
        ids = rng.integers(0, 20, 40 * 5).astype(np.int32)
        return ids, rng.random(ids.shape[0]) < 0.8, 5, 60
    if name == "one row past the chunk":
        ids = rng.integers(0, 50, 80 * 5).astype(np.int32)
        ids[rng.permutation(ids.shape[0])[:3 * CHUNK - 50]] = 7
        return ids, np.ones(ids.shape[0], bool), 5, 50
    if name == "all padding":
        ids = np.full(16 * 5, -1, np.int32)
        return ids, np.zeros(ids.shape[0], bool), 5, 25
    raise ValueError(name)


CASES = ["permutation", "repeats with padding", "masked block",
         "rows without slots", "one row past the chunk", "all padding"]


def _jax_grad(table, ids, mask, K, cot):
    """The reference's gradient of the table: the VJP of the gather (and,
    for K > 1, the block's masked sum) at ``cot``."""
    ids = jnp.asarray(ids)
    if K == 1:
        fn = lambda t: device_gather(t, ids)   # noqa: E731
    else:
        num_dst, D = cot.shape
        keep = jnp.asarray(mask).reshape(num_dst, K)[..., None]
        fn = lambda t: jnp.where(                # noqa: E731
            keep, device_gather(t, ids).reshape(num_dst, K, D), 0).sum(1)
    _, vjp = jax.vjp(fn, jnp.asarray(table))
    return np.asarray(vjp(jnp.asarray(cot))[0])


def _close(port, ref, dtype, what):
    port = port.float().numpy().astype(np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err = np.abs(port - ref).max() if ref.size else 0.0
    scale = np.abs(ref).max() if ref.size else 0.0
    assert err <= TOL[dtype] * scale, (
        f"{what}: max |diff| {err} > {TOL[dtype]} x {scale}")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("D", [172, 7])
@pytest.mark.parametrize("case", CASES)
def test_scatter_add_rows_matches_the_reference_vjp(case, D, dtype):
    rng = np.random.default_rng(CASES.index(case) * 100 + D)
    ids, mask, K, num_rows = _case(case, rng)
    num_dst = ids.shape[0] // K
    t_dtype = DTYPES[dtype]
    # values that the working dtype holds exactly, handed to both sides
    cot = torch.from_numpy(rng.standard_normal((num_dst, D)).astype(
        np.float32)).to(t_dtype)
    table = torch.from_numpy(rng.standard_normal((num_rows, D)).astype(
        np.float32)).to(t_dtype)
    ref = _jax_grad(table.float().numpy(), ids, mask, K, cot.float().numpy())
    if case == "all padding":
        assert not ref.any()

    t_ids = torch.from_numpy(ids)
    t_mask = None if mask is None else torch.from_numpy(mask)
    out = segment.scatter_add_rows(cot, t_ids, num_rows, K, t_mask)
    assert out.dtype == t_dtype and out.shape == (num_rows, D)
    _close(out, ref, dtype, "scatter_add_rows")

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        det = segment.scatter_add_rows(cot, t_ids, num_rows, K, t_mask)
    finally:
        torch.use_deterministic_algorithms(was)
    _close(det, ref, dtype, "scatter_add_rows, deterministic")

    ptr, idx = segment.sorted_segments(t_ids, num_rows, K, t_mask)
    csr = segment.csr_sum_rows(cot, ptr, idx)
    assert csr.dtype == t_dtype
    _close(csr, ref, dtype, "sorted_segments + csr_sum_rows")

    # the autograd functions whose backward K5 is
    h = table.clone().requires_grad_(True)
    if K == 1:
        GatherRows.apply(h, t_ids).backward(cot)
    else:
        segment.GatherSegmentSum.apply(h, t_ids, t_mask, num_dst, K).backward(
            cot)
    assert h.grad.dtype == t_dtype
    _close(h.grad, ref, dtype, "autograd backward")


def test_a_long_row_really_passes_the_chunk():
    """The long-row case gives one row more slots than K5 sums in one
    chunk, so the card's split and fold have a CPU counterpart here."""
    ids, mask, K, num_rows = _case("one row past the chunk",
                                   np.random.default_rng(0))
    counts = np.bincount(ids[(ids >= 0) & mask], minlength=num_rows)
    assert counts.max() > 2 * CHUNK
    ptr, _ = segment.sorted_segments(torch.from_numpy(ids), num_rows, K,
                                     torch.from_numpy(mask))
    assert torch.equal(ptr.diff().long(), torch.from_numpy(counts))
