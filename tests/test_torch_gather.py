"""Port's row gather and extraction against the JAX reference, on CPU.

On CPU tensors the port's ``gather_rows`` runs its plain version; these
tests hold it bit for bit against ``device_gather`` (the semantics both
Pallas kernels declare) and the gradient against ``jax.vjp``. The Pallas
kernels themselves, in TPU interpret mode, are in
test_torch_gather_pallas.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgnn_tpu.ops import extract as jextract
from fgnn_tpu_torch.ops import cuda_lib
from fgnn_tpu_torch.ops import extract as textract
from fgnn_tpu_torch.ops.gather import (GatherRows, gather_rows,
                                       gather_rows_reference)
from torch_parity import to_numpy, to_torch

torch.set_num_threads(2)

DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def make_table(rng, n, d, dtype):
    return jnp.asarray(rng.standard_normal((n, d)).astype(np.float32)).astype(
        DTYPES[dtype])


def make_ids(rng, n, m):
    """-1 padding (~30%) and repeated ids (drawn from half the rows)."""
    ids = rng.integers(0, max(n // 2, 1), m).astype(np.int32)
    ids[rng.random(m) < 0.3] = -1
    return ids


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", [16, 32, 128, 256])
def test_gather_rows_matches_device_gather(dtype, d):
    rng = np.random.default_rng(d)
    table = make_table(rng, 300, d, dtype)
    ids = make_ids(rng, 300, 1000)
    ref = np.asarray(jextract.device_gather(table, jnp.asarray(ids)))
    out = gather_rows(to_torch(table), torch.from_numpy(ids))
    assert out.dtype == to_torch(table).dtype
    # exact: a gather copies bits
    np.testing.assert_array_equal(to_numpy(out), ref.astype(np.float32))
    out2 = textract.device_gather(to_torch(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(to_numpy(out2), ref.astype(np.float32))


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal((50, 8)).astype(np.float32))
    ids = torch.from_numpy(make_ids(rng, 50, 77))
    before = dict(cuda_lib.launches)
    assert torch.equal(gather_rows(table, ids),
                       gather_rows_reference(table, ids))
    assert cuda_lib.launches == before
    empty = gather_rows(table, torch.zeros(0, dtype=torch.int32))
    assert empty.shape == (0, 8)


def test_non_cpu_tensors_never_fall_back():
    """Off the CPU the wrapper launches the kernel or raises: here a tensor
    on the meta device is refused, not gathered by the plain version."""
    table = torch.empty((10, 4), device="meta")
    ids = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        gather_rows(table, ids)
    with pytest.raises(ValueError, match="CUDA"):
        gather_rows(torch.zeros(10, 4), ids)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gather_rows_backward_matches_jax_vjp(dtype):
    """Integer cotangents keep every sum exact in f32 and bf16, so the
    scatter-add order cannot matter and the gradients agree exactly."""
    rng = np.random.default_rng(1)
    table = make_table(rng, 60, 16, dtype)
    ids = make_ids(rng, 60, 250)
    cot = jnp.asarray(rng.integers(-3, 4, (250, 16)).astype(np.float32)).astype(
        DTYPES[dtype])
    _, vjp = jax.vjp(lambda t: jextract.device_gather(t, jnp.asarray(ids)),
                     table)
    (ref,) = vjp(cot)
    tt = to_torch(table).requires_grad_(True)
    GatherRows.apply(tt, torch.from_numpy(ids)).backward(to_torch(cot))
    assert tt.grad.dtype == tt.dtype
    np.testing.assert_array_equal(to_numpy(tt.grad),
                                  np.asarray(ref).astype(np.float32))


def test_mock_gather_matches():
    rng = np.random.default_rng(2)
    table = make_table(rng, 37, 8, "float32")
    ids = rng.integers(-1, 500, 400).astype(np.int32)   # modulo the table
    ref = np.asarray(jextract.mock_gather(table, jnp.asarray(ids)))
    out = textract.mock_gather(to_torch(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(to_numpy(out), ref)


def test_label_gather_matches():
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 9, 100).astype(np.int32)
    ids = make_ids(rng, 100, 300)
    ref = np.asarray(jextract.label_gather(jnp.asarray(labels),
                                           jnp.asarray(ids)))
    out = textract.label_gather(torch.from_numpy(labels), torch.from_numpy(ids))
    np.testing.assert_array_equal(out.numpy(), ref)
