"""The port's row gather against the TPU's Pallas gathers themselves.

Both Pallas kernels run on the CPU under ``force_tpu_interpret_mode``; the
port's ``gather_rows`` (its plain version on CPU tensors) must equal them
bit for bit, which shows that both kernels' contracts (K1's block multiple
with or without ``skip_invalid``, K2's any-M padded wrapper) map onto the
one Hopper kernel's any-M contract.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fgnn_tpu.ops.pallas_gather import gather_rows_padded
from fgnn_tpu.ops.pallas_gather2 import gather_rows_v2
from fgnn_tpu_torch.ops.gather import gather_rows
from torch_parity import to_numpy, to_torch

torch.set_num_threads(2)

# (dtype, D) pairs: both dtypes and every width of the main path's tables;
# each interpret-mode call costs ~2 s, so the pairs split the matrix
CASES = [(jnp.float32, 16), (jnp.bfloat16, 32), (jnp.bfloat16, 128),
         (jnp.float32, 256)]


def inputs(seed, d, dtype, m, n=300):
    rng = np.random.default_rng(seed)
    table = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32)).astype(
        dtype)
    ids = rng.integers(0, n // 3, m).astype(np.int32)    # repeated ids
    ids[rng.random(m) < 0.3] = -1                         # padding
    return table, ids


@pytest.mark.parametrize("skip_invalid", [False, True])
@pytest.mark.parametrize("dtype,d", CASES)
def test_port_matches_gather_rows_v2(dtype, d, skip_invalid):
    table, ids = inputs(d, d, dtype, m=256)
    with pltpu.force_tpu_interpret_mode():
        ref = gather_rows_v2(table, jnp.asarray(ids), block_rows=128,
                             skip_invalid=skip_invalid)
    out = gather_rows(to_torch(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(to_numpy(out),
                                  np.asarray(ref).astype(np.float32))


@pytest.mark.parametrize("dtype,d", CASES)
def test_port_matches_gather_rows_padded(dtype, d):
    table, ids = inputs(d + 1, d, dtype, m=200)   # not a block multiple
    with pltpu.force_tpu_interpret_mode():
        ref = gather_rows_padded(table, jnp.asarray(ids))
    out = gather_rows(to_torch(table), torch.from_numpy(ids))
    assert out.shape == (200, d)
    np.testing.assert_array_equal(to_numpy(out),
                                  np.asarray(ref).astype(np.float32))
