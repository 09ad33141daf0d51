"""The port's streaming pass against K3, the TPU's inline Pallas copy kernel
of ``tools/gather_campaign.py::stream_campaign``.

The kernel is rebuilt here with the campaign's body and BlockSpecs (that
tool is a script that imports the TPU setup at its top) and runs on the CPU
under ``force_tpu_interpret_mode``; the port's ``stream_add_one`` (its plain
version on CPU tensors) must equal it bit for bit: both add 1.0 in float32.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fgnn_tpu_torch.ops.stream import stream_add_one

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def k3(x, chunk):
    """tools/gather_campaign.py:121-137 at the array's own N."""
    N, D = x.shape

    def copy_kernel(x_ref, o_ref):
        o_ref[:, :] = x_ref[:, :] + 1.0

    return pl.pallas_call(
        copy_kernel,
        grid=(N // chunk,),
        in_specs=[pl.BlockSpec((chunk, D), lambda i: (i, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((chunk, D), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((N, D), x.dtype),
    )(x)


def test_port_matches_k3_interpreted():
    x = np.random.default_rng(0).standard_normal((4096, 128)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(k3(jnp.asarray(x), 512))
    out = stream_add_one(torch.from_numpy(x), 512)
    assert out.dtype == torch.float32 and out.shape == (4096, 128)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("chunk", [1, 7, 512, 2048, 8192])
@pytest.mark.parametrize("shape", [(3001, 128), (5000, 3), (1, 128)])
def test_every_chunk_gives_x_plus_one(shape, chunk):
    """The chunk sets nothing in the kernel's launch; the wrapper's contract
    is x + 1 for every chunk K3 was swept over and any N, D."""
    x = torch.from_numpy(
        np.random.default_rng(1).standard_normal(shape).astype(np.float32))
    out = stream_add_one(x, chunk)
    assert out.shape == shape and out.dtype == torch.float32
    assert torch.equal(out, x + 1.0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64, torch.int32])
def test_rejects_other_dtypes(dtype):
    with pytest.raises(TypeError, match="float32"):
        stream_add_one(torch.zeros((8, 4), dtype=dtype))


@pytest.mark.parametrize("x,chunk", [(torch.zeros(8), 4),
                                     (torch.zeros((8, 4)).t(), 4),
                                     (torch.zeros((8, 4)), 0)])
def test_rejects_bad_shapes_and_chunks(x, chunk):
    with pytest.raises(ValueError, match="stream_add_one"):
        stream_add_one(x, chunk)


def test_gather_campaign_imports_and_refuses_to_run_without_cuda():
    """The campaign imports with no card and no nvcc, and run as a module
    exits non-zero without a CUDA device, printing no measurement."""
    from fgnn_tpu_torch.tools import gather_campaign

    assert gather_campaign.PHASES == ("plain", "stream", "base", "kernel")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run(
        [sys.executable, "-m", "fgnn_tpu_torch.tools.gather_campaign", "stream"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert r.returncode != 0
    assert "ms" not in r.stdout and "no CPU mode" in r.stderr


def test_median_ms_times_back_to_back_calls_behind_a_spin(monkeypatch):
    """Each sample queues ``inner`` calls behind a spin on the card between
    its two events, so the host's launch path is not timed; samples are
    taken in turns and reported per call."""
    from fgnn_tpu_torch.tools import gather_campaign

    log = []

    class Event:
        def __init__(self, enable_timing):
            assert enable_timing

        def record(self):
            log.append("record")

        def synchronize(self):
            log.append("sync")

        def elapsed_time(self, end):
            return 30.0

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: log.append("spin"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    ms = gather_campaign.median_ms([lambda: log.append("f"),
                                    lambda: log.append("g")],
                                   reps=2, warm=1, inner=3)
    assert ms == [10.0, 10.0]
    sample = ["spin", "record"] + 3 * ["{}"] + ["record", "sync"]
    expect = ["f", "g"] + 2 * [s.format(fn) for fn in "fg" for s in sample]
    assert log == expect
