"""The regular-block aggregation and the gather's backward: K4
(``segment_sum_rows``), K5 (``scatter_add_rows``) and ``GatherSegmentSum``
through ``gather_segment_agg``, on CPU tensors, where every wrapper runs its
plain version.

* ``gather_segment_agg`` against ``segment_agg(gather_src(...))``, the code
  it took over: bit-equal in the forward and in the gradient of ``h``.
* One ``GraphConv`` and one ``SAGEConv`` layer against the flax layers of
  ``fgnn_tpu/models/gnn.py`` from the same numpy inputs and parameters:
  output and gradients of ``h`` and of every parameter. Tolerance, as
  ``max |port - ref| <= tol * max |ref|`` per array: float32 1e-5 (sums in
  another order than XLA's), bfloat16 2e-2 (bf16 keeps 8 bits, and the
  frameworks round at other places).
* The deterministic path's sort and segment pointers with K5's sum stage
  (``csr_sum_rows``) and its plain version, bit-equal to ``index_add_`` on
  integer-valued rows (every partial sum is exact, so the order cannot
  show).
* Off the CPU a wrapper launches its kernel or raises; CPU calls count no
  launch. Each bound C symbol takes as many ctypes arguments as its
  source declares.
"""
import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgnn_tpu.models.gnn import GraphConv as JGraphConv
from fgnn_tpu.models.gnn import SAGEConv as JSAGEConv
from fgnn_tpu.ops.sampling import Block as JBlock
from fgnn_tpu_torch.models import aggregate as tagg
from fgnn_tpu_torch.models.convert import params_from_flax
from fgnn_tpu_torch.models.gnn import GraphConv, SAGEConv
from fgnn_tpu_torch.ops import cuda_lib, gather, segment, stream
from fgnn_tpu_torch.ops.gather import GatherRows
from fgnn_tpu_torch.ops.sampling import Block
from torch_parity import block_to_torch, to_numpy

torch.set_num_threads(2)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDTYPES = {"float32": None, "bfloat16": jnp.bfloat16}


def regular_block(rng, src_cap, dst_cap, K, *, masked_sources=False):
    """A regular block as numpy arrays: slot ``d*K + k`` of dst ``d``;
    dsts 0 and 3 all padding; sources drawn from a quarter of the rows, so
    they repeat; padding slots hold -1, and with ``masked_sources`` some
    masked slots keep a valid source id (the mask alone must drop them)."""
    E = dst_cap * K
    mask = rng.random(E) < 0.7
    for d in (0, 3):
        mask[d * K:(d + 1) * K] = False
    src = rng.integers(0, max(src_cap // 4, 1), E).astype(np.int32)
    src_local = np.where(mask, src, -1).astype(np.int32)
    if masked_sources:
        keep = ~mask & (rng.random(E) < 0.5)
        src_local[keep] = src[keep]
    dst = np.repeat(np.arange(dst_cap, dtype=np.int32), K)
    return dict(src_local=src_local, dst_local=np.where(mask, dst, -1),
                mask=mask, num_src=src_cap, num_dst=dst_cap, K=K)


def torch_block(b, **kw):
    return Block(src_local=torch.from_numpy(b["src_local"]),
                 dst_local=torch.from_numpy(b["dst_local"]),
                 mask=torch.from_numpy(b["mask"]),
                 num_src=torch.tensor(b["num_src"], dtype=torch.int32),
                 num_dst=torch.tensor(b["num_dst"], dtype=torch.int32),
                 slots_per_dst=b["K"], **kw)


def jax_block(b):
    return JBlock(src_local=jnp.asarray(b["src_local"]),
                  dst_local=jnp.asarray(b["dst_local"]),
                  mask=jnp.asarray(b["mask"]),
                  num_src=jnp.int32(b["num_src"]),
                  num_dst=jnp.int32(b["num_dst"]),
                  slots_per_dst=b["K"])


def agg_and_grad(fn, h0, cot):
    h = h0.clone().requires_grad_(True)
    out = fn(h)
    out.backward(cot)
    return out.detach(), h.grad


# --- gather_segment_agg: bit-equal to the code it took over -------------------

@pytest.mark.parametrize("K", [5, 10, 15])
@pytest.mark.parametrize("D", [16, 172, 256])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_gather_segment_agg_plain_path_is_bit_equal(mode, dtype, D, K):
    rng = np.random.default_rng(K * 1000 + D)
    src_cap, dst_cap = 40, 12
    b = regular_block(rng, src_cap, dst_cap, K, masked_sources=D == 172)
    block = torch_block(b)
    h0 = torch.from_numpy(
        rng.standard_normal((src_cap, D)).astype(np.float32)).to(DTYPES[dtype])
    cot = torch.from_numpy(
        rng.standard_normal((dst_cap, D)).astype(np.float32)).to(DTYPES[dtype])
    out, grad = agg_and_grad(
        lambda h: tagg.gather_segment_agg(h, block, dst_cap, mode), h0, cot)
    ref, ref_grad = agg_and_grad(
        lambda h: tagg.segment_agg(tagg.gather_src(h, block), block, dst_cap,
                                   mode=mode), h0, cot)
    assert out.dtype == ref.dtype == DTYPES[dtype]
    assert torch.equal(out, ref)
    assert grad.dtype == ref_grad.dtype
    assert torch.equal(grad, ref_grad)


@pytest.mark.parametrize("layout", ["no-dedup slice", "not regular"])
def test_gather_segment_agg_other_layouts_take_segment_agg(layout):
    """A sliced (no-dedup) or irregular block goes through gather_src and
    segment_agg as before."""
    rng = np.random.default_rng(4)
    src_cap, dst_cap, K, D = 60, 6, 5, 8
    b = regular_block(rng, src_cap, dst_cap, K)
    if layout == "no-dedup slice":
        block = torch_block(b, src_slice_offset=dst_cap)
    else:
        block = torch_block(b)
        block.slots_per_dst = None
    h0 = torch.from_numpy(rng.standard_normal((src_cap, D)).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((dst_cap, D)).astype(np.float32))
    for mode in ("sum", "mean"):
        out, grad = agg_and_grad(
            lambda h: tagg.gather_segment_agg(h, block, dst_cap, mode), h0, cot)
        ref, ref_grad = agg_and_grad(
            lambda h: tagg.segment_agg(tagg.gather_src(h, block), block,
                                       dst_cap, mode=mode), h0, cot)
        assert torch.equal(out, ref) and torch.equal(grad, ref_grad)
    with pytest.raises(ValueError, match="mode"):
        tagg.gather_segment_agg(h0, block, dst_cap, "weighted_mean")


# --- one GraphConv and one SAGEConv layer against flax -------------------------

def assert_close(port, ref, tol, what):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(port - ref).max()
    assert err <= tol * scale, f"{what}: max |diff| {err} > {tol} x {scale}"


LAYERS = {
    # name: (flax layer, port layer, flax parameter path -> port name)
    "GraphConv": (lambda dt: JGraphConv(out_dim=6, dtype=dt),
                  lambda dt: GraphConv(8, 6, dtype=dt)),
    "SAGEConv": (lambda dt: JSAGEConv(out_dim=6, dtype=dt),
                 lambda dt: SAGEConv(8, 6, dtype=dt)),
}


@pytest.mark.parametrize("K", [5, 15])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_layer_matches_flax_with_gradients(layer, dtype, K):
    tol = 1e-5 if dtype == "float32" else 2e-2
    rng = np.random.default_rng(K)
    src_cap, dst_cap = 40, 12
    b = regular_block(rng, src_cap, dst_cap, K)
    h = rng.standard_normal((src_cap, 8)).astype(np.float32)
    cot = rng.standard_normal((dst_cap, 6)).astype(np.float32)
    make_j, make_t = LAYERS[layer]
    jm = make_j(JDTYPES[dtype])
    jb = jax_block(b)
    jh = jnp.asarray(h).astype(JDTYPES[dtype] or jnp.float32)
    params = jm.init(jax.random.key(1), jb, jh, dst_cap)["params"]

    def jloss(p, x):
        out = jm.apply({"params": p}, jb, x, dst_cap)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, jout), (jgp, jgh) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jh)

    conv = make_t(None if dtype == "float32" else torch.bfloat16)
    conv.load_state_dict(params_from_flax(params))
    th = torch.from_numpy(h).to(DTYPES[dtype]).requires_grad_(True)
    out = conv(torch_block(b), th, dst_cap)
    (out.float() * torch.from_numpy(cot)).sum().backward()

    assert_close(to_numpy(out), np.asarray(jout, np.float32), tol, "output")
    assert_close(to_numpy(th.grad), np.asarray(jgh, np.float32), tol, "grad h")
    jgrads = params_from_flax(jgp)
    for name, p in conv.named_parameters():
        assert_close(p.grad.numpy(), jgrads[name].numpy(), tol, f"grad {name}")


# --- the deterministic path ------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("K", [1, 5])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_sorted_segments_sum_equals_index_add(dtype, K, masked):
    """Integer-valued rows keep every float32 partial sum exact (and every
    total within bf16's 8 bits), so K5's sum stage over the sorted slots
    must equal index_add_ bit for bit."""
    rng = np.random.default_rng(K + 2 * masked)
    num_dst, num_rows, D = 50, 30, 12
    ids = rng.integers(0, num_rows // 3, num_dst * K).astype(np.int32)
    ids[rng.random(ids.shape[0]) < 0.2] = -1
    ids = torch.from_numpy(ids)
    mask = torch.from_numpy(rng.random(ids.shape[0]) < 0.8) if masked else None
    grad_out = torch.from_numpy(
        rng.integers(-4, 5, (num_dst, D)).astype(np.float32)).to(DTYPES[dtype])

    ptr, idx = segment.sorted_segments(ids, num_rows, K, mask)
    valid = ids >= 0
    if mask is not None:
        valid &= mask
    assert ptr.dtype == idx.dtype == torch.int32
    assert ptr.shape == (num_rows + 1,) and ptr[0] == 0
    assert int(ptr[-1]) == int(valid.sum())
    slots = torch.nonzero(valid)[:, 0]
    for r in range(num_rows):
        mine = slots[ids[slots] == r]
        # each row's slots in ascending order, as the grad_out rows they read
        assert torch.equal(idx[ptr[r]:ptr[r + 1]].long(), mine // K)

    out = segment.segment_sum_rows_by_ptr_reference(grad_out, ptr, idx)
    ref = segment.scatter_add_rows_reference(grad_out, ids, num_rows, K, mask)
    assert out.dtype == ref.dtype == DTYPES[dtype]
    assert torch.equal(out, ref)
    assert torch.equal(segment.csr_sum_rows(grad_out, ptr, idx), out)


def test_scatter_add_rows_under_deterministic_algorithms_on_cpu():
    """On CPU tensors the wrapper takes the plain version whether or not
    deterministic algorithms are on."""
    rng = np.random.default_rng(7)
    grad_out = torch.from_numpy(rng.standard_normal((20, 8)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-1, 9, 100).astype(np.int32))
    mask = torch.from_numpy(rng.random(100) < 0.7)
    ref = segment.scatter_add_rows_reference(grad_out, ids, 9, 5, mask)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        out = segment.scatter_add_rows(grad_out, ids, 9, 5, mask)
    finally:
        torch.use_deterministic_algorithms(was)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gather_rows_backward_is_the_scatter_add(dtype):
    """GatherRows' backward is scatter_add_rows with K = 1 and no mask; its
    plain version is the masked index_add_ it replaced."""
    rng = np.random.default_rng(3)
    table = torch.from_numpy(
        rng.standard_normal((30, 16)).astype(np.float32)).to(DTYPES[dtype])
    ids = torch.from_numpy(rng.integers(-1, 30, 90).astype(np.int32))
    cot = torch.from_numpy(
        rng.standard_normal((90, 16)).astype(np.float32)).to(DTYPES[dtype])
    t = table.clone().requires_grad_(True)
    GatherRows.apply(t, ids).backward(cot)
    valid = (ids >= 0).unsqueeze(1)
    want = torch.zeros((30, 16)).index_add_(
        0, ids.clamp(min=0).long(), cot.float().masked_fill(~valid, 0))
    assert t.grad.dtype == table.dtype
    assert torch.equal(t.grad, want.to(table.dtype))
    assert torch.equal(t.grad, segment.scatter_add_rows(cot, ids, 30))


# --- off the CPU: launch or raise; the launch counters ---------------------------

def test_non_cpu_tensors_never_fall_back():
    """A tensor on the meta device is refused, not summed by the plain
    version; a mix of devices too."""
    rows = torch.empty((12, 4), device="meta")
    mask = torch.zeros(12, dtype=torch.bool, device="meta")
    ids = torch.zeros(12, dtype=torch.int32, device="meta")
    ptr = torch.zeros(5, dtype=torch.int32, device="meta")
    before = dict(cuda_lib.launches)
    for call in (
        lambda: segment.segment_sum_rows(rows, mask, 4, 3),
        lambda: segment.segment_sum_rows(torch.zeros(12, 4), mask, 4, 3),
        lambda: segment.csr_sum_rows(rows, ptr, ids),
        lambda: segment.scatter_add_rows(rows, ids, 7),
        lambda: segment.scatter_add_rows(rows[:4], ids, 7, 3, mask),
        lambda: segment.scatter_add_rows(torch.zeros(4, 4), ids, 7, 3),
        lambda: segment.GatherSegmentSum.apply(rows, ids, mask, 4, 3),
    ):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert cuda_lib.launches == before


def test_cpu_layers_count_no_launch():
    """A GraphConv forward and backward on CPU tensors runs the plain
    versions: no kernel's count moves."""
    rng = np.random.default_rng(9)
    b = regular_block(rng, 40, 12, 5)
    conv = GraphConv(8, 6)
    h = torch.from_numpy(rng.standard_normal((40, 8)).astype(np.float32))
    before = dict(cuda_lib.launches)
    conv(torch_block(b), h.requires_grad_(True), 12).sum().backward()
    assert h.grad is not None
    assert cuda_lib.launches == before


def test_launch_counter_counts_one_a_launch_and_none_on_an_error():
    name = segment.SCATTER_KERNEL
    n = cuda_lib.launches.get(name, 0)
    try:
        segment._launched(name, 0)
        assert cuda_lib.launches[name] == n + 1
        with pytest.raises(RuntimeError, match="CUDA error 9"):
            segment._launched(name, 9)
        assert cuda_lib.launches[name] == n + 1
    finally:
        cuda_lib.launches[name] = n


@pytest.mark.parametrize("name", [segment.SEGMENT_KERNEL,
                                  segment.SCATTER_KERNEL])
def test_kernel_sources_are_in_the_package(name):
    """Each kernel's source is where cuda_lib builds it from, and exports
    the C symbols its wrapper binds."""
    src = os.path.join(cuda_lib.CSRC_DIR, f"{name}.cu")
    with open(src) as f:
        text = f.read()
    assert set(extern_params(text)) == set(BOUND[name][1])
    assert "fgnn_segment_sum_rows_by_ptr" not in text
    assert cuda_lib.library_path(name).startswith(cuda_lib.BUILD_DIR)


# kernel -> its module's binder and the C symbols it binds
BOUND = {
    gather.KERNEL: (gather._kernel, ("fgnn_gather_rows",)),
    stream.KERNEL: (stream._lib, ("fgnn_stream_add_one",
                                  "fgnn_stream_add_one_config")),
    segment.SEGMENT_KERNEL: (segment._segment_kernel,
                             ("fgnn_segment_sum_rows",)),
    segment.SCATTER_KERNEL: (segment._scatter_kernels,
                             ("fgnn_scatter_add_rows",
                              "fgnn_scatter_add_rows_by_ptr",
                              "fgnn_scatter_add_rows_workspace")),
}


def extern_params(text):
    """``{symbol: parameter count}`` of every ``extern "C"`` function of a
    source."""
    out = {}
    for m in re.finditer(r'extern "C" [\w]+ (fgnn_\w+)\(([^)]*)\)', text):
        params = m.group(2).strip()
        out[m.group(1)] = 0 if params in ("", "void") else params.count(",") + 1
    return out


class _FakeLib:
    """Stands in for a loaded library: each attribute a function object
    on which a binder sets ``argtypes`` and ``restype``."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return self.fns.setdefault(name, type("Fn", (), {})())


@pytest.mark.parametrize("name", [gather.KERNEL, stream.KERNEL,
                                  segment.SEGMENT_KERNEL,
                                  segment.SCATTER_KERNEL])
def test_bound_symbols_take_the_sources_parameter_count(name, monkeypatch):
    """Each C symbol a wrapper binds gets one ctypes argument type a
    parameter of its ``extern "C"`` declaration: a missing one would pass
    the arguments after it in the wrong registers."""
    with open(os.path.join(cuda_lib.CSRC_DIR, f"{name}.cu")) as f:
        params = extern_params(f.read())
    binder, symbols = BOUND[name]
    lib = _FakeLib()
    monkeypatch.setattr(cuda_lib, "load", lambda n: lib if n == name else None)
    binder.cache_clear()
    try:
        binder()
    finally:
        binder.cache_clear()
    assert set(lib.fns) == set(symbols)
    for sym, fn in lib.fns.items():
        assert len(fn.argtypes) == params[sym], sym
        assert all(isinstance(t, type) and issubclass(t, ctypes._SimpleCData)
                   for t in fn.argtypes), sym
