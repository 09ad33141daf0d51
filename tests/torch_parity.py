"""Helpers for the parity tests between fgnn_tpu (JAX) and fgnn_tpu_torch.

Values cross between the frameworks as NumPy arrays. bf16 goes through
float32, which holds every bf16 value exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from fgnn_tpu_torch.ops import sampling as tsampling


def to_torch(x):
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def to_numpy(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def block_to_torch(b):
    opt = lambda x: None if x is None else to_torch(x)
    return tsampling.Block(
        src_local=to_torch(b.src_local), dst_local=to_torch(b.dst_local),
        mask=to_torch(b.mask), num_src=to_torch(b.num_src),
        num_dst=to_torch(b.num_dst), weights=opt(b.weights),
        src_out_deg=opt(b.src_out_deg),
        slots_per_dst=b.slots_per_dst,
        src_slice_offset=b.src_slice_offset, tier_split=b.tier_split,
        dst_invperm=opt(b.dst_invperm),
    )


def batch_to_torch(batch):
    return tsampling.SampledBatch(
        blocks=tuple(block_to_torch(b) for b in batch.blocks),
        input_nodes=to_torch(batch.input_nodes),
        num_input=to_torch(batch.num_input),
        output_nodes=to_torch(batch.output_nodes),
        num_output=to_torch(batch.num_output),
        overflowed=to_torch(batch.overflowed),
    )


def jax_uniforms(key, shapes):
    """The reference's per-hop draws: uniform(fold_in(key, hop), shape)."""
    return [to_torch(jax.random.uniform(jax.random.fold_in(key, hop), s))
            for hop, s in enumerate(shapes)]


def jax_walk_draws(key, L, n, W):
    """The draws of the reference's ``random_walk_visits(key, ...)`` as one
    ``[L, 2, n, W]`` tensor: split(key, L) step keys, each split into the
    pick's and the death draw's key, then uniform(k, (n, W)) each."""
    return to_torch(jnp.stack([
        jnp.stack([jax.random.uniform(k, (n, W))
                   for k in jax.random.split(step)])
        for step in jax.random.split(key, L)]))


def jax_walk_uniforms(key, shapes):
    """The reference random walk's per-hop draws: hop h walks with
    fold_in(key, h) (``random_walk_topk``)."""
    return [jax_walk_draws(jax.random.fold_in(key, hop), L, n, W)
            for hop, (L, _, n, W) in enumerate(shapes)]


def assert_blocks_equal(jb, tb):
    for f in ("src_local", "dst_local", "mask", "num_src", "num_dst"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jb, f)), to_numpy(getattr(tb, f)), err_msg=f)
    assert jb.slots_per_dst == tb.slots_per_dst
    assert jb.src_slice_offset == tb.src_slice_offset
    assert jb.tier_split == tb.tier_split
    for f in ("dst_invperm", "src_out_deg", "weights"):
        jv, tv = getattr(jb, f), getattr(tb, f)
        assert (jv is None) == (tv is None), f
        if jv is not None:
            np.testing.assert_array_equal(np.asarray(jv), to_numpy(tv),
                                          err_msg=f)


def assert_batches_equal(jbatch, tbatch):
    assert len(jbatch.blocks) == len(tbatch.blocks)
    for jb, tb in zip(jbatch.blocks, tbatch.blocks):
        assert_blocks_equal(jb, tb)
    for f in ("input_nodes", "num_input", "output_nodes", "num_output",
              "overflowed"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jbatch, f)), to_numpy(getattr(tbatch, f)),
            err_msg=f)
