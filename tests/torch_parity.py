"""Helpers for the parity tests between fgnn_tpu (JAX) and fgnn_tpu_torch.

Values cross between the frameworks as NumPy arrays. bf16 goes through
float32, which holds every bf16 value exactly. Configurations and datasets
cross through :func:`port_cfg` and :func:`port_ds`: the port has its own
``RunConfig``, enums and ``Dataset``.
"""
import dataclasses
import enum

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fgnn_tpu_torch.config import RunConfig as TRunConfig
from fgnn_tpu_torch.data.schema import Dataset as TDataset
from fgnn_tpu_torch.ops import sampling as tsampling


def port_cfg(cfg):
    """The port's RunConfig for a reference RunConfig, through
    ``from_dict`` with the enums given by value."""
    return TRunConfig.from_dict({
        f.name: (v.value if isinstance(v, enum.Enum) else v)
        for f in dataclasses.fields(cfg)
        for v in [getattr(cfg, f.name)]})


def port_ds(ds):
    """The port's Dataset for a reference Dataset, field by field, over the
    same arrays."""
    return TDataset(**{f.name: getattr(ds, f.name)
                       for f in dataclasses.fields(ds)})


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


GUMBEL_MAX_DEG = 128


def jax_hop_uniforms(key, shape, sample_type=None):
    """The draws of the reference's ``sample_layer(key, ...)`` as the port's
    one ``[n, width]`` tensor of column blocks: the alias sampler's
    ``split(key)`` draws ``[u1 | u2]``; the hash-dedup sampler's
    ``k_g, k_s = split(key)`` Gumbel draw, then its alias draws from
    ``split(k_s)``, ``[gumbel | u1 | u2]``; one draw for the others.
    ``sample_type`` is either package's enum, or None."""
    st = getattr(sample_type, "value", sample_type)
    n, width = shape
    if st == "weighted_khop":
        k1, k2 = jax.random.split(key)
        f = width // 2
        return jnp.concatenate([jax.random.uniform(k1, (n, f)),
                                jax.random.uniform(k2, (n, f))], axis=1)
    if st == "weighted_khop_hash_dedup":
        k_g, k_s = jax.random.split(key)
        return jnp.concatenate(
            [jax.random.uniform(k_g, (n, GUMBEL_MAX_DEG)),
             jax_hop_uniforms(k_s, (n, width - GUMBEL_MAX_DEG),
                              "weighted_khop")], axis=1)
    return jax.random.uniform(key, shape)


def jax_uniforms(key, shapes, sample_type=None):
    """The reference's per-hop draws: hop h samples with fold_in(key, h)
    (:func:`jax_hop_uniforms`)."""
    return [to_torch(jax_hop_uniforms(jax.random.fold_in(key, hop), s,
                                      sample_type))
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


class ReferenceDraws:
    """A port engine's ``rand_fn(epoch, step)`` that draws what the
    reference draws for that batch: its key is ``fold_in(key(seed), epoch *
    stride + step)``, with ``stride`` the reference's steps per epoch
    (arch5, set by :meth:`bind`) or 100003 (arch6), and each hop's uniforms
    come from it as in :func:`jax_uniforms` (:func:`jax_walk_uniforms` for
    the random walk). Bind it to the engine once that exists: the engine's
    plan fixes the shapes."""

    def __init__(self, seed, sample_type, stride=None):
        self.seed = seed
        self.sample_type = sample_type
        self.stride = stride
        self.shapes = None

    def bind(self, eng, dedup_last_hop):
        self.shapes = eng.uniform_shapes(dedup_last_hop)
        if self.stride is None:
            self.stride = eng.num_step
        return eng

    def uniforms(self, key):
        if getattr(self.sample_type, "value", None) == "random_walk":
            return jax_walk_uniforms(key, self.shapes)
        return jax_uniforms(key, self.shapes, self.sample_type)

    def __call__(self, epoch, step):
        return self.uniforms(jax.random.fold_in(jax.random.key(self.seed),
                                                epoch * self.stride + step))


def reference_eval_draws(eng, cfg):
    """``rand(step)`` for a port engine's ``evaluate``: the reference's
    evaluation key ``fold_in(key(seed + 12345), step)``, dedup shapes."""
    draws = ReferenceDraws(cfg.seed + 12345, cfg.sample_type, stride=0)
    draws.bind(eng, True)
    return lambda step: draws(0, step)


def params_close(jparams, model, tol):
    """The largest |difference| between the reference's flax parameters and
    the port model's; asserts it is within ``tol``."""
    from fgnn_tpu_torch.models.convert import params_from_flax

    ref = params_from_flax(jparams)
    port = model.state_dict()
    assert set(ref) == set(port)
    err = max(float((ref[k] - port[k].detach().cpu()).abs().max())
              for k in ref)
    assert err < tol, err
    return err
