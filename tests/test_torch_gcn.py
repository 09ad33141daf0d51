"""GCN and what it reads from the sampler: the dedup sort's counts, the
blocks' ``src_out_deg``, ``out_degrees``, ``GraphConv`` and the 3-layer
``GCN``, each against the JAX package with the same inputs (the reference's
own uniforms injected into the port's sampler, flax parameters carried
across by ``params_from_flax``).

Tolerances: counts, blocks and degrees exact; GraphConv against the NumPy
DGL golden 1e-4 (that golden test's own); f32 logits and loss 1e-5,
gradients 1e-5 absolute plus 1e-4 relative (scatter-adds sum in another
order than XLA's); bf16 logits 3e-2 (bf16 keeps ~3 decimal digits and the
frameworks round at other places).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgnn_tpu.config import SampleType
from fgnn_tpu.data import make_synthetic_dataset
from fgnn_tpu.models import aggregate as jagg
from fgnn_tpu.models.gnn import GCN as JGCN
from fgnn_tpu.models.gnn import GraphConv as JGraphConv
from fgnn_tpu.ops import hashtable as jhash
from fgnn_tpu.ops import sampling as jsamp
from fgnn_tpu.train import loop as jloop
from fgnn_tpu_torch.models import aggregate as tagg
from fgnn_tpu_torch.models.convert import params_from_flax
from fgnn_tpu_torch.models.gnn import GCN, GraphConv, build_model
from fgnn_tpu_torch.ops import hashtable as thash
from fgnn_tpu_torch.ops import sampling as tsamp
from fgnn_tpu_torch.train import loop as tloop
from test_model_golden import golden_graphconv, make_block
from test_torch_sampling import _remap_cases, plan_for, seeds_for
from torch_parity import (assert_batches_equal, batch_to_torch, block_to_torch,
                          jax_uniforms, to_numpy, to_torch)

torch.set_num_threads(2)
KHOP2 = SampleType.KHOP2
IN, HID, CLS = 16, 32, 5
GCN_FANOUT = (5, 10, 15)      # config order, as exp/table1/run.py


@pytest.fixture(scope="module")
def ds():
    return make_synthetic_dataset(num_node=5000, avg_degree=12, feat_dim=IN,
                                  num_class=CLS, seed=11)


@pytest.fixture(scope="module")
def graphs(ds):
    indptr = np.asarray(ds.indptr)
    indices = np.asarray(ds.indices)
    jg = jsamp.CSRGraph(indptr=jnp.asarray(indptr.astype(np.int32)),
                        indices=jnp.asarray(indices))
    tg = tsamp.CSRGraph(indptr=torch.from_numpy(indptr.astype(np.int64)),
                        indices=torch.from_numpy(indices.astype(np.int32)))
    return jg, tg


def jax_sample(jg, plan, seeds, dedup, key):
    return jax.jit(lambda k: jsamp.multi_layer_sample(
        k, jg, jnp.asarray(seeds), jnp.int32(plan.batch_size), plan, KHOP2,
        dedup_last_hop=dedup, with_out_degrees=True))(key)


# --- the dedup sort's counts -------------------------------------------

def _count_cases():
    """tests/test_fused_remap.py's cases, then a duplicate seed (its group
    counts it, its own slot gets 0) and a cap past the stream's length."""
    return _remap_cases() + [
        (np.array([3, 5, 3, -1], np.int32), 3,
         np.array([3, 3, 5, 7, -1, 7, 9], np.int32), 8),
        (np.array([4, -1], np.int32), 1, np.array([4, 6, -1], np.int32), 16),
    ]


@pytest.mark.parametrize("case", range(len(_count_cases())))
def test_unique_and_remap_with_counts_matches(case):
    seeds, n, nbrs, cap = _count_cases()[case]
    jout = jhash.unique_and_remap(jnp.asarray(seeds), jnp.int32(n),
                                  jnp.asarray(nbrs), cap, with_counts=True)
    tout = thash.unique_and_remap(torch.from_numpy(seeds),
                                  torch.tensor(n, dtype=torch.int32),
                                  torch.from_numpy(nbrs), cap, with_counts=True)
    assert len(tout) == 5 and tout[4].dtype == torch.int32
    for name, jv, tv in zip(("unique", "num", "locals", "ovf", "counts"),
                            jout, tout):
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy(), err_msg=name)


# --- src_out_deg in the sampler's three branches ----------------------

@pytest.mark.parametrize("mode", ["tiered", "flat no-dedup", "dedup"])
def test_src_out_deg_matches_in_every_branch(ds, graphs, mode):
    """The tiered and flat no-dedup last hops (one per valid slot) and the
    dedup hops (the sort's counts), on GCN's 3-layer fanout for dedup."""
    jg, tg = graphs
    dedup = mode == "dedup"
    plan = plan_for(ds, batch_size=128,
                    fanouts=GCN_FANOUT if dedup else (25, 10),
                    tiers=mode == "tiered")
    assert (plan.tier_layout is not None) == (mode == "tiered")
    seeds = seeds_for(ds, plan)
    key = jax.random.key(21)
    jbatch = jax_sample(jg, plan, seeds, dedup, key)
    tbatch = tsamp.multi_layer_sample(
        tg, torch.from_numpy(seeds), plan.batch_size, plan, KHOP2,
        dedup_last_hop=dedup, with_out_degrees=True,
        rand=jax_uniforms(key, tsamp.uniform_shapes(plan, KHOP2, dedup)))
    assert all(b.src_out_deg is not None for b in tbatch.blocks)
    assert_batches_equal(jbatch, tbatch)


def test_tiered_last_hop_out_degrees_match(ds, graphs):
    jg, tg = graphs
    plan = plan_for(ds)
    V = plan.num_input_cap[-1]
    rng = np.random.default_rng(2)
    cur = rng.integers(0, ds.num_node, V).astype(np.int32)
    cur[rng.random(V) < 0.1] = -1
    num_cur = int((cur >= 0).sum())
    key = jax.random.key(4)
    jb, _, _, _ = jsamp._tiered_last_hop(
        key, jg, jnp.asarray(cur), jnp.int32(num_cur), plan.tier_layout, True)
    tb, _, _, _ = tsamp._tiered_last_hop(
        tg, torch.from_numpy(cur), torch.tensor(num_cur, dtype=torch.int32),
        plan.tier_layout, to_torch(jax.random.uniform(key, plan.tier_layout[0])),
        with_out_degrees=True)
    np.testing.assert_array_equal(np.asarray(jb.src_out_deg),
                                  tb.src_out_deg.numpy())


# --- out_degrees ------------------------------------------------------------

def test_out_degrees_from_src_out_deg(ds, graphs):
    """Read from the sampler's counts; equal to the reference and to the
    masked scatter over the same block (no clipping here)."""
    jg, tg = graphs
    plan = plan_for(ds, batch_size=128, fanouts=GCN_FANOUT, tiers=False)
    key = jax.random.key(8)
    seeds = seeds_for(ds, plan, seed=1)
    jbatch = jax_sample(jg, plan, seeds, True, key)
    assert not bool(jbatch.overflowed)
    dst_caps = tuple(reversed(plan.num_input_cap))
    src_caps = (jbatch.input_nodes.shape[0],) + dst_caps[:-1]
    for jb, src_cap in zip(jbatch.blocks, src_caps):
        tb = block_to_torch(jb)
        got = tagg.out_degrees(tb, src_cap)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jagg.out_degrees(jb, src_cap)))
        tb.src_out_deg = None
        np.testing.assert_array_equal(got.numpy(),
                                      tagg.out_degrees(tb, src_cap).numpy())


@pytest.mark.parametrize("regular", [True, False])
def test_out_degrees_scatter_matches(regular):
    rng = np.random.default_rng(5)
    jb = make_block(rng, 40, 12, regular=regular)
    np.testing.assert_array_equal(
        tagg.out_degrees(block_to_torch(jb), 40).numpy(),
        np.asarray(jagg.out_degrees(jb, 40)))


# --- GraphConv and GCN -----------------------------------------------------

@pytest.mark.parametrize("regular", [True, False])
def test_graphconv_matches_flax_and_dgl_golden(regular):
    """Parameters from a flax GraphConv through params_from_flax; the
    output against test_model_golden.py's NumPy DGL golden (1e-4, that
    test's tolerance) and against flax (1e-5)."""
    rng = np.random.default_rng(0)
    src_cap, dst_cap = 40, 12
    block = make_block(rng, src_cap, dst_cap, regular=regular)
    h = rng.standard_normal((src_cap, 8)).astype(np.float32)
    jm = JGraphConv(out_dim=6)
    params = jm.init(jax.random.key(1), block, jnp.asarray(h), dst_cap)
    conv = GraphConv(8, 6)
    conv.load_state_dict(params_from_flax(params["params"]))
    out = conv(block_to_torch(block), torch.from_numpy(h), dst_cap)
    gold = golden_graphconv(block, h, dst_cap,
                            conv.weight.weight.detach().numpy().T,
                            conv.bias.detach().numpy())
    np.testing.assert_allclose(out.detach().numpy(), gold, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jm.apply(params, block, jnp.asarray(h), dst_cap)),
        rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def gcn_sampled(ds, graphs):
    """A JAX-sampled 3-layer dedup batch with src_out_deg, its features,
    labels (some -1) and dst caps."""
    jg, _ = graphs
    plan = plan_for(ds, batch_size=128, fanouts=GCN_FANOUT, tiers=False)
    seeds = seeds_for(ds, plan, seed=2)
    batch = jax_sample(jg, plan, seeds, True, jax.random.key(3))
    ids = np.asarray(batch.input_nodes)
    feats = np.asarray(ds.feat)[np.maximum(ids, 0)]
    feats[ids < 0] = 0
    labels = np.asarray(ds.label)[seeds[:128]].astype(np.int32)
    labels[-5:] = -1
    return batch, feats, labels, tuple(reversed(plan.num_input_cap))


def flax_gcn(batch, feats, dst_caps, dtype=None):
    m = JGCN(IN, HID, CLS, 3, dropout=0.0, dtype=dtype)
    params = m.init(jax.random.key(6), batch, jnp.asarray(feats), dst_caps,
                    deterministic=True)["params"]
    return m, params


def test_gcn_params_from_flax_layout(gcn_sampled):
    batch, feats, _, dst_caps = gcn_sampled
    _, params = flax_gcn(batch, feats, dst_caps)
    sd = params_from_flax(params)
    assert set(sd) == set(GCN(IN, HID, CLS, 3).state_dict())
    np.testing.assert_array_equal(
        sd["layers.2.weight.weight"].numpy(),
        np.asarray(params["GraphConv_2"]["weight"]["kernel"]).T)
    assert isinstance(build_model("gcn", IN, HID, CLS, 3), GCN)


def test_gcn_f32_logits_loss_and_grads(gcn_sampled):
    batch, feats, labels, dst_caps = gcn_sampled
    jm, params = flax_gcn(batch, feats, dst_caps)
    jlogits = jm.apply({"params": params}, batch, jnp.asarray(feats),
                       dst_caps, deterministic=True)

    def loss_fn(p):
        lg = jm.apply({"params": p}, batch, jnp.asarray(feats), dst_caps,
                      deterministic=True)
        return jloop.masked_cross_entropy(lg[:128], jnp.asarray(labels))[0]

    jl, jgrads = jax.value_and_grad(loss_fn)(params)
    tm = GCN(IN, HID, CLS, 3, dropout=0.0)
    tm.load_state_dict(params_from_flax(params))
    tlogits = tm(batch_to_torch(batch), torch.from_numpy(feats), dst_caps)
    np.testing.assert_allclose(to_numpy(tlogits), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    tl, _ = tloop.masked_cross_entropy(tlogits[:128], torch.from_numpy(labels))
    tl.backward()
    assert abs(tl.item() - float(jl)) < 1e-5
    want = params_from_flax(jgrads)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_gcn_bf16_promotes_like_the_reference(gcn_sampled):
    """bf16 products, float32 aggregation and output (``h * rsqrt(deg)``
    promotes, as in jnp); logits within 3e-2 of flax."""
    batch, feats, _, dst_caps = gcn_sampled
    jm, params = flax_gcn(batch, feats, dst_caps, dtype=jnp.bfloat16)
    jlogits = jm.apply({"params": params}, batch,
                       jnp.asarray(feats).astype(jnp.bfloat16), dst_caps,
                       deterministic=True)
    tm = GCN(IN, HID, CLS, 3, dropout=0.0, dtype=torch.bfloat16)
    tm.load_state_dict(params_from_flax(params))
    tlogits = tm(batch_to_torch(batch),
                 torch.from_numpy(feats).to(torch.bfloat16), dst_caps)
    assert jlogits.dtype == jnp.float32 and tlogits.dtype == torch.float32
    np.testing.assert_allclose(to_numpy(tlogits), np.asarray(jlogits),
                               rtol=3e-2, atol=3e-2)
