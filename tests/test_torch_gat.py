"""GAT: the edge softmax, ``GATConv``, the model and the engine's GAT path,
each against the JAX package with the same inputs (batches sampled by the
reference or with its own uniforms injected into the port, flax parameters
carried across by ``params_from_flax``).

The reference trains GAT with attention dropout 0.6 and the two
frameworks' generators cannot draw the same masks, so the model and engine
comparisons run in eval mode (no dropout), forward and backward.

Tolerances: the edge softmax 1e-6 and its gradient 1e-5 (float32 sums in
another order); GATConv and GAT 1e-4 in float32 (the NumPy golden's own
tolerance), 3e-2 in bf16 (bf16 keeps ~3 decimal digits and the frameworks
round at other places); evaluation within one test row.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgnn_tpu.config import RunConfig, SampleType
from fgnn_tpu.data import make_synthetic_dataset
from fgnn_tpu.models import aggregate as jagg
from fgnn_tpu.models.gnn import GAT as JGAT
from fgnn_tpu.models.gnn import GATConv as JGATConv
from fgnn_tpu.train import loop as jloop
from fgnn_tpu_torch.models import aggregate as tagg
from fgnn_tpu_torch.models.convert import params_from_flax
from fgnn_tpu_torch.models.gnn import GAT, GATConv
from fgnn_tpu_torch.train import loop as tloop
from test_model_golden import golden_gatconv, make_block
from test_torch_engine import engines, evaluate_matches_reference, jax_draws
from test_torch_model import generic_block, sampled  # noqa: F401 (fixture)
from test_torch_pinsage import flax_init
from torch_parity import batch_to_torch, block_to_torch, to_numpy, to_torch

torch.set_num_threads(2)
IN, HID, CLS, HEADS = 16, 8, 5, 3


def block_for(form, sampled, rng):
    """(block, src_cap, dst_cap): the tiered input block of the sampled
    batch (src space = frontier + slots), its regular hop-0 block, or an
    irregular block (the generic scatter form)."""
    batch, _, _, dst_caps = sampled
    if form == "tiered":
        return batch.blocks[0], batch.input_nodes.shape[0], dst_caps[0]
    if form == "regular":
        return batch.blocks[1], dst_caps[0], dst_caps[1]
    return generic_block(rng, 40, 12), 40, 12


@pytest.mark.parametrize("form", ["regular", "tiered", "generic"])
def test_segment_softmax_matches(sampled, form):
    """Values and the gradient of sum(alpha * r) with respect to the
    scores; padded edges are 0 in both."""
    rng = np.random.default_rng(4)
    jb, _, dst_cap = block_for(form, sampled, rng)
    E = jb.mask.shape[0]
    s = (3 * rng.standard_normal((E, HEADS))).astype(np.float32)
    r = rng.standard_normal((E, HEADS)).astype(np.float32)
    ja, jg = jax.jit(lambda x: (
        jagg.segment_softmax(x, jb, dst_cap),
        jax.grad(lambda y: jnp.sum(jagg.segment_softmax(y, jb, dst_cap) * r))(x),
    ))(jnp.asarray(s))
    x = torch.from_numpy(s).requires_grad_()
    ta = tagg.segment_softmax(x, block_to_torch(jb), dst_cap)
    (ta * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(to_numpy(ta), np.asarray(ja), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)
    m = np.asarray(jb.mask)
    assert (to_numpy(ta)[~m] == 0).all()


@pytest.mark.parametrize("form", ["regular", "tiered", "generic"])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_gatconv_forward_and_grads(sampled, form, dtype):
    """Against flax through params_from_flax: the output, and the
    gradients of sum(out * r) with respect to every parameter and the
    input. el/er and the messages are float32 in both, so the output is
    float32 even in bf16."""
    rng = np.random.default_rng(5)
    jb, src_cap, dst_cap = block_for(form, sampled, rng)
    h = rng.standard_normal((src_cap, IN)).astype(np.float32)
    r = rng.standard_normal((dst_cap, HEADS, 4)).astype(np.float32)
    jdt = None if dtype is None else jnp.bfloat16
    jm = JGATConv(out_dim=4, num_heads=HEADS, activation=jax.nn.elu, dtype=jdt)
    params = flax_init(jm, 1, jb, jnp.asarray(h), dst_cap)

    def jloss(p, x):
        if jdt is not None:
            x = x.astype(jdt)
        out = jm.apply({"params": p}, jb, x, dst_cap, deterministic=True)
        return jnp.sum(out * r), out

    (_, jout), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(h))
    tm = GATConv(IN, 4, HEADS, activation=torch.nn.functional.elu, dtype=dtype)
    tm.load_state_dict(params_from_flax(params))
    tm.eval()
    x = torch.from_numpy(h).requires_grad_()
    tout = tm(block_to_torch(jb), x if dtype is None else x.to(dtype), dst_cap)
    assert tout.dtype == torch.float32 and jout.dtype == jnp.float32
    (tout * torch.from_numpy(r)).sum().backward()
    tol = 1e-4 if dtype is None else 3e-2
    np.testing.assert_allclose(to_numpy(tout), np.asarray(jout), rtol=tol,
                               atol=tol)
    want = params_from_flax(jg)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=tol, atol=tol, err_msg=name)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgx), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("regular", [True, False])
def test_gatconv_matches_dgl_golden(regular):
    """The port's GATConv against test_model_golden.py's independent NumPy
    DGL golden, at that test's tolerance (1e-4)."""
    rng = np.random.default_rng(3)
    src_cap, dst_cap = 29, 9
    block = make_block(rng, src_cap, dst_cap, regular=regular)
    h = rng.standard_normal((src_cap, 8)).astype(np.float32)
    conv = GATConv(8, 4, 3)
    conv.reset_parameters(torch.Generator().manual_seed(4))
    conv.eval()
    out = conv(block_to_torch(block), torch.from_numpy(h), dst_cap)
    gold = golden_gatconv(block, h, dst_cap,
                          conv.fc.weight.detach().numpy().T,
                          conv.attn_l.detach().numpy(),
                          conv.attn_r.detach().numpy())
    np.testing.assert_allclose(out.detach().numpy(), gold, rtol=1e-4,
                               atol=1e-4)


def flax_gat(sampled, dtype=None):
    batch, feats, _, dst_caps = sampled
    jm = JGAT(IN, HID, CLS, 2, dropout=0.5, dtype=dtype)
    return jm, flax_init(jm, 2, batch, jnp.asarray(feats), dst_caps)


def test_params_from_flax_places_gat_params(sampled):
    """Dense kernels transposed; attn_l / attn_r carried as they are."""
    _, params = flax_gat(sampled)
    sd = params_from_flax(params)
    assert set(sd) == set(GAT(IN, HID, CLS, 2).state_dict())
    for i in (0, 1):
        p = params[f"GATConv_{i}"]
        np.testing.assert_array_equal(sd[f"layers.{i}.fc.weight"].numpy(),
                                      np.asarray(p["fc"]["kernel"]).T)
        for a in ("attn_l", "attn_r"):
            np.testing.assert_array_equal(sd[f"layers.{i}.{a}"].numpy(),
                                          np.asarray(p[a]))
    assert sd["layers.0.attn_l"].shape == (1, 8, HID)
    assert sd["layers.1.fc.weight"].shape == (CLS, HID * 8)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_gat_eval_logits_and_grads(sampled, dtype):
    """Two layers over the tiered input block and the regular hop-0 block,
    8 heads then 1 averaged: eval-mode logits, and the gradients of the
    masked loss (float32 only)."""
    batch, feats, labels, dst_caps = sampled
    jm, params = flax_gat(sampled, dtype and jnp.bfloat16)

    def jloss(p):
        logits = jm.apply({"params": p}, batch, jnp.asarray(feats), dst_caps,
                          deterministic=True)
        return jloop.masked_cross_entropy(
            logits[:128], jnp.asarray(labels))[0], logits

    (jl, jlogits), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    tm = GAT(IN, HID, CLS, 2, dropout=0.5,
             dtype=dtype and torch.bfloat16)
    tm.load_state_dict(params_from_flax(params))
    tm.eval()
    tlogits = tm(batch_to_torch(batch), torch.from_numpy(feats), dst_caps)
    assert tlogits.dtype == torch.float32
    tol = 1e-4 if dtype is None else 3e-2
    np.testing.assert_allclose(to_numpy(tlogits), np.asarray(jlogits),
                               rtol=tol, atol=tol)
    if dtype is not None:
        return
    tl, _ = tloop.masked_cross_entropy(tlogits[:128], torch.from_numpy(labels))
    tl.backward()
    assert abs(tl.item() - float(jl)) < 1e-5
    want = params_from_flax(jg)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_gat_dropout_on_every_layer_input(sampled, monkeypatch):
    """Training mode drops out every layer's input, the first included,
    and each layer's attention; eval mode drops nothing."""
    from fgnn_tpu_torch.models import gnn as tgnn

    batch, feats, _, dst_caps = sampled
    shapes = []
    real = tgnn.dropout

    def spy(h, p, generator):
        shapes.append((tuple(h.shape), p))
        return real(h, p, generator)

    monkeypatch.setattr(tgnn, "dropout", spy)
    tm = GAT(IN, HID, CLS, 2, dropout=0.5)
    tb, x = batch_to_torch(batch), torch.from_numpy(feats)
    tm(tb, x, dst_caps, generator=torch.Generator().manual_seed(0))
    E0, E1 = (b.mask.shape[0] for b in batch.blocks)
    assert shapes == [((feats.shape[0], IN), 0.5), ((E0, 8), 0.6),
                      ((dst_caps[0], 8 * HID), 0.5), ((E1, 1), 0.6)]
    shapes.clear()
    tm.eval()
    tm(tb, x, dst_caps)
    assert shapes == []


# --- the engine's GAT path -----------------------------------------------

CFG = RunConfig(model="gat", fanout=(10, 3), batch_size=128, num_hidden=8,
                sample_type=SampleType.KHOP2, dropout=0.5, lr=0.003,
                compute_dtype="float32")


@pytest.fixture(scope="module")
def ds():
    return make_synthetic_dataset(num_node=2000, avg_degree=8, feat_dim=32,
                                  num_class=8, train_frac=0.5, seed=42)


def test_gat_engine_eval_logits_match_reference(ds):
    """The training layout (tiered no-dedup last hop) from the reference's
    uniforms: equal batches' eval-mode logits within 1e-4."""
    jeng, teng = engines(ds, CFG)
    seeds_all, nums_all = jeng.shuffler.epoch_arrays(0)
    key = jax.random.key(3)
    seeds, n = seeds_all[0], int(nums_all[0])
    jbatch = jeng.sample_jit(key, jnp.asarray(seeds), jnp.int32(n), False)
    tbatch = teng.sample(torch.from_numpy(seeds), n,
                         jax_draws(CFG)(key, teng.uniform_shapes(False)),
                         teng.dedup_last_hop)
    assert tbatch.blocks[0].tier_split is not None
    jfeats = jnp.take(jeng.feat_dev, jnp.maximum(jbatch.input_nodes, 0), axis=0)
    jfeats = jnp.where(jbatch.input_nodes[:, None] >= 0, jfeats, 0)
    jlogits = jax.jit(lambda p, b, f: jeng.model.apply(
        {"params": p}, b, f, jeng.dst_caps, deterministic=True))(
            jeng.state.params, jbatch, jfeats)
    teng.model.eval()
    tlogits = teng.model(tbatch, teng.feat_gather(teng.feat_dev,
                                                  tbatch.input_nodes),
                         teng.dst_caps)
    np.testing.assert_allclose(to_numpy(tlogits), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)


def test_gat_evaluate_matches_reference(ds):
    evaluate_matches_reference(ds, CFG)
