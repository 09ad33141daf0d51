"""GraphSAGE, aggregation and the train step: the port against the flax /
optax reference, with the parameters carried across by
``params_from_flax`` and batches sampled by the JAX package."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fgnn_tpu.config import SampleType
from fgnn_tpu.data import make_synthetic_dataset
from fgnn_tpu.models import aggregate as jagg
from fgnn_tpu.models.gnn import GraphSAGE as JGraphSAGE
from fgnn_tpu.ops import sampling as jsamp
from fgnn_tpu.ops.padding import make_plan
from fgnn_tpu.ops.reference_impl import calibrate_caps
from fgnn_tpu.train import loop as jloop
from fgnn_tpu_torch.models import aggregate as tagg
from fgnn_tpu_torch.models.convert import params_from_flax
from fgnn_tpu_torch.models.gnn import GraphSAGE, SAGEConv, build_model
from fgnn_tpu_torch.ops import sampling as tsamp
from fgnn_tpu_torch.train import loop as tloop
from test_model_golden import golden_sageconv, make_block
from torch_parity import batch_to_torch, block_to_torch, to_numpy

torch.set_num_threads(2)
IN, HID, CLS = 16, 32, 5


@pytest.fixture(scope="module")
def sampled():
    """A JAX-sampled batch with a tiered input block and a regular hop-0
    block, its features, labels and plan."""
    ds = make_synthetic_dataset(num_node=3000, avg_degree=12, feat_dim=IN,
                                num_class=CLS, seed=3)
    caps, stats = calibrate_caps(
        np.asarray(ds.indptr), np.asarray(ds.indices),
        np.asarray(ds.train_set), 128, [5, 12], tier_candidates=(4, 6, 8))
    plan = make_plan(128, (12, 5), ds.num_node, unique_caps=caps,
                     tier_stats=stats)
    assert plan.tier_layout is not None
    g = jsamp.CSRGraph(indptr=jnp.asarray(np.asarray(ds.indptr, np.int32)),
                       indices=jnp.asarray(ds.indices))
    seeds = np.full(plan.num_input_cap[0], -1, np.int32)
    seeds[:128] = np.asarray(ds.train_set)[:128]
    batch = jsamp.multi_layer_sample(
        jax.random.key(0), g, jnp.asarray(seeds), jnp.int32(128), plan,
        SampleType.KHOP2, dedup_last_hop=False)
    feats = np.asarray(ds.feat)[np.maximum(np.asarray(batch.input_nodes), 0)]
    feats[np.asarray(batch.input_nodes) < 0] = 0
    labels = np.asarray(ds.label)[seeds[:128]].astype(np.int32)
    labels[-7:] = -1            # padded rows are left out of the loss
    dst_caps = tuple(reversed(plan.num_input_cap))
    return batch, feats, labels, dst_caps


def flax_model(batch, feats, dst_caps, dtype=None, seed=1):
    m = JGraphSAGE(IN, HID, CLS, 2, dropout=0.0, dtype=dtype)
    params = m.init(jax.random.key(seed), batch, jnp.asarray(feats), dst_caps,
                    deterministic=True)["params"]
    return m, params


def torch_model(params, dtype=None):
    m = GraphSAGE(IN, HID, CLS, 2, dropout=0.0, dtype=dtype)
    m.load_state_dict(params_from_flax(params))
    return m


def jax_loss(m, params, batch, feats, labels, dst_caps):
    logits = m.apply({"params": params}, batch, jnp.asarray(feats), dst_caps,
                     deterministic=True)
    return jloop.masked_cross_entropy(logits[:128], jnp.asarray(labels))[0]


def test_params_from_flax_layout(sampled):
    batch, feats, _, dst_caps = sampled
    _, params = flax_model(batch, feats, dst_caps)
    sd = params_from_flax(params)
    assert set(sd) == set(GraphSAGE(IN, HID, CLS, 2).state_dict())
    np.testing.assert_array_equal(
        sd["layers.0.fc_self.weight"].numpy(),
        np.asarray(params["SAGEConv_0"]["fc_self"]["kernel"]).T)


def test_graphsage_f32_logits_loss_and_grads(sampled):
    """f32: logits and loss to 1e-5. Gradients to 1e-5 (absolute) plus 1e-4
    relative: the backward scatter-adds sum in another order than XLA's."""
    batch, feats, labels, dst_caps = sampled
    jm, params = flax_model(batch, feats, dst_caps)
    jlogits = jm.apply({"params": params}, batch, jnp.asarray(feats),
                       dst_caps, deterministic=True)
    jl, jgrads = jax.value_and_grad(
        lambda p: jax_loss(jm, p, batch, feats, labels, dst_caps))(params)

    tm = torch_model(params)
    tbatch = batch_to_torch(batch)
    tlogits = tm(tbatch, torch.from_numpy(feats), dst_caps)
    np.testing.assert_allclose(to_numpy(tlogits), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    tl, _ = tloop.masked_cross_entropy(tlogits[:128], torch.from_numpy(labels))
    tl.backward()
    assert abs(tl.item() - float(jl)) < 1e-5
    want = params_from_flax(jgrads)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_graphsage_bf16_tracks_reference(sampled):
    """bf16 compute: logits within the 3e-2 that
    test_model_golden.py::test_sageconv_bf16_tracks_f32_golden allows (bf16
    keeps ~3 decimal digits and the frameworks round at other places)."""
    batch, feats, _, dst_caps = sampled
    jm, params = flax_model(batch, feats, dst_caps, dtype=jnp.bfloat16)
    jlogits = jm.apply({"params": params}, batch,
                       jnp.asarray(feats).astype(jnp.bfloat16), dst_caps,
                       deterministic=True)
    tm = torch_model(params, dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    tlogits = tm(batch_to_torch(batch),
                 torch.from_numpy(feats).to(torch.bfloat16), dst_caps)
    assert tlogits.dtype == torch.bfloat16
    np.testing.assert_allclose(to_numpy(tlogits),
                               np.asarray(jlogits).astype(np.float32),
                               rtol=3e-2, atol=3e-2)


def generic_block(rng, src_cap, dst_cap):
    """Irregular block (E_cap not a multiple of dst_cap): the generic
    scatter form, as in test_model_golden.make_block(regular=False)."""
    E = dst_cap * 4 + 3
    dst = rng.integers(0, dst_cap, E).astype(np.int32)
    mask = (rng.random(E) < 0.7) & (dst != 0)
    src = rng.integers(0, src_cap, E).astype(np.int32)
    return jsamp.Block(src_local=jnp.asarray(np.where(mask, src, -1)),
                       dst_local=jnp.asarray(np.where(mask, dst, -1)),
                       mask=jnp.asarray(mask), num_src=jnp.int32(src_cap),
                       num_dst=jnp.int32(dst_cap))


@pytest.mark.parametrize("form", ["tiered", "regular", "generic"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_segment_agg_gather_src_and_in_degrees_match(sampled, form, mode):
    """f32 aggregation to 1e-5: only the summation order differs. Gathered
    source rows and in-degrees are exact."""
    batch, _, _, dst_caps = sampled
    rng = np.random.default_rng(4)
    if form == "generic":
        jb, dst_cap, src_cap = generic_block(rng, 40, 12), 12, 40
    elif form == "tiered":      # layer 1: src space = [frontier | slots]
        jb, dst_cap = batch.blocks[0], dst_caps[0]
        src_cap = batch.input_nodes.shape[0]
    else:                       # layer 2: src space = the hop-0 unique list
        jb, dst_cap, src_cap = batch.blocks[1], dst_caps[1], dst_caps[0]
    tb = block_to_torch(jb)
    msgs = rng.standard_normal((jb.mask.shape[0], 8)).astype(np.float32)
    ja = jagg.segment_agg(jnp.asarray(msgs), jb, dst_cap, mode=mode)
    ta = tagg.segment_agg(torch.from_numpy(msgs), tb, dst_cap, mode=mode)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tagg.in_degrees(tb, dst_cap).numpy(),
                                  np.asarray(jagg.in_degrees(jb, dst_cap)))
    h = rng.standard_normal((src_cap, 8)).astype(np.float32)
    jsrc = np.asarray(jagg.gather_src(jnp.asarray(h), jb))
    tsrc = tagg.gather_src(torch.from_numpy(h), tb).numpy()
    m = np.asarray(jb.mask)
    # padded edges: JAX reads row 0, the port a zero row; both are masked
    np.testing.assert_array_equal(tsrc[m], jsrc[m])


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_train_step_matches_optax(sampled, weight_decay):
    """One step from identical parameters, dropout 0: loss and gradients
    tight, then the parameters after adam/adamw. After one step adam moves
    a parameter by about lr * sign(grad), so where |grad| < 1e-6 the two
    frameworks may disagree in sign by round-off: there the parameters may
    differ by up to 2 lr; elsewhere by 1e-6."""
    batch, feats, labels, dst_caps = sampled
    lr = 0.01
    jm, params = flax_model(batch, feats, dst_caps)
    tx = (optax.adamw(lr, weight_decay=weight_decay) if weight_decay
          else optax.adam(lr))
    state = jloop.TrainState.create(params, tx)
    step = jloop.make_train_step(jm, tx, dst_caps, 128)
    jlabels = np.full(batch.output_nodes.shape[0], -1, np.int32)
    jlabels[:128] = labels
    jgrads = jax.grad(
        lambda p: jax_loss(jm, p, batch, feats, labels, dst_caps))(params)
    new_state, jl, jacc = step(state, batch, jnp.asarray(feats),
                               jnp.asarray(jlabels), jax.random.key(0))

    tm = torch_model(params)
    opt = tloop.make_optimizer(tm.parameters(), lr, weight_decay)
    tl, tacc = tloop.train_step(tm, opt, batch_to_torch(batch),
                                torch.from_numpy(feats),
                                torch.from_numpy(jlabels), dst_caps, 128)
    assert abs(float(tl) - float(jl)) < 1e-5
    assert abs(float(tacc) - float(jacc)) < 1e-6
    grads = params_from_flax(jgrads)
    after = params_from_flax(new_state.params)
    for name, p in tm.named_parameters():
        g = grads[name].numpy()
        tol = np.where(np.abs(g) < 1e-6, 2 * lr + 1e-6, 1e-6)
        assert np.all(np.abs(p.detach().numpy() - after[name].numpy()) <= tol), name


def linear_params(layer):
    """(W [in, out], b) of a torch Linear, in the goldens' layout."""
    w = layer.weight.detach().numpy().T
    b = None if layer.bias is None else layer.bias.detach().numpy()
    return w, b


@pytest.mark.parametrize("regular", [True, False])
def test_sageconv_matches_dgl_golden(regular):
    """The port's SAGEConv against test_model_golden.py's independent NumPy
    DGL golden, at that test's f32 tolerance (1e-4)."""
    rng = np.random.default_rng(1)
    src_cap, dst_cap = 37, 11
    block = make_block(rng, src_cap, dst_cap, regular=regular)
    h = rng.standard_normal((src_cap, 8)).astype(np.float32)
    conv = SAGEConv(8, 5)
    conv.reset_parameters(torch.Generator().manual_seed(2))
    out = conv(block_to_torch(block), torch.from_numpy(h), dst_cap)
    ws, bs = linear_params(conv.fc_self)
    wn, _ = linear_params(conv.fc_neigh)
    gold = golden_sageconv(block, h, dst_cap, ws, bs, wn)
    np.testing.assert_allclose(out.detach().numpy(), gold, rtol=1e-4,
                               atol=1e-4)


def test_sageconv_bf16_tracks_f32_golden():
    """bf16 compute, f32 params: within bf16's ~3 decimal digits (3e-2),
    as test_model_golden.py::test_sageconv_bf16_tracks_f32_golden."""
    rng = np.random.default_rng(6)
    src_cap, dst_cap = 64, 16
    block = make_block(rng, src_cap, dst_cap, regular=True)
    h = rng.standard_normal((src_cap, 16)).astype(np.float32)
    conv = SAGEConv(16, 8, dtype=torch.bfloat16)
    conv.reset_parameters(torch.Generator().manual_seed(7))
    out = conv(block_to_torch(block), torch.from_numpy(h), dst_cap)
    ws, bs = linear_params(conv.fc_self)
    wn, _ = linear_params(conv.fc_neigh)
    gold = golden_sageconv(block, h, dst_cap, ws, bs, wn)
    np.testing.assert_allclose(to_numpy(out), gold, rtol=3e-2, atol=3e-2)


def test_two_layer_graphsage_matches_composed_golden():
    """Whole-model forward (2 layers, eval mode) against composed goldens:
    block order, relu placement and dst prefixing, as in
    test_model_golden.py."""
    rng = np.random.default_rng(4)
    b0 = make_block(rng, 50, 20, regular=True, K=3)
    b1 = make_block(rng, 20, 8, regular=False, K=3)
    feats = rng.standard_normal((50, 6)).astype(np.float32)
    batch = tsamp.SampledBatch(
        blocks=(block_to_torch(b0), block_to_torch(b1)),
        input_nodes=torch.arange(50, dtype=torch.int32),
        num_input=torch.tensor(50, dtype=torch.int32),
        output_nodes=torch.arange(8, dtype=torch.int32),
        num_output=torch.tensor(8, dtype=torch.int32),
        overflowed=torch.tensor(False))
    m = GraphSAGE(6, 7, 5, 2, generator=torch.Generator().manual_seed(5))
    m.eval()
    out = m(batch, torch.from_numpy(feats), (20, 8)).detach().numpy()
    l0, l1 = m.layers
    h1 = np.maximum(golden_sageconv(
        b0, feats, 20, *linear_params(l0.fc_self),
        linear_params(l0.fc_neigh)[0]), 0.0)
    gold = golden_sageconv(b1, h1.astype(np.float32), 8,
                           *linear_params(l1.fc_self),
                           linear_params(l1.fc_neigh)[0])
    np.testing.assert_allclose(out, gold, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["graphsage", "gcn", "pinsage", "gat",
                                  "unknown"])
def test_build_model_builds_every_model(name):
    """All four model families build as torch modules with float32
    parameters; an unknown name raises."""
    if name == "unknown":
        with pytest.raises(ValueError, match="unknown model"):
            build_model(name, 4, 8, 2, 2)
        return
    m = build_model(name, 4, 8, 2, 2, generator=torch.Generator().manual_seed(0))
    assert isinstance(m, torch.nn.Module) and len(m.layers) == 2
    assert all(p.dtype == torch.float32 for p in m.parameters())
