"""PinSAGE: the random walk, the top-K by visit count, the multi-hop
sampler, the weighted mean, ``WeightedSAGEConv``, the model, its train step
and the engine's RANDOM_WALK path, each against the JAX package with the
same inputs (the reference's own walk uniforms injected into the port,
flax parameters carried across by ``params_from_flax``).

Tolerances: visits, top-K, blocks (weights included) and overflow flags
exact; the weighted mean 1e-5 (float32 sums in another order);
WeightedSAGEConv 1e-4 in float32 (the NumPy golden's own tolerance) and
3e-2 in bf16 (bf16 keeps ~3 decimal digits and the frameworks round at
other places); engine losses 1e-4 over three Adam steps; evaluation within
one test row.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fgnn_tpu.config import RunConfig, SampleType
from fgnn_tpu.data import make_synthetic_dataset
from fgnn_tpu.models import aggregate as jagg
from fgnn_tpu.models.gnn import PinSAGE as JPinSAGE
from fgnn_tpu.models.gnn import WeightedSAGEConv as JWeightedSAGEConv
from fgnn_tpu.ops import random_walk as jrw
from fgnn_tpu.ops import sampling as jsamp
from fgnn_tpu.train import loop as jloop
from fgnn_tpu_torch.models import aggregate as tagg
from fgnn_tpu_torch.models.convert import params_from_flax
from fgnn_tpu_torch.models.gnn import PinSAGE, WeightedSAGEConv
from fgnn_tpu_torch.ops import random_walk as trw
from fgnn_tpu_torch.ops import sampling as tsamp
from fgnn_tpu_torch.ops.padding import make_plan
from fgnn_tpu_torch.ops.reference_impl import calibrate_caps
from fgnn_tpu_torch.train import loop as tloop
from test_model_golden import golden_weighted_sage, make_block
from test_random_walk import _golden_visit_freq, _tiny_graph
from test_torch_engine import evaluate_matches_reference, steps_match_reference
from test_torch_model import generic_block, linear_params
from torch_parity import (assert_batches_equal, batch_to_torch, block_to_torch,
                          jax_walk_draws, jax_walk_uniforms, to_numpy, to_torch)

torch.set_num_threads(2)
W, L, K = 4, 3, 4
IN, HID, CLS = 16, 32, 5
RW = SampleType.RANDOM_WALK


@pytest.fixture(scope="module")
def ds():
    return make_synthetic_dataset(num_node=600, avg_degree=6, feat_dim=IN,
                                  num_class=CLS, train_frac=0.5, seed=5)


def csr(indptr, indices):
    jg = jsamp.CSRGraph(indptr=jnp.asarray(np.asarray(indptr, np.int32)),
                        indices=jnp.asarray(np.asarray(indices, np.int32)))
    tg = tsamp.CSRGraph(
        indptr=torch.from_numpy(np.asarray(indptr).astype(np.int64)),
        indices=torch.from_numpy(np.asarray(indices).astype(np.int32)))
    return jg, tg


def rw_plan(ds, batch_size=64, layers=3, scale=None):
    fan = [K] * layers
    caps = calibrate_caps(np.asarray(ds.indptr), np.asarray(ds.indices),
                          np.asarray(ds.train_set), batch_size, fan)
    kw = {} if scale is None else {"scale": scale}
    return make_plan(batch_size, fan, ds.num_node, unique_caps=caps, **kw)


def rw_seeds(ds, plan):
    s = np.full(plan.num_input_cap[0], -1, np.int32)
    s[:plan.batch_size] = np.random.default_rng(0).choice(
        np.asarray(ds.train_set), plan.batch_size, replace=False)
    return s


def flax_init(model, seed, *args):
    """The flax module's parameters, initialised under jit (eager init of
    a multi-layer module takes seconds on the CPU)."""
    return jax.jit(lambda k: model.init(k, *args, deterministic=True))(
        jax.random.key(seed))["params"]


def jax_batch(ds, plan, key, dedup):
    jg, _ = csr(ds.indptr, ds.indices)
    return jax.jit(lambda k: jrw.random_walk_topk(
        k, jg, jnp.asarray(rw_seeds(ds, plan)), jnp.int32(plan.batch_size),
        plan, num_random_walk=W, random_walk_length=L, restart_prob=0.5,
        dedup_last_hop=dedup))(key)


# --- the walk, the top-K and the sampler: exact --------------------------

@pytest.mark.parametrize("restart_prob", [0.0, 0.5, 1.0])
def test_random_walk_visits_match(restart_prob):
    """Injected JAX draws: equal visits, with a dead-end node (5), -1 seeds
    and every other node as seeds."""
    jg, tg = csr(*_tiny_graph())
    seeds = np.array([0, 1, 2, 3, 4, 5, -1, 5, 0, -1, 3, 2], np.int32)
    key = jax.random.key(3)
    jv = jrw.random_walk_visits(key, jg, jnp.asarray(seeds), W, L, restart_prob)
    tv = trw.random_walk_visits(tg, torch.from_numpy(seeds), W, L,
                                restart_prob,
                                jax_walk_draws(key, L, len(seeds), W))
    np.testing.assert_array_equal(to_numpy(tv), np.asarray(jv))
    tv = to_numpy(tv).reshape(len(seeds), W, L)
    assert (tv[seeds == 5] == -1).all() and (tv[seeds < 0] == -1).all()
    if restart_prob == 1.0:
        assert (tv[seeds < 5, :, 1:] == -1).all()


def test_topk_by_frequency_matches_on_ties():
    """Rows full of ties (ids from a pool of 4, so counts repeat), rows of
    -1, a single visit, and k both under and over M."""
    rng = np.random.default_rng(1)
    visits = rng.integers(-1, 4, (200, 12)).astype(np.int32)
    visits[:10] = -1
    visits[10:20] = -1
    visits[10:20, 5] = 7
    for k in (3, 5, 12, 15):
        jd, jw = jrw.topk_by_frequency(jnp.asarray(visits), k)
        td, tw = trw.topk_by_frequency(torch.from_numpy(visits), k)
        np.testing.assert_array_equal(to_numpy(td), np.asarray(jd))
        np.testing.assert_array_equal(to_numpy(tw), np.asarray(jw))
        assert tw.shape == (200, k)
    # ties straddle the cut: more equally visited ids than slots
    counts = [np.unique(r[r >= 0], return_counts=True)[1] for r in visits]
    assert any(len(c) > 3 and np.sort(c)[-3] == np.sort(c)[-4] for c in counts)


@pytest.mark.parametrize("mode", ["dedup", "no-dedup", "clipping"])
def test_random_walk_topk_matches(ds, mode):
    """Every block field (weights included), the unique lists and the
    overflow flag, for a 3-hop plan, with the last hop deduped or not, and
    with caps cut so the dedup clips."""
    plan = rw_plan(ds, scale=0.4 if mode == "clipping" else None)
    dedup = mode != "no-dedup"
    key = jax.random.key(21)
    jbatch = jax_batch(ds, plan, key, dedup)
    _, tg = csr(ds.indptr, ds.indices)
    tbatch = trw.random_walk_topk(
        tg, torch.from_numpy(rw_seeds(ds, plan)), plan.batch_size, plan,
        num_random_walk=W, random_walk_length=L, restart_prob=0.5,
        dedup_last_hop=dedup,
        rand=jax_walk_uniforms(key, trw.walk_uniform_shapes(plan, W, L)))
    assert_batches_equal(jbatch, tbatch)
    assert bool(tbatch.overflowed) == (mode == "clipping")
    last = tbatch.blocks[0]
    assert (last.src_slice_offset is None) == dedup
    w = to_numpy(last.weights).reshape(-1, K)
    assert ((w[:, :-1] == w[:, 1:]) & (w[:, 1:] > 0)).any()   # tied counts


def test_injected_walk_uniforms_are_checked():
    _, tg = csr(*_tiny_graph())
    with pytest.raises(ValueError, match="injected uniforms"):
        trw.random_walk_visits(tg, torch.zeros(4, dtype=torch.int32), W, L,
                               0.5, torch.zeros(L, 2, 4, W + 1))


# --- the port's own generator: tests/test_random_walk.py's goldens -------

@pytest.mark.parametrize("restart_prob", [0.0, 0.5])
def test_visit_distribution_with_generator(restart_prob):
    indptr, indices = _tiny_graph()
    _, tg = csr(indptr, indices)
    trials = 800
    visits = to_numpy(trw.random_walk_visits(
        tg, torch.zeros(trials, dtype=torch.int32), W, L, restart_prob,
        torch.Generator().manual_seed(7)))
    ours = np.zeros(len(indptr) - 1)
    np.add.at(ours, visits[visits >= 0], 1.0)
    ours /= trials
    golden = _golden_visit_freq(indptr, indices, 0, W, L, restart_prob,
                                trials, np.random.default_rng(3))
    assert ours.sum() > 0
    np.testing.assert_allclose(ours, golden, rtol=0.15, atol=0.12)


def test_restart_one_and_dead_end_with_generator():
    _, tg = csr(*_tiny_graph())
    gen = torch.Generator().manual_seed(0)
    v = to_numpy(trw.random_walk_visits(
        tg, torch.arange(5, dtype=torch.int32), 2, 4, 1.0, gen)).reshape(5, 2, 4)
    assert (v[:, :, 0] >= 0).all() and (v[:, :, 1:] == -1).all()
    dead = trw.random_walk_visits(tg, torch.tensor([5], dtype=torch.int32),
                                  3, 3, 0.0, gen)
    assert (to_numpy(dead) == -1).all()


def test_topk_by_frequency_golden():
    visits = torch.tensor([[3, 3, 1, 2, 3, 2, -1, -1],
                           [7, -1, -1, -1, -1, -1, -1, -1],
                           [-1] * 8], dtype=torch.int32)
    dst, w = (to_numpy(x) for x in trw.topk_by_frequency(visits, 3))
    assert dst[0].tolist() == [3, 2, 1] and w[0].tolist() == [3.0, 2.0, 1.0]
    assert dst[1, 0] == 7 and w[1, 0] == 1.0
    assert (dst[1, 1:] == -1).all() and (w[1, 1:] == 0.0).all()
    assert (dst[2] == -1).all() and (w[2] == 0.0).all()


# --- the weighted mean and the conv --------------------------------------

@pytest.fixture(scope="module")
def tiered_block():
    """A tiered no-dedup block from the JAX uniform sampler (the weighted
    mean's tiered branch is shared by every sampler)."""
    d = make_synthetic_dataset(num_node=2000, avg_degree=12, feat_dim=4,
                               num_class=2, seed=3)
    caps, stats = calibrate_caps(
        np.asarray(d.indptr), np.asarray(d.indices), np.asarray(d.train_set),
        64, [5, 12], tier_candidates=(4, 6, 8))
    plan = make_plan(64, (12, 5), d.num_node, unique_caps=caps,
                     tier_stats=stats)
    jg, _ = csr(d.indptr, d.indices)
    seeds = np.full(plan.num_input_cap[0], -1, np.int32)
    seeds[:64] = np.asarray(d.train_set)[:64]
    batch = jax.jit(lambda k: jsamp.multi_layer_sample(
        k, jg, jnp.asarray(seeds), jnp.int32(64), plan, SampleType.KHOP2,
        dedup_last_hop=False))(jax.random.key(0))
    blk = batch.blocks[0]
    assert blk.tier_split is not None
    return blk, plan.num_input_cap[-1]


@pytest.mark.parametrize("form", ["regular", "tiered", "generic"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted_mean_matches(tiered_block, form, dtype):
    """float32 weights promote bf16 messages: the result is float32 in
    both frameworks. 1e-5 (summation order) in float32."""
    rng = np.random.default_rng(8)
    if form == "tiered":
        jb, dst_cap = tiered_block
    elif form == "regular":
        jb, dst_cap = make_block(rng, 30, 12, regular=True, K=5), 12
    else:
        jb, dst_cap = generic_block(rng, 40, 12), 12
    E = jb.mask.shape[0]
    w = (rng.integers(0, 4, E) * (rng.random(E) < 0.9)).astype(np.float32)
    msgs = rng.standard_normal((E, 8)).astype(np.float32)
    jm = jnp.asarray(msgs).astype(dtype)
    ja = jagg.segment_agg(jm, jb, dst_cap, mode="weighted_mean",
                          edge_weights=jnp.asarray(w))
    ta = tagg.segment_agg(to_torch(jm), block_to_torch(jb), dst_cap,
                          mode="weighted_mean", edge_weights=torch.from_numpy(w))
    assert ja.dtype == jnp.float32 and ta.dtype == torch.float32
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-5)


def conv_pair(block, h, dst_cap, dtype, seed=3):
    jm = JWeightedSAGEConv(hidden_dim=7, out_dim=6, dropout=0.5,
                           dtype=None if dtype is None else jnp.bfloat16)
    params = flax_init(jm, seed, block, jnp.asarray(h), dst_cap)
    tm = WeightedSAGEConv(h.shape[1], 7, 6, dropout=0.5, dtype=dtype)
    tm.load_state_dict(params_from_flax(params))
    tm.eval()
    return jm, params, tm


@pytest.mark.parametrize("regular", [True, False])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_weighted_sage_conv_forward_and_grads(regular, dtype):
    """Against flax through params_from_flax: the output and the gradients
    of sum(out * r) with respect to every parameter and the input."""
    rng = np.random.default_rng(2)
    src_cap, dst_cap = 33, 10
    block = make_block(rng, src_cap, dst_cap, regular=regular,
                       with_weights=True)
    h = rng.standard_normal((src_cap, 8)).astype(np.float32)
    r = rng.standard_normal((dst_cap, 6)).astype(np.float32)
    jm, params, tm = conv_pair(block, h, dst_cap, dtype)
    jdt = jnp.float32 if dtype is None else jnp.bfloat16
    tol = 1e-4 if dtype is None else 3e-2

    def jloss(p, x):
        out = jm.apply({"params": p}, block, x.astype(jdt), dst_cap,
                       deterministic=True)
        return jnp.sum(out.astype(jnp.float32) * r), out

    (_, jout), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(h))
    x = torch.from_numpy(h).requires_grad_()
    tout = tm(block_to_torch(block), x if dtype is None else x.to(dtype), dst_cap)
    assert tout.dtype == (torch.float32 if dtype is None else dtype)
    (tout.float() * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(to_numpy(tout), np.asarray(jout, np.float32),
                               rtol=tol, atol=tol)
    want = params_from_flax(jg)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=tol, atol=tol, err_msg=name)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgx),
                               rtol=tol, atol=tol)


def test_params_from_flax_places_weighted_sage_params():
    rng = np.random.default_rng(0)
    block = make_block(rng, 20, 6, regular=True, with_weights=True)
    h = rng.standard_normal((20, 8)).astype(np.float32)
    m = JPinSAGE(8, 7, 3, 2, dropout=0.0)
    batch = jsamp.SampledBatch(
        blocks=(block, make_block(rng, 6, 2, regular=True, with_weights=True)),
        input_nodes=jnp.arange(20, dtype=jnp.int32), num_input=jnp.int32(20),
        output_nodes=jnp.arange(2, dtype=jnp.int32), num_output=jnp.int32(2),
        overflowed=jnp.zeros((), bool))
    params = flax_init(m, 0, batch, jnp.asarray(h), (6, 2))
    sd = params_from_flax(params)
    assert set(sd) == set(PinSAGE(8, 7, 3, 2).state_dict())
    for i in (0, 1):
        for sub in ("Q", "W"):
            src = params[f"WeightedSAGEConv_{i}"][sub]
            np.testing.assert_array_equal(sd[f"layers.{i}.{sub}.weight"].numpy(),
                                          np.asarray(src["kernel"]).T)
            np.testing.assert_array_equal(sd[f"layers.{i}.{sub}.bias"].numpy(),
                                          np.asarray(src["bias"]))


@pytest.mark.parametrize("regular", [True, False])
def test_weighted_sage_matches_pinsage_golden(regular):
    """The port's conv against test_model_golden.py's independent NumPy
    golden of the reference's WeightedSAGEConv, at its tolerance (1e-4)."""
    rng = np.random.default_rng(2)
    src_cap, dst_cap = 33, 10
    block = make_block(rng, src_cap, dst_cap, regular=regular,
                       with_weights=True)
    h = rng.standard_normal((src_cap, 8)).astype(np.float32)
    conv = WeightedSAGEConv(8, 7, 6)
    conv.reset_parameters(torch.Generator().manual_seed(4))
    conv.eval()
    out = conv(block_to_torch(block), torch.from_numpy(h), dst_cap)
    gold = golden_weighted_sage(block, h, dst_cap, *linear_params(conv.Q),
                                *linear_params(conv.W))
    np.testing.assert_allclose(out.detach().numpy(), gold, rtol=1e-4, atol=1e-4)


# --- the model and its train step ----------------------------------------

@pytest.fixture(scope="module")
def rw_batch(ds):
    """A JAX-sampled 3-hop PinSAGE batch (no-dedup last hop), its
    features, labels (some -1) and dst caps."""
    plan = rw_plan(ds)
    batch = jax_batch(ds, plan, jax.random.key(5), dedup=False)
    ids = np.asarray(batch.input_nodes)
    feats = np.asarray(ds.feat)[np.maximum(ids, 0)]
    feats[ids < 0] = 0
    labels = np.full(plan.num_input_cap[0], -1, np.int32)
    labels[:plan.batch_size] = np.asarray(ds.label)[
        rw_seeds(ds, plan)[:plan.batch_size]]
    labels[plan.batch_size - 5:plan.batch_size] = -1
    return batch, feats, labels, tuple(reversed(plan.num_input_cap)), plan


def test_pinsage_train_step_matches_optax(rw_batch):
    """One Adam step from identical parameters at dropout 0: the loss, the
    accuracy and the new parameters (within 2 lr where |grad| < 1e-6, as
    test_torch_model.py::test_train_step_matches_optax allows; 1e-6
    elsewhere)."""
    batch, feats, labels, dst_caps, plan = rw_batch
    B, lr = plan.batch_size, 0.01
    jm = JPinSAGE(IN, HID, CLS, 3, dropout=0.0)
    params = flax_init(jm, 1, batch, jnp.asarray(feats), dst_caps)
    tx = optax.adam(lr)
    step = jloop.make_train_step(jm, tx, dst_caps, B)
    jfeats, jlabels = jnp.asarray(feats), jnp.asarray(labels)

    def reference(p):
        """The reference's step and, from the same parameters, its grads."""
        grads = jax.grad(lambda q: jloop.masked_cross_entropy(
            jm.apply({"params": q}, batch, jfeats, dst_caps,
                     deterministic=True)[:B], jlabels[:B])[0])(p)
        return step(jloop.TrainState.create(p, tx), batch, jfeats, jlabels,
                    jax.random.key(0)), grads

    (new_state, jl, jacc), jgrads = jax.jit(reference)(params)
    tm = PinSAGE(IN, HID, CLS, 3, dropout=0.0)
    tm.load_state_dict(params_from_flax(params))
    opt = tloop.make_optimizer(tm.parameters(), lr)
    tl, tacc = tloop.train_step(tm, opt, batch_to_torch(batch),
                                torch.from_numpy(feats),
                                torch.from_numpy(labels), dst_caps, B)
    assert abs(float(tl) - float(jl)) < 1e-5
    assert abs(float(tacc) - float(jacc)) < 1e-6
    grads = params_from_flax(jgrads)
    after = params_from_flax(new_state.params)
    for name, p in tm.named_parameters():
        g = grads[name].numpy()
        tol = np.where(np.abs(g) < 1e-6, 2 * lr + 1e-6, 1e-6)
        assert np.all(np.abs(p.detach().numpy() - after[name].numpy()) <= tol), name


def test_pinsage_bf16_logits_track_reference(rw_batch):
    batch, feats, _, dst_caps, _ = rw_batch
    jm = JPinSAGE(IN, HID, CLS, 3, dropout=0.5, dtype=jnp.bfloat16)
    params = flax_init(jm, 2, batch, jnp.asarray(feats), dst_caps)
    jlogits = jax.jit(lambda p: jm.apply({"params": p}, batch,
                                         jnp.asarray(feats), dst_caps,
                                         deterministic=True))(params)
    tm = PinSAGE(IN, HID, CLS, 3, dropout=0.5, dtype=torch.bfloat16)
    tm.load_state_dict(params_from_flax(params))
    tm.eval()
    tlogits = tm(batch_to_torch(batch), torch.from_numpy(feats), dst_caps)
    assert tlogits.dtype == torch.bfloat16
    np.testing.assert_allclose(to_numpy(tlogits),
                               np.asarray(jlogits, np.float32),
                               rtol=3e-2, atol=3e-2)


def test_pinsage_dropout_draws_two_masks_a_layer(rw_batch, monkeypatch):
    """Training mode: each layer drops out Q's input (every src row) and
    then W's input (the dst rows' concat); eval mode drops nothing."""
    from fgnn_tpu_torch.models import gnn as tgnn

    batch, feats, _, dst_caps, _ = rw_batch
    shapes = []
    real = tgnn.dropout

    def spy(h, p, generator):
        shapes.append(tuple(h.shape))
        return real(h, p, generator)

    monkeypatch.setattr(tgnn, "dropout", spy)
    tm = PinSAGE(IN, HID, CLS, 3, dropout=0.5)
    tb, x = batch_to_torch(batch), torch.from_numpy(feats)
    tm(tb, x, dst_caps, generator=torch.Generator().manual_seed(9))
    rows = [feats.shape[0]] + list(dst_caps)
    want = []
    for i, layer in enumerate(tm.layers):
        want += [(rows[i], layer.Q.in_features),
                 (dst_caps[i], layer.W.in_features)]
    assert shapes == want
    shapes.clear()
    tm.eval()
    tm(tb, x, dst_caps, generator=torch.Generator().manual_seed(9))
    assert shapes == []


# --- the engine's RANDOM_WALK path ---------------------------------------

CFG = RunConfig(model="pinsage", sample_type=RW, batch_size=64,
                num_hidden=HID, num_layer_rw=3, num_neighbor=K,
                num_random_walk=W, random_walk_length=L, dropout=0.0,
                lr=0.003, compute_dtype="float32")


@pytest.fixture(scope="module")
def eng_ds():
    return make_synthetic_dataset(num_node=2000, avg_degree=8, feat_dim=32,
                                  num_class=8, train_frac=0.5, seed=42)


def test_pinsage_engine_steps_match_reference(eng_ds):
    """The untiered plan, no last-hop dedup; per step edges and overflow
    equal, loss within 1e-4."""
    steps_match_reference(eng_ds, CFG)


def test_pinsage_evaluate_matches_reference(eng_ds):
    evaluate_matches_reference(eng_ds, CFG)
