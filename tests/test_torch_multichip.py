"""The multi-device gates (``fgnn_tpu_torch.tools.multichip``, the port of
the JAX package's ``dryrun_multichip``) on this machine's CPU, the
faults they must catch, the gradient route of a process per role, and
the multi-device engines against the JAX package where the gates leave
it: arch6 at W=4 (tests/test_torch_sgnn.py) and one engaged-switcher
epoch with the reserve pinned on both.

* Every gate passes on ``["cpu"] * n`` for n = 2 and 4. Each gate fails
  on a planted fault: a trainer left at its first parameters (the
  comparisons), a reversed logical order of the gradients' fold ((a) at
  n = 4, the one comparison whose groups fold three terms: two terms sum
  the same either way; (a)'s float32 comparison catches it, since three
  gradients of bfloat16 compute sum exactly in float32 in any order),
  dropout drawn from another stream ((b)'s comparisons at dropout 0.5), a
  NaN parameter (c), every batch reported clipped (d), a group's loss
  summed instead of averaged (e).
* ``grad_route`` is a function of the placement: NCCL for cards that no
  two ranks share, told apart by UUID (two hosts may reuse an index, and
  one card may go by two names), the host for a shared card or the CPU.
* The switcher, S=1, T=2, its reserve pinned to 4 of 8 batches: the epoch's
  loss and the parameters after it within 1e-4 of the reference's, the
  factored epoch tests' tolerance."""
import copy

import jax
import numpy as np
import pytest
import torch

from fgnn_tpu.config import RunConfig, SampleType
from fgnn_tpu.data import make_synthetic_dataset
from fgnn_tpu.parallel.switcher import SwitcherEngine as JSwitcher
from fgnn_tpu_torch.models.convert import params_from_flax
from fgnn_tpu_torch.ops.extract import label_gather
from fgnn_tpu_torch.parallel import multihost as mh
from fgnn_tpu_torch.parallel.switcher import SwitcherEngine
from fgnn_tpu_torch.tools import factored_epochs, multichip
from fgnn_tpu_torch.train.loop import masked_cross_entropy
from torch_parity import ReferenceDraws, params_close, port_cfg, port_ds

torch.set_num_threads(2)

TOL = 1e-4


def gates(n, only=multichip.GATES, plant=None):
    with multichip.deterministic_algorithms():
        return multichip.run_gates(["cpu"] * n, only, plant,
                                   emit=lambda line: None)


# -- the gates ----------------------------------------------------------------
@pytest.mark.parametrize("n", [2, 4])
def test_every_gate_passes_on_the_cpu(n):
    got = gates(n)
    assert [g.name for g in got] == list(multichip.GATES)
    for g in got:
        assert g.ok is True, g.line()
    by = {g.name: g for g in got}
    for name in "abfgh":
        assert by[name].bit_equal is True and by[name].overflow is False
    assert "reserve" in by["h"].detail


def stale_trainer(eng):
    """The group's last logical trainer keeps the engine's first
    parameters: a replica is not refreshed from the stepped model (width
    2 or more), or the lone trainer's step is lost."""
    first = copy.deepcopy(eng.model.state_dict())
    replica = eng._replica

    def stale(i, dev):
        rep = replica(i, dev)
        if i:
            rep.load_state_dict(first)
        return rep

    eng._replica = stale
    if eng.roles.num_trainer == 1 and not hasattr(eng, "full_devices"):
        eng.optimizer.step = lambda *a, **k: None


def reversed_fold(eng):
    """``_dp_step`` with the replicas' gradients folded T-1, ..., 1 into
    replica 0's, not 1, ..., T-1."""
    B = eng.cfg.batch_size

    def step(items, devices, gens):
        dev0 = devices[0]
        ws = [(b.num_output > 0).float() for b, _ in items]
        wsum = torch.stack([w.to(dev0) for w in ws]).sum().clamp(min=1.0)
        eng.optimizer.zero_grad(set_to_none=True)
        loss = acc = None
        for i, ((batch, feats), dev, gen) in enumerate(zip(items, devices,
                                                            gens)):
            model = eng._replica(i, dev)
            if i:
                model.zero_grad(set_to_none=True)
            model.train()
            logits = model(batch, feats, eng.dst_caps, generator=gen)
            labels = label_gather(eng._label(dev), batch.output_nodes)
            l, a = masked_cross_entropy(logits[:B], labels[:B])
            (l * ws[i] / wsum.to(dev)).backward()
            lw, aw = (l.detach() * ws[i]).to(dev0), (a * ws[i]).to(dev0)
            loss = lw if loss is None else loss + lw
            acc = aw if acc is None else acc + aw
        params = list(eng.model.parameters())
        own = [p.grad for p in params]
        for p in params:
            p.grad = None
        for i in [*range(len(items) - 1, 0, -1), 0]:
            src = params if i == 0 else list(eng.replicas[i].parameters())
            for k, (p, q) in enumerate(zip(params, src)):
                g = own[k] if i == 0 else q.grad
                if g is not None:
                    g = g.to(dev0)
                    p.grad = g if p.grad is None else p.grad + g
        eng.optimizer.step()
        return loss / wsum, acc / wsum

    eng._dp_step = step


def shifted_dropout_stream(eng):
    """Dropout drawn one index on: a run that differs from its comparison
    only where dropout is on."""
    gen = eng._dropout_gen
    eng._dropout_gen = lambda dev, index: gen(dev, index + 1)


def nan_parameter(eng):
    with torch.no_grad():
        next(eng.model.parameters()).fill_(float("nan"))


def every_batch_clipped(eng):
    surface = eng._surface_overflow
    eng._surface_overflow = lambda epoch, overflowed: surface(epoch, True)


def summed_group_loss(eng):
    step = eng._dp_step

    def summed(items, devices, gens):
        loss, acc = step(items, devices, gens)
        return loss * len(items), acc

    eng._dp_step = summed


@pytest.mark.parametrize("gate,n,fault", [
    ("a", 4, stale_trainer), ("a", 4, reversed_fold),
    ("b", 2, stale_trainer), ("b", 2, shifted_dropout_stream),
    ("b", 4, shifted_dropout_stream), ("f", 2, stale_trainer),
    ("g", 2, stale_trainer), ("h", 2, stale_trainer),
    ("c", 4, nan_parameter), ("d", 4, every_batch_clipped),
    ("e", 4, summed_group_loss)],
    ids=lambda x: getattr(x, "__name__", str(x)))
def test_gate_catches_a_planted_fault(gate, n, fault):
    (g,) = gates(n, gate)
    assert g.ok is True, g.line()
    (g,) = gates(n, gate, plant=fault)
    assert g.ok is False, g.line()
    if gate in "abfgh":
        assert g.bit_equal is False
    if fault is reversed_fold:
        assert "float32: " in g.detail, g.line()
    if fault is shifted_dropout_stream:
        assert "dropout 0.5: " in g.detail, g.line()


def test_one_card_refuses_the_placement_gates_by_name(monkeypatch):
    """Cards that are one card: (a) and (b) are refused, not passed, and
    (a)'s run still feeds (d) and (e). The run is the CPU's, read as one
    card: the refusal follows the names alone."""
    assert multichip.cards(["cuda:0", "cuda", "cuda:0"]) == 1
    assert multichip.cards(["cuda:1", "cuda:3"]) == 2
    assert multichip.one_card(["cuda:0"] * 4)
    assert not multichip.one_card(["cuda:0", "cuda:1"])
    assert not multichip.one_card(["cpu", "cpu"])
    assert [str(d) for d in multichip.layout(["cuda:0"])] == ["cuda:0"] * 4
    monkeypatch.setattr(multichip, "one_card", lambda devs: True)
    by = {g.name: g for g in gates(4, "abde")}
    assert by["a"].ok is None and "refused" in by["a"].detail
    assert by["b"].ok is None and "refused" in by["b"].line()
    assert by["d"].ok is True and by["e"].ok is True


def test_cli_prints_a_gate_a_line_and_json_last(capsys):
    rc = multichip.main(["--devices", "cpu,cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    assert [ln.split(" ")[1] for ln in out[:-1] if ln.startswith("gate ")] == [
        *multichip.GATES]
    import json
    last = json.loads(out[-1])
    assert last["ok"] is True and last["devices"] == ["cpu", "cpu"]
    assert "card" in last and len(last["gates"]) == len(multichip.GATES)
    assert not torch.are_deterministic_algorithms_enabled()
    assert multichip.main(["--devices", ","]) == 2


# -- the gradient route -------------------------------------------------------
def host_a(i, name=None):
    """Card i of one host, as ``rank_devices`` gives it (its UUID)."""
    return mh.Placed(name or f"cuda:{i}", f"GPU-a{i}")


def host_b(i):
    return mh.Placed(f"cuda:{i}", f"GPU-b{i}")


CPU = mh.Placed("cpu", None)


@pytest.mark.parametrize("placements,route", [
    ([[host_a(1)], [host_a(2)], [host_a(3)]], "nccl"),
    ([[host_a(0)], [host_a(1)]], "nccl"),
    ([[host_a(1), host_a(2)], [host_a(3)]], "nccl"),
    # two hosts of four cards, ``cuda:<rank mod 4>``: indices repeat
    ([[host_a(1)], [host_a(2)], [host_a(3)], [host_b(0)], [host_b(1)],
      [host_b(2)], [host_b(3)]], "nccl"),
    # a CUDA_VISIBLE_DEVICES of one card a process: every rank's cuda:0
    ([[host_a(1, "cuda:0")], [host_a(2, "cuda:0")]], "nccl"),
    ([[host_a(0)], [host_a(0)]], "host"),
    ([[host_a(0, "cuda")], [host_a(0)]], "host"),
    # one card under two names (two visible-device orders)
    ([[host_a(0, "cuda:0")], [host_a(0, "cuda:1")]], "host"),
    ([[host_a(1), host_a(2)], [host_a(2)]], "host"),
    ([[CPU], [CPU]], "host"),
    ([[host_a(1)], [CPU]], "host"),
], ids=["three-cards", "two-cards", "two-and-one", "two-hosts",
        "visible-devices", "shared", "cuda-and-cuda0", "one-uuid-two-names",
        "overlap", "cpu", "card-and-cpu"])
def test_grad_route_follows_the_placement(placements, route):
    assert mh.grad_route(placements) == route


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mh.default_device(0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mh.default_device(3) == torch.device("cuda", 1)


# -- against the reference ----------------------------------------------------
SWITCHER_CFG = RunConfig(model="graphsage", fanout=(10, 3), batch_size=128,
                         num_hidden=32, sample_type=SampleType.KHOP2,
                         dropout=0.0, lr=0.003, compute_dtype="float32",
                         num_sample_worker=1, num_train_worker=2)
RESERVE = 4


def test_engaged_switcher_epoch_matches_reference():
    """One epoch with the tail engaged and the reserve pinned on both (the
    calibration probe is wall-clock): 2 T-wide groups, then 4 batches in
    groups of S + T = 3, the last one padded. The loss and the parameters
    within 1e-4 of the reference's; the port's tail trained 4 batches."""
    ds = make_synthetic_dataset(num_node=2000, avg_degree=8, feat_dim=32,
                                num_class=8, train_frac=0.5, seed=42)
    cfg = SWITCHER_CFG
    jeng = JSwitcher(cfg, ds, devices=jax.devices()[:3])
    draws = ReferenceDraws(cfg.seed, cfg.sample_type)
    teng = SwitcherEngine(port_cfg(cfg), port_ds(ds), ["cpu"] * 3,
                          rand_fn=draws)
    draws.bind(teng, True)
    teng.model.load_state_dict(params_from_flax(jeng.state.params))
    assert teng.num_step == jeng.num_step == 8
    jeng._tail_reserve_batches = teng._tail_reserve_batches = RESERVE
    jr, tr = jeng.run_epoch(0), teng.run_epoch(0)
    assert teng.tail_batches == RESERVE and teng.num_full == 3
    assert np.isfinite(tr["loss"])
    assert abs(tr["loss"] - jr["loss"]) < TOL, (tr["loss"], jr["loss"])
    params_close(jeng.state.params, teng.model, TOL)


# -- the four-card layouts' launch counts ------------------------------------
def small_bench_config(**kw):
    from fgnn_tpu_torch.config import RunConfig as TRunConfig
    from fgnn_tpu_torch.config import SampleType as TSampleType

    return TRunConfig(model="graphsage", fanout=(5, 3), batch_size=128,
                      num_hidden=16, sample_type=TSampleType.KHOP2,
                      dropout=0.5, lr=0.003, compute_dtype="float32", **kw)


@pytest.mark.parametrize("name", sorted(factored_epochs.LAYOUTS))
def test_layout_launch_count_follows_the_schedule(name, monkeypatch):
    """Each four-device layout of ``tools.factored_epochs`` on ["cpu"] * 4
    at a small size: the K1 launches its schedule implies (3 a trained
    arch5 slot, pads and the switcher's wide tail included; 2 an arch6
    batch) equal the calls the epochs make to K1's wrapper, which on a
    card is one launch each. Losses finite, no overflow, every card's
    peak read (none here)."""
    from fgnn_tpu_torch.cache import manager
    from fgnn_tpu_torch.data import make_synthetic_dataset as tsynthetic
    from fgnn_tpu_torch.ops import gather

    monkeypatch.setattr(factored_epochs, "bench_config", small_bench_config)
    calls = [0]
    real = gather.gather_rows

    def spy(table, ids):
        calls[0] += 1
        return real(table, ids)

    monkeypatch.setattr(gather, "gather_rows", spy)
    monkeypatch.setattr(manager, "gather_rows", spy)
    # the engine's init and the switcher's calibration gather too: count
    # the epochs' calls alone
    epochs = factored_epochs.run_epochs

    def counted(*args, **kw):
        calls[0] = 0
        r = epochs(*args, **kw)
        r["epochs_calls"] = calls[0]
        return r

    monkeypatch.setattr(factored_epochs, "run_epochs", counted)
    ds = tsynthetic(num_node=3000, avg_degree=8, feat_dim=32, num_class=8,
                    train_frac=0.5, seed=42)
    r = factored_epochs.run_layout(name, [torch.device("cpu")] * 4, ds,
                                   epochs=2)
    assert r["k1_expected"] == r["epochs_calls"], r
    assert r["k1_launches"] == 0     # the plain version counts nothing
    assert r["losses_finite"] and not r["overflowed"]
    assert r["peak_bytes_by_card"] == {}
    if name.startswith("switcher"):
        assert ("reserve" in r) and (r["reserve"] == 0
                                     or r["tail_batches"] > 0)
