"""The multi-device gates of the JAX package's entry point
(``dryrun_multichip``, ``__graft_entry__.py:97-264``) on the port.

    python -m fgnn_tpu_torch.tools.multichip --devices cuda:0,cuda:1,cuda:2,cuda:3

On n role devices (a device may repeat; one device alone stands for four
roles on it, the four-card host's layout), on the reference's tiny input
(800 nodes, degree 6, 16-dim features, 4 classes, seed 3; GraphSAGE,
batch 32, fanout (3, 3), hidden 32, KHOP0, dropout 0):

  a  arch5 with S = max(1, n // 4) samplers and T = n - S trainers over
     the n devices, against the same run on the reversed placement; then
     the same comparison in float32 compute, where the order of the
     trainers' gradient fold shows (in bfloat16 a few gradients' sum in
     float32 is exact in any order);
  b  arch5 S=1, T=1 on the first two devices, against both roles on the
     first; with three or more devices, also (a)'s layout against every
     role on the first device (the trainers' gradients summed across
     cards against on one); each comparison again at dropout 0.5, so the
     dropout generators must not follow the placement either;
  c  arch6 (``SGNNEngine``) with W = n workers: a finite loss;
  d  no epoch of (a) or (c) overflowed its caps;
  e  (a)'s epoch-0 loss within 5% of (c)'s;
  f  arch5 cache mode (PRESAMPLE 25%, the table in host memory behind the
     trainer's cache, S=1, T=1) on the first two devices, against one;
  g  PinSAGE's random walk through arch5 (S=1, T=1) the same way;
  h  the switcher (S=1, T=1) with its tail forced
     (``FGNN_TPU_SWITCHER_FORCE=1``) on the first two devices, against the
     reversed two: the reserve is calibrated once, on the first engine,
     and set on both.

The comparisons (a, b, f, g, h) run two epochs each and hold the losses
and the parameters equal bit for bit; the process runs under
deterministic algorithms (the gradients' scatter-adds use atomics
otherwise), with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``. Where the devices are
cards and fewer than two cards are given, (a) and (b), whose claim is that
placement does not matter, are refused by name; (a)'s own run still feeds
(d) and (e), and (f)-(h) compare two runs on the one card. On the CPU
every gate runs (the placements then differ only in name).

Prints one line a gate (its loss, bit-equality, overflow and seconds) and,
as its last line, one JSON object with the card's name and power limit.
Exits 1 when a gate fails or a card is asked for and there is none, 2 on
bad arguments.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
from typing import Callable, List, Optional, Sequence

import torch

from ..config import env_set
from .factored_epochs import train_epochs

# the reference's tiny input (__graft_entry__.py:31-55)
TINY_DATASET = dict(num_node=800, avg_degree=6, feat_dim=16, num_class=4,
                    seed=3)
GATES = "abcdefgh"
# epochs each comparison runs: a second one refreshes every replica from
# a stepped model, so a trainer left behind shows
EPOCHS = 2
LOSS_AGREEMENT = 0.05
# one device alone stands for this many roles on it
ONE_CARD_ROLES = 4
# (b)'s second comparison: the dropout the port's main path trains with
DROPOUT = 0.5


def tiny_setup():
    """The reference's configuration and dataset, from the port's own
    generator."""
    from ..config import RunConfig, SampleType
    from ..data import make_synthetic_dataset

    cfg = RunConfig(model="graphsage", fanout=(3, 3), batch_size=32,
                    num_hidden=32, sample_type=SampleType.KHOP0, dropout=0.0)
    return cfg, make_synthetic_dataset(**TINY_DATASET)


@dataclasses.dataclass
class Gate:
    """One gate's outcome: ``ok`` None when it was refused."""
    name: str
    title: str
    ok: Optional[bool] = None
    loss: Optional[float] = None
    bit_equal: Optional[bool] = None
    overflow: Optional[bool] = None
    seconds: float = 0.0
    detail: str = ""

    def line(self) -> str:
        state = {True: "ok", False: "FAILED", None: "refused"}[self.ok]
        parts = [f"gate {self.name} ({self.title}): {state}"]
        if self.loss is not None:
            parts.append(f"loss {self.loss!r}")
        if self.bit_equal is not None:
            parts.append(f"bit-equal {self.bit_equal}")
        if self.overflow is not None:
            parts.append(f"overflow {self.overflow}")
        parts.append(f"{self.seconds:.2f} s")
        if self.detail:
            parts.append(self.detail)
        return ", ".join(parts)


@dataclasses.dataclass
class Run:
    """An engine after its epochs: their losses, whether any overflowed,
    and the parameters on the host."""
    engine: object
    losses: List[float]
    overflowed: bool
    params: List[torch.Tensor]


def run_epochs(engine, epochs: int = EPOCHS) -> Run:
    out, overflowed = train_epochs(engine, range(epochs))
    return Run(engine, [r["loss"] for r in out], overflowed,
               [p.detach().cpu() for p in engine.model.parameters()])


def bit_equal(a: Run, b: Run) -> bool:
    return a.losses == b.losses and len(a.params) == len(b.params) and all(
        torch.equal(p, q) for p, q in zip(a.params, b.params))


def finite(losses: Sequence[float]) -> bool:
    return all(math.isfinite(x) for x in losses)


def losses_agree(factored: float, sgnn: float) -> float:
    """(e)'s relative difference of the two epoch-0 losses."""
    return abs(factored - sgnn) / max(abs(sgnn), 1e-9)


def cards(devices: Sequence) -> int:
    """The distinct cards among ``devices``, 0 where none is a card."""
    return len({(d.index or 0) for d in map(torch.device, devices)
                if d.type == "cuda"})


def one_card(devices: Sequence) -> bool:
    """Cards that are fewer than two cards: (a) and (b) are refused."""
    devs = [torch.device(d) for d in devices]
    return all(d.type == "cuda" for d in devs) and cards(devs) < 2


def layout(devices: Sequence) -> List[torch.device]:
    """The role devices: ``devices``, or four roles on a lone device."""
    devs = [torch.device(d) for d in devices]
    return devs * ONE_CARD_ROLES if len(devs) == 1 else devs


@contextlib.contextmanager
def deterministic_algorithms():
    """Deterministic algorithms (and cuBLAS's fixed workspace, which they
    need) for the block, the previous setting back after it."""
    before = torch.are_deterministic_algorithms_enabled()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


def run_gates(devices: Sequence, only: str = GATES,
              plant: Optional[Callable[[object], None]] = None,
              emit: Callable[[str], None] = print) -> List[Gate]:
    """The gates named in ``only`` on ``devices`` (see the module
    docstring), each printed through ``emit`` as it ends. ``plant(engine)``
    is applied to the first engine of each comparison (the one on the
    devices given; (a)'s run for (d) and (e)) before it runs: the tests
    plant faults through it, which the gates must catch."""
    from ..config import SampleType
    from ..parallel.factored import FactoredEngine, SGNNEngine
    from ..parallel.switcher import SwitcherEngine

    devs = layout(devices)
    n = len(devs)
    if n < 2:
        raise ValueError("the gates need two role devices")
    refuse = one_card(devs)
    cfg, ds = tiny_setup()
    S = max(1, n // 4)
    cfg_a = cfg.replace(num_sample_worker=S, num_train_worker=n - S)
    cfg_11 = cfg.replace(num_sample_worker=1, num_train_worker=1)
    pair, one = devs[:2], [devs[0], devs[0]]
    gates: List[Gate] = []
    runs = {}

    def engine(cls, c, where, first=False, **kw):
        eng = cls(c, ds, list(where), **kw)
        if first and plant is not None:
            plant(eng)
        return eng

    def compare(gate: Gate, make_a, make_b, what: str = "") -> Run:
        """One comparison of ``gate``'s, folded into it: every one must
        hold; the first one's loss is the gate's."""
        a, b = run_epochs(make_a()), run_epochs(make_b())
        eq = bit_equal(a, b)
        gate.bit_equal = eq and gate.bit_equal is not False
        gate.ok = eq and finite(a.losses) and gate.ok is not False
        gate.overflow = bool(gate.overflow) or a.overflowed or b.overflowed
        if gate.loss is None:
            gate.loss = a.losses[0]
        if not eq:
            gate.detail = (gate.detail + "; " if gate.detail else "") + (
                f"{what}losses {a.losses} against {b.losses}")
        return a

    def done(gate: Gate, t0: float) -> None:
        gate.seconds = time.perf_counter() - t0
        gates.append(gate)
        emit(gate.line())

    def factored_run() -> Run:
        if "a" not in runs:
            runs["a"] = run_epochs(engine(FactoredEngine, cfg_a, devs,
                                          first=True))
        return runs["a"]

    for name in only:
        t0 = time.perf_counter()
        if name == "a":
            g = Gate("a", f"arch5 S={S} T={n - S} on {names(devs)}, "
                          "against the reversed placement")
            if refuse:
                g.detail = "refused: the placement gates need two cards"
                factored_run()
            else:
                runs["a"] = compare(
                    g, lambda: engine(FactoredEngine, cfg_a, devs, True),
                    lambda: engine(FactoredEngine, cfg_a, devs[::-1]))
                c32 = cfg_a.replace(compute_dtype="float32")
                compare(g, lambda: engine(FactoredEngine, c32, devs, True),
                        lambda: engine(FactoredEngine, c32, devs[::-1]),
                        "float32: ")
        elif name == "b":
            g = Gate("b", f"arch5 S=1 T=1 on {names(pair)}, against "
                          f"{names(one)}" + (
                              f"; S={S} T={n - S} against {names(devs[:1])} "
                              "alone" if n > 2 else "")
                     + f"; each at dropout 0 and {DROPOUT}")
            if refuse:
                g.detail = "refused: the placement gates need two cards"
            else:
                for p in (0.0, DROPOUT):
                    c11, ca = (cfg_11.replace(dropout=p),
                               cfg_a.replace(dropout=p))
                    what = f"dropout {p}: " if p else ""
                    compare(g, lambda: engine(FactoredEngine, c11, pair, True),
                            lambda: engine(FactoredEngine, c11, one), what)
                    if n > 2:
                        compare(g, lambda: engine(FactoredEngine, ca, devs,
                                                  True),
                                lambda: engine(FactoredEngine, ca,
                                               devs[:1] * n),
                                f"{what}S={S} T={n - S}: ")
        elif name == "c":
            g = Gate("c", f"arch6 W={n} on {names(devs)}")
            runs["c"] = run_epochs(engine(
                SGNNEngine, cfg.replace(num_train_worker=n), devs, True), 1)
            g.loss = runs["c"].losses[0]
            g.overflow = runs["c"].overflowed
            g.ok = finite(runs["c"].losses)
        elif name == "d":
            g = Gate("d", "no epoch of (a) or (c) overflowed its caps")
            flags = [factored_run().overflowed]
            if "c" in runs:
                flags.append(runs["c"].overflowed)
            g.overflow = any(flags)
            g.ok = not g.overflow
        elif name == "e":
            g = Gate("e", f"(a)'s loss within {LOSS_AGREEMENT:.0%} of (c)'s")
            fac = factored_run().losses[0]
            if "c" not in runs:
                runs["c"] = run_epochs(engine(
                    SGNNEngine, cfg.replace(num_train_worker=n), devs), 1)
            sg = runs["c"].losses[0]
            rel = losses_agree(fac, sg)
            g.loss = fac
            g.ok = rel < LOSS_AGREEMENT
            g.detail = f"arch6 loss {sg!r}, relative difference {rel:.4%}"
        elif name == "f":
            g = Gate("f", f"arch5 cache mode (PRESAMPLE 25%) on "
                          f"{names(pair)}, against {names(one)}")
            c = cfg_11.replace(cache_percentage=0.25)
            a = compare(g, lambda: engine(FactoredEngine, c, pair, True,
                                          feat_on_trainer=False),
                        lambda: engine(FactoredEngine, c, one,
                                       feat_on_trainer=False))
            eng = a.engine
            cached = eng.cache is not None and not eng.feat_on_trainer
            g.ok = g.ok and cached
            if not cached:
                g.detail = "the run kept no cache"
        elif name == "g":
            g = Gate("g", f"PinSAGE random walk through arch5 on "
                          f"{names(pair)}, against {names(one)}")
            c = cfg_11.replace(
                model="pinsage", sample_type=SampleType.RANDOM_WALK,
                num_layer_rw=2, num_random_walk=3, random_walk_length=2,
                num_neighbor=3)
            compare(g, lambda: engine(FactoredEngine, c, pair, True),
                    lambda: engine(FactoredEngine, c, one))
        elif name == "h":
            g = Gate("h", f"the switcher's forced tail on {names(pair)}, "
                          f"against {names(pair[::-1])}")
            with env_set({"FGNN_TPU_SWITCHER_FORCE": "1"}):
                first = engine(SwitcherEngine, cfg_11, pair, True)
                reserve = first._calibrate_tail_reserve()
                second = engine(SwitcherEngine, cfg_11, pair[::-1])
                first._tail_reserve_batches = reserve
                second._tail_reserve_batches = reserve
                a = compare(g, lambda: first, lambda: second)
            tail = getattr(a.engine, "tail_batches", 0)
            g.ok = g.ok and reserve > 0 and tail > 0
            g.detail = (f"reserve {reserve} of {a.engine.num_step} batches, "
                        f"tail {tail}; " + g.detail).rstrip("; ")
        else:
            raise ValueError(f"no gate {name!r}")
        done(g, t0)
    return gates


def names(devices: Sequence) -> str:
    return "[" + ", ".join(str(torch.device(d)) for d in devices) + "]"


def main(argv=None) -> int:
    p = argparse.ArgumentParser("multichip")
    p.add_argument("--devices", required=True,
                   help="role devices, comma-separated (a device may repeat; "
                        "one device alone holds four roles)")
    args = p.parse_args(argv)
    devices = [d for d in args.devices.split(",") if d]
    if not devices:
        p.print_usage(sys.stderr)
        return 2
    if any(torch.device(d).type == "cuda" for d in devices) and (
            not torch.cuda.is_available()):
        print("multichip: no CUDA device", file=sys.stderr)
        return 1
    from ..exp.runner import card_meta

    t0 = time.perf_counter()
    with deterministic_algorithms():
        gates = run_gates(devices)
    devs = layout(devices)
    ok = all(g.ok is not False for g in gates)
    print(json.dumps({
        "card": card_meta()["card"], "devices": [str(d) for d in devs],
        "cards": cards(devs), "samplers": max(1, len(devs) // 4),
        "trainers": len(devs) - max(1, len(devs) // 4),
        "gates": [dataclasses.asdict(g) for g in gates],
        "seconds": time.perf_counter() - t0, "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
