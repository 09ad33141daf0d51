"""The benchmark's cells in pairs of two checkouts on one card.

    python -m fgnn_tpu_torch.tools.bench_pairs --other DIR --cells gcn_hbm_syn1M --pairs 10

Runs each cell's timed process (``python -m bench_torch.run --cell <cell>
--seed <seed> --phase timed``: the end-to-end metrics and the step check)
in ``--other``, another checkout of the repository (the parent commit,
unpacked with ``git archive``), and in this one, ``--pairs`` times each,
in turns: ``--other`` first in even pairs, this checkout first in odd ones.
Each run's output goes to ``chiprun_out/bench_pairs/``. Prints every run's
metrics; then, per cell, each side's median and quartiles of every metric,
and the pairs this checkout won on ``epoch_time`` (lower wins, a tie counts
for neither) beside the distance between the other side's quartiles.
Writes ``pairs_<cells>_s<seed>.json`` there. Exits 1 without a card or if
a run fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from bench_torch import cells, measure, spread

THIS = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SIDES = ("other", "this")
OUT_DIR = os.path.join(THIS, "chiprun_out", "bench_pairs")


def _env(root: str) -> dict:
    """``bench_torch.run.child_env`` for the checkout at ``root``."""
    env = dict(os.environ, PYTHONPATH=root, PYTHONPYCACHEPREFIX=os.path.join(
        root, "fgnn_tpu_torch", "_build", "pycache"))
    env.pop("PYTHONDONTWRITEBYTECODE", None)
    return env


def timed(root: str, cell: str, seed: int, log: str, bench: dict) -> dict:
    """One timed run of ``cell`` in the checkout at ``root``; its metrics,
    step check and epoch walls (``bench_torch.spread.timed_record``)."""
    with open(log, "w") as f:
        rc = subprocess.run(
            [sys.executable, "-m", "bench_torch.run", "--cell", cell,
             "--seed", str(seed), "--phase", "timed"], cwd=root,
            env=_env(root), stdout=f, stderr=subprocess.STDOUT).returncode
    with open(log) as f:
        lines = f.read().splitlines()
    if rc != 0:
        print("\n".join(lines[-40:]))
        raise RuntimeError(f"{cell} in {root}: rc {rc} (log {log})")
    return spread.timed_record(lines, cell, bench)


def summary(runs: dict) -> dict:
    """Per side and metric the quartiles; the pairs this side won on
    ``epoch_time``."""
    out = {side: {m: measure.quartiles([r["metrics"][m] for r in runs[side]])
                  for m in runs[side][0]["metrics"]} for side in SIDES}
    pairs = list(zip(*(
        [r["metrics"]["epoch_time"] for r in runs[side]] for side in SIDES)))
    other = out["other"]["epoch_time"]
    out["epoch_time"] = {
        "pairs": len(pairs), "this_won": sum(t < o for o, t in pairs),
        "ties": sum(t == o for o, t in pairs),
        "other_quartile_distance": other["q3"] - other["q1"],
        "median_difference":
            other["median"] - out["this"]["epoch_time"]["median"]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("bench_pairs")
    p.add_argument("--other", required=True,
                   help="the root of the checkout to compare with")
    p.add_argument("--cells", nargs="+", required=True)
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_pairs: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(OUT_DIR, exist_ok=True)
    roots = {"other": os.path.abspath(args.other), "this": THIS}
    bench = cells.load_benchmark()
    result = {"roots": roots, "seed": args.seed}
    for cell in args.cells:
        runs = {side: [] for side in SIDES}
        for i in range(args.pairs):
            for side in (SIDES if i % 2 == 0 else SIDES[::-1]):
                log = os.path.join(OUT_DIR,
                                   f"{cell}_s{args.seed}_{side}{i}.log")
                t0 = time.perf_counter()
                try:
                    r = timed(roots[side], cell, args.seed, log, bench)
                except RuntimeError as e:
                    print(f"bench_pairs: {e}", file=sys.stderr)
                    return 1
                runs[side].append(r)
                print(f"{cell} pair {i} {side}: "
                      f"{time.perf_counter() - t0:.1f} s, "
                      + ", ".join(f"{k} {v:.6g}"
                                  for k, v in r["metrics"].items()),
                      flush=True)
        s = summary(runs)
        result[cell] = {"runs": runs, "summary": s}
        for side in SIDES:
            for m, q in s[side].items():
                print(f"{cell} {side} {m}: median {q['median']:.6g} "
                      f"[{q['q1']:.6g}, {q['q3']:.6g}]", flush=True)
        e = s["epoch_time"]
        print(f"{cell} epoch_time: this won {e['this_won']} of {e['pairs']} "
              f"pairs ({e['ties']} ties); medians differ by "
              f"{e['median_difference']:.6g} s, the other side's quartiles "
              f"by {e['other_quartile_distance']:.6g} s", flush=True)
    name = "_".join(args.cells)
    with open(os.path.join(OUT_DIR, f"pairs_{name}_s{args.seed}.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
