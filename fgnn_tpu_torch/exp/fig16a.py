"""Figure 16a, test accuracy against training time, run to a plateau (port
of ``exp/fig16a/run.py``):

    python -m fgnn_tpu_torch.exp.fig16a [--archs arch1 arch5 arch6 arch5_async]

The source paper's exp/fig16a: accuracy-over-time curves showing that
FGNN's speed turns into faster convergence. The engines are built here, as
the reference builds them (:28-58): arch1 (``OneChipEngine``), arch5 2S+6T
(``FactoredEngine``), arch6 over 8 workers (``SGNNEngine``) and arch5 with
async trainers (``AsyncFactoredEngine``), GraphSAGE (10, 10), batch 1000,
on a 100,000-node synthetic graph. Each trains until the best accuracy has
not risen by ``--tol`` in ``--patience`` evaluations, evaluating after each
epoch; the check the result carries is that every mode reaches the same
plateau within ``--band``. Role devices repeat the machine's cards
(``--devices``). ``fig16a.json`` and ``fig16a.dat`` (the card and host in
their header) go to ``--out-dir``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .runner import card_meta, worker_devices

# role devices of the multi-device modes (the reference's 8-device mesh)
NUM_DEVICES = 8


def engine_config(arch: str, num_epoch: int):
    """The reference's configuration of ``arch`` and how many role devices
    its engine takes."""
    from ..config import RunArch, RunConfig, SampleType

    base = dict(model="graphsage", fanout=(10, 10), batch_size=1000,
                sample_type=SampleType.KHOP0, dropout=0.5, lr=0.003,
                num_epoch=num_epoch)
    if arch == "arch1":
        return RunConfig(arch=RunArch.ARCH1, **base), 1
    if arch in ("arch5", "arch5_async"):
        return RunConfig(arch=RunArch.ARCH5, num_sample_worker=2,
                         num_train_worker=6,
                         async_train=(arch == "arch5_async"), **base), 8
    if arch == "arch6":
        return RunConfig(arch=RunArch.ARCH6, num_train_worker=8, **base), 8
    raise ValueError(arch)


def build_engine(arch: str, ds, num_epoch: int, device: str,
                 devices=None):
    """``(cfg, engine)`` of ``arch`` on ``device`` (one role) or on the
    role devices ``worker_devices`` gives."""
    cfg, n = engine_config(arch, num_epoch)
    if arch == "arch1":
        from ..engine import OneChipEngine

        return cfg, OneChipEngine(cfg, ds, device)
    devs = worker_devices(device, devices, n).split(",")
    if arch == "arch5_async":
        from ..parallel.async_dp import AsyncFactoredEngine

        return cfg, AsyncFactoredEngine(cfg, ds, devs)
    if arch == "arch5":
        from ..parallel.factored import FactoredEngine

        return cfg, FactoredEngine(cfg, ds, devs)
    from ..parallel.factored import SGNNEngine

    return cfg, SGNNEngine(cfg, ds, devs)


def rows(args):
    """``(arch, configuration, role devices)`` of each curve."""
    return [(arch, *engine_config(arch, args.max_epoch))
            for arch in args.archs]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--devices", default=None,
                   help="the cards the multi-device modes take in turn "
                        "(default: all)")
    p.add_argument("--synthetic-nodes", type=int, default=100_000)
    p.add_argument("--max-epoch", type=int, default=40)
    p.add_argument("--patience", type=int, default=5,
                   help="stop when best acc hasn't improved by --tol in "
                        "this many consecutive evals")
    p.add_argument("--tol", type=float, default=0.003)
    p.add_argument("--band", type=float, default=0.05,
                   help="plateau-agreement band across archs")
    p.add_argument("--archs", nargs="+",
                   default=["arch1", "arch5", "arch6", "arch5_async"])
    p.add_argument("--out-dir", default=os.path.join("chiprun_out", "fig16a"))
    args = p.parse_args(argv)

    from ..data import make_synthetic_dataset

    ds = make_synthetic_dataset(num_node=args.synthetic_nodes, avg_degree=15,
                                feat_dim=64, num_class=32, seed=0)
    curves, plateaus = {}, {}
    for arch, _, _ in rows(args):
        _, eng = build_engine(arch, ds, args.max_epoch, args.device,
                              args.devices)
        curve = []
        best, best_epoch, stall = 0.0, -1, 0
        t0 = time.time()
        for e in range(args.max_epoch):
            eng.run_epoch(e)
            acc = eng.evaluate()
            elapsed = time.time() - t0
            curve.append({"time_s": elapsed, "epoch": e, "test_acc": acc})
            print(f"test_result:acc_curve:{arch}:{elapsed:.2f}={acc:.4f}",
                  flush=True)
            if acc > best + args.tol:
                best, best_epoch, stall = acc, e, 0
            else:
                stall += 1
            if stall >= args.patience:
                break
        curves[arch] = curve
        plateaus[arch] = {
            "plateau_acc": best,
            "plateau_epoch": best_epoch,
            "time_to_plateau_s": curve[best_epoch]["time_s"],
            "epochs_run": len(curve),
            "flattened": stall >= args.patience,
        }
        print(f"test_result:plateau:{arch}:acc={best:.4f} "
              f"epoch={best_epoch} t={curve[best_epoch]['time_s']:.1f}s "
              f"flattened={plateaus[arch]['flattened']}", flush=True)
        del eng

    accs = [v["plateau_acc"] for v in plateaus.values()]
    agree = (max(accs) - min(accs)) <= args.band if len(accs) > 1 else True
    print(f"test_result:plateau_agreement:spread={max(accs) - min(accs):.4f} "
          f"band={args.band} agree={agree}", flush=True)

    meta = card_meta()
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "fig16a.json"), "w") as f:
        json.dump({"meta": meta, "curves": curves, "plateaus": plateaus,
                   "plateau_agreement": agree}, f, indent=2)
    with open(os.path.join(args.out_dir, "fig16a.dat"), "w") as f:
        for k, v in meta.items():
            f.write(f"# {k}={v}\n")
        f.write(f"{'arch':<14}{'plateau_acc':>12}{'plateau_epoch':>14}"
                f"{'time_to_plateau_s':>19}{'epochs_run':>11}"
                f"{'flattened':>10}\n")
        for a, v in plateaus.items():
            f.write(f"{a:<14}{v['plateau_acc']:>12.4f}"
                    f"{v['plateau_epoch']:>14d}"
                    f"{v['time_to_plateau_s']:>19.1f}"
                    f"{v['epochs_run']:>11d}"
                    f"{str(v['flattened']):>10}\n")
    print(f"[exp] wrote fig16a.json + fig16a.dat (agreement={agree})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
