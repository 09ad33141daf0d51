"""papers100M-scale rehearsal on the card (port of
``tools/papers100m_rehearsal.py``):

    python -m fgnn_tpu_torch.tools.papers100m_rehearsal --gen-only
    python -m fgnn_tpu_torch.tools.papers100m_rehearsal [--mode hbm|cache]

Generates a papers100M-shaped synthetic graph (111,059,956 nodes, about
1.6B edges, lognormal(3) targets at skew 6; its edges fit under 2^31) with
a 1M-row mock feature table read modulo its rows (SAMGRAPH_EMPTY_FEAT,
engine.cc:138-155; the row gather reads it as GPUMockExtract does), and
runs:

  --mode hbm    arch1, graph and mock table on the card: the steady epoch
                time and sampled edges/s;
  --mode cache  arch1 with the table in host memory
                (``FGNN_TPU_FEAT_HBM_BUDGET=0``) behind a PRESAMPLE cache
                (``presample_epoch=1``): the hit rate of each epoch.

The first run saves the arrays under ``--cache-dir`` (``indptr.npy``,
``indices.npy``, ``feat.npy``, ``label.npy`` in
``n{N}_d{deg}_s{skew}_l{sigma}_seed{seed}/``, the reference's names, so one
cache serves this tool and ``fgnn_tpu_torch.exp.table1_papers100m``); later
runs mmap them and draw the split again from ``default_rng(seed + 99)``.
The default cache dir lies outside the repository, because the full-size
dataset takes gigabytes of disk: ``fgnn_tpu_torch/p100m_ds`` under the
temporary directory (``$TMPDIR``, else ``/tmp``). The first epoch is a
warm-up; the result is the median of the later ones. The run ends with
the row gather's launches (``test_result:launches:gather_rows=N``), as the
apps do. ``--check-step`` first holds one step's feature gather against its
plain version, bit for bit, at the run's own shapes (:func:`check_step`).
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

DEFAULT_CACHE_DIR = os.path.join(tempfile.gettempdir(), "fgnn_tpu_torch",
                                 "p100m_ds")
NUM_NODE = 111_059_956
NUM_CLASS = 172
NAME = "papers100m-shape"


def stamp(num_node: int, avg_degree: float = 14.5, skew: float = 6.0,
          sigma: float = 3.0, seed: int = 0) -> str:
    """The cache's directory name (tools/papers100m_rehearsal.py:81-83)."""
    return f"n{num_node}_d{int(avg_degree)}_s{skew}_l{sigma}_seed{seed}"


def load_cached(d: str, num_node: int, train_frac: float, seed: int = 0):
    """The saved arrays of ``d``, mmapped, with the split drawn again from
    ``default_rng(seed + 99)`` (:84-101)."""
    from ..data.schema import Dataset

    indptr = np.load(os.path.join(d, "indptr.npy"), mmap_mode="r")
    indices = np.load(os.path.join(d, "indices.npy"), mmap_mode="r")
    feat = np.load(os.path.join(d, "feat.npy"), mmap_mode="r")
    label = np.load(os.path.join(d, "label.npy"), mmap_mode="r")
    rng = np.random.default_rng(seed + 99)
    n_train = max(1, int(num_node * train_frac))
    ids = rng.choice(num_node, size=n_train + 2048,
                     replace=False).astype(np.int32)
    return Dataset(
        name=NAME, num_node=num_node, num_edge=int(indices.shape[0]),
        num_class=NUM_CLASS, indptr=indptr, indices=indices, feat=feat,
        label=label, train_set=ids[:n_train],
        test_set=ids[n_train:n_train + 1024], valid_set=ids[n_train + 1024:],
        empty_feat=feat.shape[0] < num_node,
    )


def engine_config(mode: str, model: str = "graphsage", fanout=(25, 10),
                  batch_size: int = 8000, cache_percentage: float = 0.15,
                  profile_level: int = 1):
    """The run's ``RunConfig`` (:128-144). Cache mode also needs the table
    in host memory, which the caller asks of the engine
    (``FGNN_TPU_FEAT_HBM_BUDGET=0`` or ``feat_budget=0``)."""
    from ..config import CachePolicy, RunConfig, SampleType

    kw = dict(model=model, fanout=tuple(fanout), batch_size=batch_size,
              num_hidden=256, sample_type=SampleType.KHOP2, dropout=0.5,
              lr=0.003)
    if mode == "hbm":
        return RunConfig(**kw, profile_level=profile_level)
    return RunConfig(**kw, cache_policy=CachePolicy.PRESAMPLE,
                     cache_percentage=cache_percentage, presample_epoch=1,
                     profile_level=max(1, profile_level))


def check_step(eng):
    """The feature gather of the first step of epoch 0 (drawn from a
    generator of its own) against its plain version, bit for bit, on the
    engine's path: with the table on the device, the row gather (the mock
    gather of an empty-feat table) against ``index_select`` of the ids
    modulo the table's rows; behind a cache, the combine against
    ``combine_reference``. Raises ``RuntimeError`` on a difference; returns
    ``(what was held, max |difference|)``."""
    import torch
    from ..cache.manager import combine_reference

    dev = eng.device
    seeds, nums = eng.shuffler.epoch_arrays(0)
    batch = eng.sample(torch.as_tensor(seeds[0], device=dev), int(nums[0]),
                       torch.Generator(dev).manual_seed(7), eng.dedup_last_hop)
    ids = batch.input_nodes
    if eng.feat_dev is not None:
        table = eng.feat_dev
        out = eng.feat_gather(table, ids)
        rows = torch.index_select(table, 0,
                                  (ids.clamp(min=0) % table.shape[0]).long())
        ref = torch.where((ids >= 0)[:, None], rows, 0)
        what = (f"{'mock ' if eng.ds.empty_feat else ''}gather over a "
                f"{list(table.shape)} {str(table.dtype)[6:]} table")
    else:
        cache = eng.cache
        index = cache.get_miss_cache_index(ids)
        rows, miss, hit = cache.upload_miss(index)
        out = cache.combine(index, rows, miss)
        ref = combine_reference(cache.cache_data, index, rows)
        what = (f"cache combine over {list(cache.cache_data.shape)} "
                f"{str(cache.cache_data.dtype)[6:]} cached rows, {hit} hits, "
                f"{miss} misses")
    if not torch.equal(out, ref):
        raise RuntimeError(f"{what}: differs from its plain version")
    err = float((out.float() - ref.float()).abs().max()) if out.numel() else 0.0
    return f"{what}, {ids.shape[0]} ids", err


def save(ds, d: str) -> None:
    os.makedirs(d, exist_ok=True)
    for name in ("indptr", "indices", "feat", "label"):
        np.save(os.path.join(d, f"{name}.npy"), getattr(ds, name))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--num-node", type=int, default=NUM_NODE)
    p.add_argument("--avg-degree", type=float, default=14.5)
    p.add_argument("--neighbor-skew", type=float, default=6.0)
    p.add_argument("--neighbor-lognormal-sigma", type=float, default=3.0)
    p.add_argument("--batch-size", type=int, default=8000)
    p.add_argument("--fanout", type=int, nargs="+", default=[25, 10])
    p.add_argument("--train-frac", type=float, default=0.01)
    p.add_argument("--num-epoch", type=int, default=3)
    p.add_argument("--mode", choices=["hbm", "cache"], default="hbm")
    p.add_argument("--cache-percentage", type=float, default=0.15)
    p.add_argument("--model", default="graphsage")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile-level", type=int, default=1,
                   help="2 and above sync after each stage of a step")
    p.add_argument("--cache-dir", default=DEFAULT_CACHE_DIR,
                   help="the full-size build takes minutes on the host: the "
                        "arrays are saved once and mmapped on later runs "
                        "(the train split is drawn per --train-frac); an "
                        "empty value saves nothing")
    p.add_argument("--check-step", action="store_true",
                   help="first hold one step's feature gather against its "
                        "plain version, bit for bit")
    p.add_argument("--gen-only", action="store_true",
                   help="generate and save the dataset, then exit (host "
                        "work only, no card needed)")
    args = p.parse_args(argv)

    import torch

    if (not args.gen_only and torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        print("papers100m_rehearsal: no CUDA device (torch.cuda.is_available() "
              "is False); pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 1

    from ..data import make_synthetic_dataset
    from ..engine import OneChipEngine
    from ..ops import cuda_lib
    from ..utils.profiler import Profiler

    t0 = time.perf_counter()
    cd = args.cache_dir
    d = os.path.join(cd, stamp(args.num_node, args.avg_degree,
                               args.neighbor_skew,
                               args.neighbor_lognormal_sigma, args.seed))
    if cd and os.path.exists(os.path.join(d, "indices.npy")):
        ds = load_cached(d, args.num_node, args.train_frac, args.seed)
        print(f"[gen] loaded {d} ({ds.num_edge} edges) "
              f"in {time.perf_counter() - t0:.1f}s", flush=True)
    else:
        ds = make_synthetic_dataset(
            num_node=args.num_node, avg_degree=int(args.avg_degree),
            feat_dim=128, num_class=NUM_CLASS, train_frac=args.train_frac,
            seed=args.seed, neighbor_skew=args.neighbor_skew,
            neighbor_lognormal_sigma=args.neighbor_lognormal_sigma,
            empty_feat_rows=1 << 20, name=NAME,
        )
        print(f"[gen] {ds.num_node} nodes / {ds.num_edge} edges "
              f"({ds.num_edge * 4 / 2**30:.1f} GB indices) "
              f"in {time.perf_counter() - t0:.1f}s", flush=True)
        if cd:
            save(ds, d)
            print(f"[gen] saved to {d}", flush=True)
    if ds.num_edge >= 2**31:
        raise ValueError(f"{ds.num_edge} edges: over the int32 indptr bound")
    if args.gen_only:
        print("[gen] --gen-only: dataset ready, exiting", flush=True)
        return 0

    cfg = engine_config(args.mode, args.model, args.fanout, args.batch_size,
                        args.cache_percentage, args.profile_level)
    if args.mode == "cache":
        os.environ["FGNN_TPU_FEAT_HBM_BUDGET"] = "0"

    Profiler.reset()
    t0 = time.perf_counter()
    eng = OneChipEngine(cfg, ds, args.device)
    print(f"[init] engine up in {time.perf_counter() - t0:.1f}s "
          f"(incl. device transfer"
          f"{' + presample' if args.mode == 'cache' else ''})", flush=True)
    if args.check_step:
        what, err = check_step(eng)
        print(f"[check] {what}: bit-equal to its plain version "
              f"(max |diff| {err})", flush=True)

    times = []
    for e in range(args.num_epoch):
        r = eng.run_epoch(e)
        print(f"[epoch {e}] {r}", flush=True)
        if e > 0:
            times.append(r["epoch_time"])
        if args.mode == "cache":
            prof = Profiler.get()
            miss = prof.get_epoch_value(e, "epoch_miss_bytes")
            tot = prof.get_epoch_value(e, "epoch_feature_bytes")
            if tot:
                print(f"[epoch {e}] cache hit rate "
                      f"{100 * (1 - miss / tot):.1f}% "
                      f"({miss / 2**20:.0f} / {tot / 2**20:.0f} MB)",
                      flush=True)
    if times:
        med = float(np.median(times))
        edges = r.get("sampled_edges", 0)
        print(f"[result] median steady epoch {med:.2f}s"
              + (f", {edges / med / 1e6:.1f}M sampled edges/s" if edges
                 else ""), flush=True)
    cuda_lib.log_launches()
    return 0


if __name__ == "__main__":
    sys.exit(main())
