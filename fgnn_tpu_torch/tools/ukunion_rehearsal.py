"""uk-union-scale rehearsal over a CSR of more than 2^31 edges (port of
``tools/ukunion_rehearsal.py``):

    python -m fgnn_tpu_torch.tools.ukunion_rehearsal --gen-only   # host only
    python -m fgnn_tpu_torch.tools.ukunion_rehearsal [--device cuda]

The source system ships uk-2006-05 (77M nodes, 2.9B edges) and a 32-to-64
converter, because a CSR of more than 2^31 edges needs a 64-bit indptr.
``generate`` writes a uk-shaped synthetic graph of that size to ``--dir``:
lognormal degrees scaled to 2.3B edges, an int64 ``indptr.npy``, an int32
``indices.npy`` written through a memmap in chunks of 64M edges, and a
``DONE`` sentinel. ``run_epoch`` then trains arch0 GraphSAGE [25, 10] over
it: the port's OpenMP host samplers walk the 64-bit CSR, which stays a
memmap on disk (``HostSamplingEngine`` reads it in place), and the card
trains, features from a 1M-row mock table. The default ``--dir`` lies
outside the repository, because the indices take gigabytes of disk:
``fgnn_tpu_torch/ukunion_ds`` under the temporary directory (``$TMPDIR``,
else ``/tmp``). The epochs end with the row gather's launches
(``test_result:launches:gather_rows=N``), as the apps do.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

DEFAULT_DIR = os.path.join(tempfile.gettempdir(), "fgnn_tpu_torch",
                           "ukunion_ds")
NUM_NODE = 77_000_000
TARGET_EDGES = 2_300_000_000      # > 2^31 = 2_147_483_648
CHUNK = 64_000_000
FEAT_ROWS = 1_000_000


def generate(out_dir: str, seed: int = 0, num_node: int = NUM_NODE,
             target_edges: int = TARGET_EDGES, chunk: int = CHUNK) -> int:
    """Disk-backed synthetic at uk-union shape (lognormal degrees scaled to
    ``target_edges``, int64 indptr, chunked uniform int32 indices); the
    files of tools/ukunion_rehearsal.py:31-64, byte for byte. Returns the
    edge count (read from ``DONE`` where the graph is already there)."""
    os.makedirs(out_dir, exist_ok=True)
    done = os.path.join(out_dir, "DONE")
    if os.path.exists(done):
        print(f"# dataset already generated at {out_dir}")
        with open(done) as f:
            return int(f.read().split()[1])
    t0 = time.time()
    rng = np.random.default_rng(seed)
    deg = rng.lognormal(mean=3.0, sigma=1.0, size=num_node)
    deg = np.maximum((deg * (target_edges / deg.sum())).astype(np.int64), 1)
    indptr = np.zeros(num_node + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    num_edge = int(indptr[-1])
    np.save(os.path.join(out_dir, "indptr.npy"), indptr)
    print(f"# indptr: {num_edge} edges ({time.time()-t0:.0f}s)", flush=True)

    idx_path = os.path.join(out_dir, "indices.npy")
    indices = np.lib.format.open_memmap(
        idx_path, mode="w+", dtype=np.int32, shape=(num_edge,)
    )
    for lo in range(0, num_edge, chunk):
        hi = min(lo + chunk, num_edge)
        indices[lo:hi] = rng.integers(0, num_node, hi - lo, dtype=np.int32)
        if (lo // chunk) % 8 == 0:
            print(f"# indices {hi/num_edge:.0%} ({time.time()-t0:.0f}s)",
                  flush=True)
    indices.flush()
    del indices
    with open(done, "w") as f:
        f.write(f"{num_node} {num_edge}\n")
    print(f"# generated {num_edge} edges in {time.time()-t0:.0f}s "
          f"({os.path.getsize(idx_path)/1e9:.1f} GB)", flush=True)
    return num_edge


def run_epoch(out_dir: str, batch_size: int, train_n: int, num_epoch: int,
              device="cuda", num_node: int = NUM_NODE,
              feat_rows: int = FEAT_ROWS) -> list:
    """``num_epoch`` arch0 epochs over the graph in ``out_dir``
    (tools/ukunion_rehearsal.py:67-113); returns their dicts."""
    from ..config import RunArch, RunConfig, SampleType
    from ..data.schema import Dataset
    from ..host_engine import HostSamplingEngine
    from ..ops import cuda_lib

    indptr = np.load(os.path.join(out_dir, "indptr.npy"))
    indices = np.load(os.path.join(out_dir, "indices.npy"), mmap_mode="r")
    if indptr.dtype != np.int64:
        raise ValueError(f"indptr is {indptr.dtype}, not int64")
    rng = np.random.default_rng(7)
    ids = rng.choice(num_node, size=train_n + 2048,
                     replace=False).astype(np.int32)
    feat = rng.standard_normal((feat_rows, 128)).astype(np.float32)
    label = rng.integers(0, 64, num_node, dtype=np.int32)
    ds = Dataset(
        name="ukunion-shape", num_node=num_node,
        num_edge=int(indptr[-1]), num_class=64,
        indptr=indptr, indices=indices, feat=feat, label=label,
        train_set=ids[:train_n], test_set=ids[train_n:train_n + 1024],
        valid_set=ids[train_n + 1024:], empty_feat=True,
    )
    cfg = RunConfig(
        model="graphsage", arch=RunArch.ARCH0, fanout=(25, 10),
        batch_size=batch_size, num_hidden=256,
        sample_type=SampleType.KHOP2, dropout=0.5, lr=0.003,
    )
    t0 = time.time()
    eng = HostSamplingEngine(cfg, ds, device)
    print(f"# engine init: {time.time()-t0:.1f}s (plan {eng.plan})",
          flush=True)
    out = []
    for e in range(num_epoch):
        r = eng.run_epoch(e)
        out.append(r)
        print(f"test_result:epoch{e}_time={r['epoch_time']:.3f}")
        print(f"test_result:epoch{e}_loss={r['loss']:.4f}")
        print(f"# epoch {e}: {r['epoch_time']:.2f}s loss={r['loss']:.3f} "
              f"steps={r['num_step']} edges={r.get('sampled_edges')}",
              flush=True)
    print(f"test_result:num_edge={int(indptr[-1])}")
    cuda_lib.log_launches()
    print(f"# uk-union rehearsal OK: {int(indptr[-1])} edges sampled on the "
          f"host (int64 indptr), trained on {device}", flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--dir", default=DEFAULT_DIR)
    p.add_argument("--gen-only", action="store_true")
    p.add_argument("--batch-size", type=int, default=8000)
    p.add_argument("--train-n", type=int, default=80_000)
    p.add_argument("--num-epoch", type=int, default=2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if not args.gen_only:
        import torch

        if (torch.device(args.device).type == "cuda"
                and not torch.cuda.is_available()):
            print("ukunion_rehearsal: no CUDA device "
                  "(torch.cuda.is_available() is False); pass --device cpu "
                  "to run on the CPU", file=sys.stderr)
            return 1
    num_edge = generate(args.dir)
    if num_edge <= 2**31:
        raise ValueError(f"{num_edge} edges: not over 2^31")
    if not args.gen_only:
        run_epoch(args.dir, args.batch_size, args.train_n, args.num_epoch,
                  args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
