"""Bandwidth toolkit (port of ``tools/bandwidth_bench.py``; the source
system's utility/data-process/toolkit/bandwidth/{memcpy_test.cc,
mem_bandwidth.cc}): the memory paths a host-table epoch uses,

    host gather     random feature rows on the host: NumPy fancy-indexing
                    and the port's ``ops/extract.py::host_gather`` (the
                    Extract stage of a host-resident table)
    host memcpy     a straight ``np.copyto`` of the table
    H2D             host rows to the card, from pageable and from pinned
                    memory, on a copy stream as ``HostFeatures`` uploads
    device gather   the row gather on the card: K1
                    (``ops/gather.py::gather_rows``) beside
                    ``torch.index_select`` over the same rows, each with
                    its GB/s and K1's bound (bytes moved / 3.35 TB/s)

    python -m fgnn_tpu_torch.tools.bandwidth_bench [--rows N] [--gather M]
        [--dim D] [--device cuda|cpu]

Host times are the best of five on the host clock; H2D times the best of
five CUDA-event spans on the copy stream; device gathers the median CUDA-
event time of ``gather_campaign.median_ms`` (device time). GB are 10^9
bytes. ``--device cpu`` runs the host lines only. A CUDA device that is
missing fails the run; nothing falls back to the CPU. K1's output is
checked bit for bit against its plain version before it is timed.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

# the H100 SXM data sheet's memory rate (700 W), as PERF.md reckons K1's
# bound
HBM_BYTES_PER_S = 3.35e12


def best_s(fn, reps=5):
    fn()
    best = float("inf")
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t)
    return best


def host_lines(feat: np.ndarray, ids: np.ndarray) -> dict:
    """Host gather (NumPy and the port's ``host_gather``) and host memcpy:
    seconds and GB/s of each."""
    from ..ops.extract import host_gather, host_table

    gbytes = len(ids) * feat.shape[1] * feat.itemsize / 1e9
    table, ids_t = host_table(feat), torch.from_numpy(ids)
    out = {}
    for name, fn in (("host gather (numpy)", lambda: feat[ids]),
                     ("host gather (host_gather)",
                      lambda: host_gather(table, ids_t))):
        t = best_s(fn)
        out[name] = {"s": t, "GB/s": gbytes / t}
    dst = np.empty_like(feat)
    t = best_s(lambda: np.copyto(dst, feat))
    out["host memcpy"] = {"s": t, "GB/s": feat.nbytes / 1e9 / t}
    for name, r in out.items():
        print(f"{name + ':':27s} {r['s'] * 1e3:8.2f} ms  {r['GB/s']:7.2f} GB/s",
              flush=True)
    return out


def h2d_lines(block: torch.Tensor, dev: torch.device, card: str) -> dict:
    """Host rows to the card from pageable and pinned memory, on a copy
    stream (``HostFeatures``' upload): the best of five CUDA-event spans
    after a warm-up copy."""
    dst = torch.empty(block.shape, dtype=block.dtype, device=dev)
    stream = torch.cuda.Stream(dev)
    gbytes = block.numel() * block.element_size() / 1e9
    out = {}
    for name, src in (("H2D pageable", block),
                      ("H2D pinned", block.pin_memory())):
        times = []
        for _ in range(6):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(stream):
                a.record()
                dst.copy_(src, non_blocking=True)
                b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        t = min(times[1:])
        out[name] = {"s": t, "GB/s": gbytes / t}
        print(f"{name + ':':27s} {t * 1e3:8.2f} ms  {gbytes / t:7.2f} GB/s "
              f"({gbytes:.3f} GB, copy stream) ({card})", flush=True)
    return out


def device_gather_lines(feat: np.ndarray, ids: np.ndarray,
                        dev: torch.device, card: str) -> dict:
    """K1 and ``index_select`` over the same rows on the card. K1's output
    must equal its plain version bit for bit; returns their times and K1's
    bound (ms)."""
    from ..ops.gather import gather_rows, gather_rows_reference
    from .gather_campaign import median_ms

    table = torch.as_tensor(feat, device=dev)
    ids_dev = torch.as_tensor(ids, device=dev)
    out = gather_rows(table, ids_dev)
    ref = gather_rows_reference(table, ids_dev)
    torch.cuda.synchronize(dev)
    if not torch.equal(out, ref):
        raise RuntimeError("bandwidth_bench: gather_rows != its plain version")
    rows = ids_dev.long()
    k_ms, l_ms = median_ms([lambda: gather_rows(table, ids_dev),
                            lambda: torch.index_select(table, 0, rows)])
    m, d = len(ids), feat.shape[1]
    # every id valid: each row read once and written once, the ids read once
    moved = 2 * m * d * feat.itemsize + 4 * m
    bound = moved / HBM_BYTES_PER_S * 1e3
    res = {"kernel_ms": k_ms, "library_ms": l_ms, "bound_ms": bound}
    for name, ms in (("device gather (K1)", k_ms),
                     ("device gather (index_select)", l_ms)):
        print(f"{name + ':':27s} {ms:8.4f} ms  {moved / ms / 1e6:7.1f} GB/s "
              f"{m / ms / 1e3:7.1f} M rows/s ({card})", flush=True)
    print(f"K1 bound: {bound:.4f} ms ({moved} B at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s); K1 at {bound / k_ms:.1%} of it, "
          f"bit-equal to its plain version", flush=True)
    return res


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("fgnn_tpu_torch bandwidth bench")
    p.add_argument("--rows", type=int, default=1_000_000,
                   help="feature-table rows")
    p.add_argument("--gather", type=int, default=200_000,
                   help="rows gathered per run")
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--device", default="cuda",
                   help="the card (cuda, cuda:N); cpu runs the host lines only")
    args = p.parse_args(argv)

    rng = np.random.default_rng(0)
    feat = rng.standard_normal((args.rows, args.dim)).astype(np.float32)
    ids = rng.integers(0, args.rows, size=args.gather).astype(np.int32)
    print(f"table [{args.rows}, {args.dim}] float32, {args.gather} rows "
          f"gathered", flush=True)
    result = {"host": host_lines(feat, ids)}
    dev = torch.device(args.device)
    if dev.type == "cpu":
        return result
    if not torch.cuda.is_available():
        raise RuntimeError(f"bandwidth_bench: no CUDA device for "
                           f"--device {args.device}")
    from .gather_campaign import card_name

    card = card_name()
    block = torch.from_numpy(feat[: min(args.rows, 200_000)])
    result["h2d"] = h2d_lines(block, dev, card)
    result["device_gather"] = device_gather_lines(feat, ids, dev, card)
    return result


if __name__ == "__main__":
    try:
        main()
    except RuntimeError as e:
        print(e, file=sys.stderr)
        sys.exit(1)
