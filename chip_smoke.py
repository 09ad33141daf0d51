#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``fgnn_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, none of which catches a failure (any failure exits non-zero):
  1. device: needs CUDA; prints the card's name and power limit
     (nvidia-smi) and turns TF32 off for float32 products;
  2. build: compiles the row-gather kernel from fgnn_tpu_torch/csrc with
     nvcc for sm_90a;
  3. kernel against its plain version: bit-equal (torch.equal) at the main
     path's two shapes and on a matrix of dtypes, widths, alignments and
     id patterns; both timed with CUDA events at the main-path shapes;
  4. small input: the port's training step on the card against the same
     step on the CPU, from the same parameters and injected uniforms;
  5. the main path: GraphSAGE arch1 on the 1M-node synthetic graph at the
     benchmark's configuration (bench.py), two epochs through
     OneChipEngine, with the kernel's launch count taken over that run.
Prints a JSON line of kernel results, then as its last line
``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

MAIN_SHAPES = {
    # name: (table rows, row width, ids) at batch 8000, fanout (25, 10),
    # hidden 256 with the calibrated 4-tier plan of the 1M graph
    "feature gather": (1_000_000, 128, 1_040_896),
    "layer-2 gather_src": (80_000, 256, 80_640),
}
# the JAX reference's bench.py run on a TPU v5e (PERF.md), for comparison only
JAX_EPOCH1_LOSS = 3.658
JAX_EDGES_PER_EPOCH = (22_494_030, 22_511_196)
EXPECTED_EDGES = 22.5e6


def check(ok, msg):
    """A failed check ends the run (not ``assert``: ``-O`` drops those)."""
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def padded_ids(n_rows, m, pad_frac, gen, dev):
    import torch

    ids = torch.randint(0, n_rows, (m,), generator=gen, device=dev,
                        dtype=torch.int32)
    pad = torch.rand(m, generator=gen, device=dev) < pad_frac
    return torch.where(pad, -1, ids).to(torch.int32)


def check_equal(table, ids, label):
    """Kernel against plain version, bit for bit; returns max |diff|."""
    import torch
    from fgnn_tpu_torch.ops.gather import gather_rows, gather_rows_reference

    out = gather_rows(table, ids)
    ref = gather_rows_reference(table, ids)
    torch.cuda.synchronize()
    check(torch.equal(out, ref), f"gather_rows != plain version for {label}")
    if out.numel() == 0:
        return 0.0
    return float((out.double() - ref.double()).abs().max())


def median_ms(fns, reps=20, warm=3):
    """Median CUDA-event time of each fn, run in turns."""
    import torch

    for fn in fns:
        for _ in range(warm):
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, ts in zip(fns, times):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
    return [statistics.median(ts) for ts in times]


def kernel_phase(dev, card):
    import torch
    from fgnn_tpu_torch.ops.gather import gather_rows, gather_rows_reference

    gen = torch.Generator(dev).manual_seed(0)
    max_err = 0.0
    timing = {}
    for name, (n, d, m) in MAIN_SHAPES.items():
        table = torch.randn((n, d), generator=gen, device=dev).to(torch.bfloat16)
        ids = padded_ids(n, m, 0.3, gen, dev)
        max_err = max(max_err, check_equal(table, ids, name))
        k_ms, p_ms = median_ms([lambda: gather_rows(table, ids),
                                lambda: gather_rows_reference(table, ids)])
        valid = int((ids >= 0).sum())
        moved = (valid + m) * d * table.element_size() + m * 4
        timing[name] = (k_ms, p_ms)
        for who, ms in (("kernel", k_ms), ("plain", p_ms)):
            print(f"  {name} [{n}, {d}] bf16, {m} ids ({m - valid} padding), "
                  f"{who}: {ms:.4f} ms, {m / ms / 1e3:.1f} M rows/s, "
                  f"{moved / ms / 1e6:.1f} GB/s ({card})")

    # dtypes, widths, ragged M, repeated ids, all padding, M = 1
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in (16, 32, 128, 256):
            table = torch.randn((5000, d), generator=gen, device=dev).to(dtype)
            for label, ids in (
                ("ragged M", padded_ids(5000, 12_345, 0.3, gen, dev)),
                ("repeated ids", padded_ids(7, 4097, 0.1, gen, dev)),
                ("all -1", torch.full((1000,), -1, dtype=torch.int32,
                                      device=dev)),
                ("M=1", padded_ids(5000, 1, 0.0, gen, dev)),
            ):
                max_err = max(max_err, check_equal(
                    table, ids, f"{dtype} D={d} {label}"))
                cases += 1
    # narrower copy paths: 4-, 2- and 1-byte words, and a base pointer off
    # the 16-byte grid
    base = torch.randn(5000 * 8 + 1, generator=gen, device=dev).to(torch.bfloat16)
    for label, table in (
        ("f32 D=3", torch.randn((5000, 3), generator=gen, device=dev)),
        ("bf16 D=7", torch.randn((5000, 7), generator=gen,
                                 device=dev).to(torch.bfloat16)),
        ("uint8 D=5", torch.randint(0, 255, (5000, 5), generator=gen,
                                    device=dev).to(torch.uint8)),
        ("bf16 D=8 misaligned base", base[1:].view(5000, 8)),
    ):
        ids = padded_ids(5000, 3001, 0.3, gen, dev)
        max_err = max(max_err, check_equal(table, ids, label))
        cases += 1
    print(f"  {cases + len(MAIN_SHAPES)} kernel-vs-plain cases bit-equal, "
          f"max |diff| {max_err}")
    return max_err, timing


def small_input_phase(dev):
    """The port's step on the card agrees with the same step on the CPU."""
    import torch
    from fgnn_tpu.config import RunConfig, SampleType
    from fgnn_tpu.data import make_synthetic_dataset
    from fgnn_tpu_torch.engine import OneChipEngine
    from fgnn_tpu_torch.ops.sampling import uniform_shapes

    ds = make_synthetic_dataset(num_node=2000, avg_degree=8, feat_dim=32,
                                num_class=8, train_frac=0.5, seed=42)
    cfg = RunConfig(model="graphsage", fanout=(10, 3), batch_size=128,
                    num_hidden=32, sample_type=SampleType.KHOP2, dropout=0.0,
                    lr=0.003, compute_dtype="float32")
    cpu = OneChipEngine(cfg, ds, "cpu")
    gpu = OneChipEngine(cfg, ds, dev)
    gpu.model.load_state_dict(cpu.model.state_dict())
    check(cpu.plan.tier_layout is not None, "the tiered hop must engage")
    gen = torch.Generator().manual_seed(1)
    shapes = uniform_shapes(cpu.plan, cfg.sample_type, cpu.dedup_last_hop)
    for seeds, n, step in cpu.shuffler.batches(0):
        rand = [torch.rand(s, generator=gen) for s in shapes]
        lc, _, ec, oc = cpu.step(torch.as_tensor(seeds), n, rand)
        lg, _, eg, og = gpu.step(torch.as_tensor(seeds, device=dev), n,
                                 [r.to(dev) for r in rand])
        # same picks -> same edge count; losses differ only by the order
        # of float32 sums on the two devices
        check(int(ec) == int(eg), f"step {step}: edges {int(ec)} != {int(eg)}")
        check(bool(oc) == bool(og), f"step {step}: overflow flags differ")
        check(abs(float(lc) - float(lg)) < 1e-4,
              f"step {step}: loss cpu {float(lc)} gpu {float(lg)}")
        print(f"  step {step}: loss cpu {float(lc):.6f} gpu {float(lg):.6f}, "
              f"edges {int(eg)}")
        if step == 2:
            break


def main_path_phase(dev, card):
    import torch
    from fgnn_tpu.config import RunConfig, SampleType
    from fgnn_tpu.data import make_synthetic_dataset
    from fgnn_tpu_torch.engine import OneChipEngine
    from fgnn_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    ds = make_synthetic_dataset(num_node=1_000_000, avg_degree=15,
                                feat_dim=128, num_class=172, train_frac=0.25,
                                seed=0)
    print(f"  dataset: {ds.num_node} nodes, {ds.num_edge} edges "
          f"({time.perf_counter() - t0:.1f} s on the host)")
    cfg = RunConfig(model="graphsage", fanout=(25, 10), batch_size=8000,
                    num_hidden=256, sample_type=SampleType.KHOP2, dropout=0.5,
                    lr=0.003, compute_dtype="bfloat16")
    t0 = time.perf_counter()
    eng = OneChipEngine(cfg, ds, dev)
    print(f"  engine init {time.perf_counter() - t0:.1f} s; plan {eng.plan}")

    cuda_lib.reset_launches()
    results = []
    for epoch in (0, 1):
        torch.cuda.reset_peak_memory_stats(dev)
        before = cuda_lib.launches.get("gather_rows", 0)
        r = eng.run_epoch(epoch)
        launched = cuda_lib.launches.get("gather_rows", 0) - before
        peak = torch.cuda.max_memory_allocated(dev)
        results.append(r)
        print(f"  epoch {epoch}: loss {r['loss']:.4f} acc {r['acc']:.4f} "
              f"sampled_edges {r['sampled_edges']} epoch_time "
              f"{r['epoch_time']:.4f} s mean step "
              f"{r['epoch_time'] / r['num_step'] * 1e3:.2f} ms over "
              f"{r['num_step']} steps; gather_rows launches {launched}; "
              f"overflow {eng.last_overflowed}; peak memory {peak} B "
              f"({card})")
        check(not eng.last_overflowed, f"epoch {epoch} overflowed its caps")
    launches = cuda_lib.launches.get("gather_rows", 0)
    steps = sum(r["num_step"] for r in results)
    print(f"  JAX reference (TPU v5e, for comparison only; the RNGs differ): "
          f"epoch-1 loss {JAX_EPOCH1_LOSS}, {JAX_EDGES_PER_EPOCH[0]}-"
          f"{JAX_EDGES_PER_EPOCH[1]} sampled edges per epoch")

    l0, l1 = results[0]["loss"], results[1]["loss"]
    check(math.isfinite(l0) and math.isfinite(l1), f"losses {l0}, {l1}")
    check(l1 < l0, f"epoch-1 loss {l1} is not below epoch 0's {l0}")
    check(l1 < math.log(172), f"epoch-1 loss {l1} is not below ln 172")
    for r in results:
        rel = abs(r["sampled_edges"] - EXPECTED_EDGES) / EXPECTED_EDGES
        check(rel < 0.01, f"sampled_edges {r['sampled_edges']} off by {rel:.3%}")
    # per step: feature gather, layer-1 dst_invperm, layer-2 gather_src
    check(launches == 3 * steps, f"{launches} launches for {steps} steps")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a CUDA device", file=sys.stderr)
        return 1
    from fgnn_tpu_torch.ops import cuda_lib

    print("[1/5] device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  torch.cuda.get_device_name: {kind}; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}; allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda", 0)

    print("[2/5] build")
    cuda_lib.load("gather_rows")
    print(f"  gather_rows built in {cuda_lib.build_seconds['gather_rows']:.2f} s"
          f" -> {cuda_lib.library_path('gather_rows')}")

    print("[3/5] kernel against plain version")
    max_err, timing = kernel_phase(dev, card)

    print("[4/5] small input: card against CPU")
    small_input_phase(dev)

    print("[5/5] main path: GraphSAGE arch1, 1M-node graph, 2 epochs")
    launches = main_path_phase(dev, card)

    k_ms, p_ms = timing["feature gather"]
    print(json.dumps({"kernels": [{
        "name": "gather_rows",
        "route": "cuda",
        "source": "fgnn_tpu_torch/csrc/gather_rows.cu",
        "replaces": "fgnn_tpu/ops/pallas_gather2.py:131",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
