#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``fgnn_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, none of which catches a failure (any failure exits non-zero):
  1. device: needs CUDA; prints the card's name and power limit
     (nvidia-smi) and turns TF32 off for float32 products;
  2. build: compiles both kernels (row gather, streaming pass) from
     fgnn_tpu_torch/csrc with nvcc for sm_90a, one nvcc each, together;
  3. row gather against its plain version: bit-equal (torch.equal) at the
     main path's two shapes and on a matrix of dtypes, widths, alignments
     and id patterns; both timed with CUDA events at the main-path shapes;
  4. small input: the port's GraphSAGE training step on the card against
     the same step on the CPU, from the same parameters and injected
     uniforms;
  5. the main path: GraphSAGE arch1 on the 1M-node synthetic graph at the
     benchmark's configuration (bench.py), two epochs through
     OneChipEngine, with the row gather's launch count taken over that run;
  6. streaming pass against its plain version: prints the persistent
     launch (grid, tile, ring depth, CTAs per SM); bit-equal on ragged,
     narrow, misaligned and one-row inputs, on sizes cut around the stage
     tile (one tile, a tile + 16 B, a tile + 4 B, under a tile, a ring
     wrapped three times with a partial last tile), on x and out both off
     the 16-byte grid, on an array above 2^31 bytes, and at the full
     [524288, 128] at each chunk, timed there at each chunk;
  7. the gather campaign's stream and kernel phases, in process, with the
     streaming kernel's launch count taken over that run;
  8. small input, GCN with the 3-layer fanout: card against CPU as in 4;
  9. GCN at the source paper's Table-1 configuration ([5, 10, 15], batch
     8000, hidden 256) on the same graph: two epochs through run_epochs,
     the row gather's launch count over them, the first step's sampled
     edges against the NumPy sampler, then evaluate() on the test set;
 10. small input, PinSAGE (3 random-walk hops, dropout 0): card against
     CPU as in 4, with injected walk uniforms;
 11. PinSAGE at the reference app's configuration (3 hops of K=5, W=4
     walks of length 3, restart 0.5, batch 8000, hidden 256) on the same
     graph: two epochs through run_epochs, the row gather's launch count,
     the first step's sampled edges against an independent NumPy random
     walk, then evaluate();
 12. small input, GAT: eval-mode logits and the gradients of the masked
     loss on the card against the CPU, from the same parameters and
     uniforms (attention dropout, fixed at 0.6 in training, cannot draw
     the same masks on two devices);
 13. GAT 8 heads x 256 at [25, 10] (batch 8000, bf16, the tiered no-dedup
     last hop) on the same graph: two epochs through run_epochs, the row
     gather's launch count, then evaluate(). Its loss is held to fall from
     epoch 0, not to end below ln 172 (see gat_phase).
The 1M-node graph is built once and shared by 5, 9, 11 and 13. Prints a
JSON line of kernel results, then as its last line
``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
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
NUM_CLASS = 172
# gather_rows launches in one GAT training step at [25, 10] with the tiered
# no-dedup last hop (forward only; the backward is a torch scatter-add):
GAT_LAUNCHES_PER_STEP = (
    1    # the feature gather
    + 1  # layer 1: er[dst] over the tiered block (el[src], feat[src] slice)
    + 1  # layer 1: the tiered aggregation's dst_invperm unpermute
    + 1  # layer 2: el[src] over the regular hop-0 block
    + 1  # layer 2: er[dst]
    + 1  # layer 2: feat[src]
)


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


def kernel_phase(dev, card):
    import torch
    from fgnn_tpu_torch.ops.gather import gather_rows, gather_rows_reference
    from fgnn_tpu_torch.tools.gather_campaign import median_ms

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


def small_engines(dev, model, **kw):
    """The port's engine on the CPU and on the card, with the same
    parameters, over a 2000-node graph."""
    from fgnn_tpu.config import RunConfig, SampleType
    from fgnn_tpu.data import make_synthetic_dataset
    from fgnn_tpu_torch.engine import OneChipEngine

    ds = make_synthetic_dataset(num_node=2000, avg_degree=8, feat_dim=32,
                                num_class=8, train_frac=0.5, seed=42)
    cfg = RunConfig(model=model, batch_size=128, num_hidden=32,
                    sample_type=SampleType.KHOP2, dropout=0.0, lr=0.003,
                    compute_dtype="float32").replace(**kw)
    cpu = OneChipEngine(cfg, ds, "cpu")
    gpu = OneChipEngine(cfg, ds, dev)
    gpu.model.load_state_dict(cpu.model.state_dict())
    # GraphSAGE and GAT run the tiered no-dedup last hop, GCN dedups every
    # hop, PinSAGE's walks are untiered
    tiered = model in ("graphsage", "gat")
    check((cpu.plan.tier_layout is not None) == tiered,
          f"{model}: tier layout {cpu.plan.tier_layout}")
    return cpu, gpu


def small_input_phase(dev, model="graphsage", fanout=(10, 3), **kw):
    """The port's step on the card agrees with the same step on the CPU."""
    import torch

    cpu, gpu = small_engines(dev, model, fanout=fanout, **kw)
    gen = torch.Generator().manual_seed(1)
    shapes = cpu.uniform_shapes(cpu.dedup_last_hop)
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


def big_dataset():
    """The 1M-node / avg-degree-15 synthetic graph of bench.py, built once."""
    from fgnn_tpu.data import make_synthetic_dataset

    t0 = time.perf_counter()
    ds = make_synthetic_dataset(num_node=1_000_000, avg_degree=15,
                                feat_dim=128, num_class=NUM_CLASS,
                                train_frac=0.25, seed=0)
    print(f"  dataset: {ds.num_node} nodes, {ds.num_edge} edges "
          f"({time.perf_counter() - t0:.1f} s on the host)")
    return ds


def main_path_phase(dev, card, ds):
    import torch
    from fgnn_tpu.config import RunConfig, SampleType
    from fgnn_tpu_torch.engine import OneChipEngine
    from fgnn_tpu_torch.ops import cuda_lib

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
    check(l1 < math.log(NUM_CLASS), f"epoch-1 loss {l1} is not below ln 172")
    for r in results:
        rel = abs(r["sampled_edges"] - EXPECTED_EDGES) / EXPECTED_EDGES
        check(rel < 0.01, f"sampled_edges {r['sampled_edges']} off by {rel:.3%}")
    # per step: feature gather, layer-1 dst_invperm, layer-2 gather_src
    check(launches == 3 * steps, f"{launches} launches for {steps} steps")
    return launches


def stream_check_phase(dev, card):
    """The streaming kernel against plain ``x + 1``, bit for bit; timed at
    the full shape at each chunk. Returns (max |diff|, {chunk: (ms, ms)})."""
    import torch
    from fgnn_tpu_torch.ops import stream
    from fgnn_tpu_torch.ops.stream import stream_add_one, stream_add_one_reference
    from fgnn_tpu_torch.tools.gather_campaign import (STREAM_CHUNKS,
                                                      STREAM_SHAPE, median_ms)

    n, d = STREAM_SHAPE
    cfg = stream.launch_config(n * d, dev)
    print(f"  launch at {list(STREAM_SHAPE)} f32: grid {cfg['grid']} CTAs "
          f"({cfg['ctas_per_sm']} an SM x {cfg['sms']} SMs), {cfg['tiles']} "
          f"tiles of {cfg['tile_bytes']} B, ring of {cfg['stages']} stages")
    tile = cfg["tile_bytes"] // 4  # float32 elements in one stage tile
    # every CTA wraps its ring three times, then one 3-row partial tile
    wrap_rows = 3 * cfg["grid"] * cfg["stages"] * tile // 128 + 3

    gen = torch.Generator(dev).manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    base = randn(3001 * 128 + 1)
    cases = [
        ("ragged N=3001 D=128", randn(3001, 128), 512),
        ("D=3", randn(5000, 3), 512),
        ("D=3 chunk 7", randn(5000, 3), 7),
        ("misaligned base", base[1:].view(3001, 128), 512),
        ("N=1", randn(1, 128), 512),
        ("one tile", randn(tile // 128, 128), 512),
        ("one tile + 16 B", randn(tile // 4 + 1, 4), 512),
        ("one tile + 4 B", randn(tile + 1, 1), 512),
        ("under one tile", randn(5, 128), 512),
        (f"ring wrapped 3x, partial last tile [{wrap_rows}, 128]",
         randn(wrap_rows, 128), 2048),
        ("above 2^31 bytes [4194305, 128]", randn(4_194_305, 128), 8192),
    ]
    full = randn(*STREAM_SHAPE)
    cases += [(f"full {STREAM_SHAPE} chunk {c}", full, c) for c in STREAM_CHUNKS]
    max_err = 0.0
    for label, x, chunk in cases:
        out = stream_add_one(x, chunk)
        ref = stream_add_one_reference(x)
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"stream_add_one != x + 1 for {label}")
        max_err = max(max_err, float((out - ref).abs().max()))
        del out, ref
    # x and out both 4 bytes off the 16-byte grid: the bulk path's scalar
    # head (the wrapper's own outputs are always aligned)
    x = base[1:].view(3001, 128)
    out = torch.empty_like(base)[1:].view(3001, 128)
    stream._launch(x, out, 512)
    torch.cuda.synchronize()
    check(torch.equal(out, x + 1.0), "stream_add_one != x + 1 for x and out "
          "both off the 16-byte grid")
    print(f"  {len(cases) + 1} stream_add_one-vs-plain cases bit-equal, "
          f"max |diff| {max_err}")
    del cases, x
    moved = 2 * n * d * 4
    timing = {}
    for chunk in STREAM_CHUNKS:
        k_ms, p_ms = median_ms([lambda: stream_add_one(full, chunk),
                                lambda: stream_add_one_reference(full)])
        timing[chunk] = (k_ms, p_ms)
        print(f"  [{n}, {d}] f32 chunk {chunk}: kernel {k_ms:.4f} ms "
              f"({moved / k_ms / 1e6:.1f} GB/s r+w), plain x + 1 "
              f"{p_ms:.4f} ms ({moved / p_ms / 1e6:.1f} GB/s) ({card})")
    return max_err, timing


def campaign_phase(dev, card):
    """The gather campaign's stream and kernel phases in this process; the
    streaming kernel's launches are counted over them."""
    from fgnn_tpu_torch.ops import cuda_lib
    from fgnn_tpu_torch.tools import gather_campaign

    cuda_lib.reset_launches()
    stream = gather_campaign.stream_phase(dev, card)
    launches = cuda_lib.launches.get("stream_add_one", 0)
    check(launches > 0, "the campaign's stream phase launched no kernel")
    gather = gather_campaign.kernel_phase(dev, card)
    print(f"  stream_add_one launches in the stream phase: {launches}")
    return launches, stream, gather


def numpy_first_step_edges(ds, eng, seeds, num_seeds):
    """Sampled edges of one batch by the port's NumPy sampler, with a
    np.unique dedup per hop: the independent count the card is held to."""
    import numpy as np
    from fgnn_tpu_torch.ops.reference_impl import np_sample_hop_vec

    rng = np.random.default_rng(0)
    indptr, indices = np.asarray(ds.indptr), np.asarray(ds.indices)
    cur = np.unique(seeds[:num_seeds])
    edges = 0
    for f in eng.plan.fanouts:
        nbr, valid = np_sample_hop_vec(rng, indptr, indices, cur, f)
        edges += int(valid.sum())
        cur = np.union1d(cur, nbr[valid])
    return edges


def numpy_rw_first_step_edges(ds, cfg, seeds, num_seeds):
    """Sampled edges of one PinSAGE batch by an independent NumPy random
    walk: per hop, W walks of length L from every frontier node (a walk
    stops at a dead end or, after a step, with the restart probability),
    the K most visited distinct nodes as that node's neighbours (counted
    with one sort of (row, id) keys; ties go to the earlier visit), and the
    union of the frontier and those as the next frontier."""
    import numpy as np

    rng = np.random.default_rng(0)
    indptr, indices = np.asarray(ds.indptr), np.asarray(ds.indices)
    W, L, K = cfg.num_random_walk, cfg.random_walk_length, cfg.num_neighbor
    cur = np.unique(seeds[:num_seeds]).astype(np.int64)
    edges = 0
    for _ in range(cfg.num_layer_rw):
        n = cur.shape[0]
        node = np.repeat(cur, W)                   # row i * W + w: walk w of i
        visits = np.full((n * W, L), -1, np.int64)
        for step in range(L):
            safe = np.maximum(node, 0)
            deg = indptr[safe + 1] - indptr[safe]
            ok = (node >= 0) & (deg > 0)
            pick = np.minimum((rng.random(n * W) * deg).astype(np.int64),
                              np.maximum(deg - 1, 0))
            nxt = indices[np.minimum(indptr[safe] + pick, len(indices) - 1)]
            visits[:, step] = np.where(ok, nxt, -1)
            live = rng.random(n * W) >= cfg.random_walk_restart_prob
            node = np.where(ok & live, visits[:, step], -1)
        row = np.repeat(np.arange(n), W * L)
        ids = visits.reshape(-1)
        row, ids = row[ids >= 0], ids[ids >= 0]
        key, first, cnt = np.unique(row * (ds.num_node + 1) + ids,
                                    return_index=True, return_counts=True)
        row, ids = key // (ds.num_node + 1), key % (ds.num_node + 1)
        # by row, most visited first, ties in visit order: a tie broken by
        # id would favour low ids in every row and shrink the union
        order = np.lexsort((first, -cnt, row))
        row, ids = row[order], ids[order]
        rank = np.arange(row.shape[0]) - np.searchsorted(row, row)
        edges += int((rank < K).sum())
        cur = np.union1d(cur, ids[rank < K])
    return edges


def big_engine(dev, ds, **kw):
    """The port's engine at batch 8000, hidden 256, bf16, dropout 0.5, lr
    0.003 on the 1M-node graph, with ``kw`` on top."""
    from fgnn_tpu.config import RunConfig
    from fgnn_tpu_torch.engine import OneChipEngine

    cfg = RunConfig(batch_size=8000, num_hidden=256, dropout=0.5, lr=0.003,
                    compute_dtype="bfloat16").replace(**kw)
    t0 = time.perf_counter()
    eng = OneChipEngine(cfg, ds, dev)
    print(f"  engine init {time.perf_counter() - t0:.1f} s; plan {eng.plan}")
    return eng


def first_step_phase(dev, eng, np_edges, source):
    """The first step's batch, sampled apart from training, holds within 1%
    of ``np_edges`` sampled edges (by ``source``) and does not overflow."""
    import torch

    seeds_all, nums_all = eng.shuffler.epoch_arrays(0)
    batch = eng.sample(torch.as_tensor(seeds_all[0], device=dev),
                       int(nums_all[0]), torch.Generator(dev).manual_seed(1),
                       eng.dedup_last_hop)
    port_edges = int(sum(int(b.mask.sum()) for b in batch.blocks))
    want = np_edges(seeds_all[0], int(nums_all[0]))
    rel = abs(port_edges - want) / want
    print(f"  first step sampled edges: card {port_edges}, {source} {want} "
          f"({rel:.3%}); per hop "
          f"{[int(b.mask.sum()) for b in reversed(batch.blocks)]}; "
          f"overflow {bool(batch.overflowed)}")
    check(rel < 0.01, f"first-step edges {port_edges} vs {source} {want}")
    check(not bool(batch.overflowed), "the first step's batch overflowed")


def train_phase(dev, card, ds, eng, launches_per_step, below_uniform=True):
    """Two epochs through run_epochs, then evaluate() on the test set.
    Gates: finite losses, epoch 1 below epoch 0 (and below ln 172, the
    loss of a uniform guess, if ``below_uniform``), no cap overflow,
    ``launches_per_step`` row-gather launches a step, accuracy in
    (1/172, 1]. Returns (results, launches)."""
    import torch
    from fgnn_tpu_torch.ops import cuda_lib

    torch.cuda.reset_peak_memory_stats(dev)
    cuda_lib.reset_launches()
    results = eng.run_epochs(0, 2)
    launches = cuda_lib.launches.get("gather_rows", 0)
    peak = torch.cuda.max_memory_allocated(dev)
    for r in results:
        print(f"  epoch {r['epoch']}: loss {r['loss']:.4f} acc {r['acc']:.4f} "
              f"sampled_edges {r['sampled_edges']} epoch_time "
              f"{r['epoch_time']:.4f} s (run_epochs total / 2) mean step "
              f"{r['epoch_time'] / r['num_step'] * 1e3:.2f} ms over "
              f"{r['num_step']} steps ({card})")
    steps = sum(r["num_step"] for r in results)
    print(f"  gather_rows launches over the two epochs {launches}; overflow "
          f"{eng.last_overflowed}; peak memory {peak} B ({card})")
    t0 = time.perf_counter()
    acc = eng.evaluate()
    print(f"  evaluate() on the {len(ds.test_set)} test nodes: accuracy "
          f"{acc:.4f} ({time.perf_counter() - t0:.2f} s)")

    l0, l1 = results[0]["loss"], results[1]["loss"]
    check(math.isfinite(l0) and math.isfinite(l1), f"losses {l0}, {l1}")
    check(l1 < l0, f"epoch-1 loss {l1} is not below epoch 0's {l0}")
    check(l1 < math.log(NUM_CLASS) or not below_uniform,
          f"epoch-1 loss {l1} is not below ln 172")
    check(not eng.last_overflowed, "an epoch overflowed its caps")
    check(launches == launches_per_step * steps,
          f"{launches} launches for {steps} steps")
    check(1.0 / NUM_CLASS < acc <= 1.0, f"evaluate() accuracy {acc}")
    return results, launches


def gcn_phase(dev, card, ds):
    """GCN of the source paper's Table 1 (exp/table1/run.py: fanout 5 10
    15) at full width: two epochs through run_epochs, then evaluate()."""
    from fgnn_tpu.config import SampleType

    eng = big_engine(dev, ds, model="gcn", fanout=(5, 10, 15),
                     sample_type=SampleType.KHOP2)
    check(eng.dedup_last_hop and eng.plan.tier_layout is None,
          "GCN must dedup its last hop, untiered")
    first_step_phase(dev, eng, lambda seeds, n: numpy_first_step_edges(
        ds, eng, seeds, n), "NumPy sampler")
    # per step: the feature gather and the three layers' gather_src
    return train_phase(dev, card, ds, eng, 4)[1]


def pinsage_phase(dev, card, ds):
    """PinSAGE at the reference app's configuration (RunConfig and
    examples/common_config.py defaults: 3 hops of num_neighbor 5, 4 walks
    of length 3, restart 0.5): two epochs through run_epochs, then
    evaluate()."""
    from fgnn_tpu.config import SampleType

    eng = big_engine(dev, ds, model="pinsage",
                     sample_type=SampleType.RANDOM_WALK, num_layer_rw=3,
                     num_neighbor=5, num_random_walk=4, random_walk_length=3,
                     random_walk_restart_prob=0.5)
    check(not eng.dedup_last_hop and eng.plan.tier_layout is None,
          "PinSAGE must skip its last hop's dedup, untiered")
    first_step_phase(dev, eng, lambda seeds, n: numpy_rw_first_step_edges(
        ds, eng.cfg, seeds, n), "NumPy random walk")
    # per step: the feature gather and gather_src on the two dedup hops
    # (the no-dedup last hop's gather_src is a slice)
    return train_phase(dev, card, ds, eng, 3)[1]


def gat_small_phase(dev):
    """GAT on the card against the CPU in eval mode: the logits within
    1e-4, the masked loss's gradients within 1e-4 of their largest entry,
    from the same parameters and uniforms (the training layout)."""
    import torch
    from fgnn_tpu_torch.ops.extract import label_gather
    from fgnn_tpu_torch.train.loop import masked_cross_entropy

    cpu, gpu = small_engines(dev, "gat", fanout=(10, 3), dropout=0.5)
    gen = torch.Generator().manual_seed(2)
    shapes = cpu.uniform_shapes(cpu.dedup_last_hop)
    B = cpu.cfg.batch_size

    def forward_backward(eng, seeds, n, rand):
        batch = eng.sample(seeds, n, rand, eng.dedup_last_hop)
        feats = eng.feat_gather(eng.feat_dev, batch.input_nodes)
        labels = label_gather(eng.label_dev, batch.output_nodes)
        eng.model.eval()
        eng.model.zero_grad(set_to_none=True)
        logits = eng.model(batch, feats, eng.dst_caps)
        loss, _ = masked_cross_entropy(logits[:B], labels[:B])
        loss.backward()
        grads = {k: p.grad.cpu() for k, p in eng.model.named_parameters()}
        edges = int(sum(int(b.mask.sum()) for b in batch.blocks))
        return logits.detach().cpu(), loss.item(), grads, edges

    for seeds, n, step in cpu.shuffler.batches(0):
        rand = [torch.rand(s, generator=gen) for s in shapes]
        lc, loss_c, gc, ec = forward_backward(cpu, torch.as_tensor(seeds), n,
                                              rand)
        lg, loss_g, gg, eg = forward_backward(
            gpu, torch.as_tensor(seeds, device=dev), n,
            [r.to(dev) for r in rand])
        check(ec == eg, f"step {step}: edges {ec} != {eg}")
        err = float((lc - lg).abs().max())
        check(err < 1e-4, f"step {step}: logits differ by {err}")
        rel = max(float((gc[k] - gg[k]).abs().max() / gc[k].abs().max())
                  for k in gc)
        check(rel < 1e-4, f"step {step}: gradients differ by {rel} relative")
        print(f"  step {step}: loss cpu {loss_c:.6f} gpu {loss_g:.6f}, edges "
              f"{eg}, logits max |diff| {err:.2e}, gradients max relative "
              f"diff {rel:.2e}")
        if step == 2:
            break


def gat_phase(dev, card, ds):
    """GAT, 8 heads x 256 hidden, at [25, 10] (GraphSAGE's sampler, the
    tiered no-dedup last hop): two epochs through run_epochs, then
    evaluate(); sampled edges within 1% of 22.5M an epoch."""
    from fgnn_tpu.config import SampleType

    eng = big_engine(dev, ds, model="gat", fanout=(25, 10),
                     sample_type=SampleType.KHOP2)
    check(not eng.dedup_last_hop and eng.plan.tier_layout is not None,
          "GAT must run the tiered no-dedup last hop")
    # GAT never sees a node's own features, which set the synthetic labels,
    # and starts above ln 172: the JAX reference's GAT also ends epoch 1
    # above it (PERF.md, GAT's loss gate), so only the fall from epoch 0
    # is gated
    results, launches = train_phase(dev, card, ds, eng, GAT_LAUNCHES_PER_STEP,
                                    below_uniform=False)
    for r in results:
        rel = abs(r["sampled_edges"] - EXPECTED_EDGES) / EXPECTED_EDGES
        check(rel < 0.01, f"sampled_edges {r['sampled_edges']} off by {rel:.3%}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a CUDA device", file=sys.stderr)
        return 1
    from fgnn_tpu.config import SampleType
    from fgnn_tpu_torch.ops import cuda_lib
    from fgnn_tpu_torch.tools.gather_campaign import card_name

    t_start = time.perf_counter()
    print("[1/13] device")
    card = card_name()
    print(card)
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  torch.cuda.get_device_name: {kind}; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}; allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda", 0)

    print("[2/13] build")
    kernels = ("gather_rows", "stream_add_one")
    cuda_lib.build(kernels)
    for name in kernels:
        print(f"  {name} built in {cuda_lib.build_seconds[name]:.2f} s (all "
              f"built together) -> {cuda_lib.library_path(name)}")

    print("[3/13] row gather against plain version")
    max_err, timing = kernel_phase(dev, card)

    print("[4/13] small input, GraphSAGE: card against CPU")
    small_input_phase(dev)

    print("[5/13] main path: GraphSAGE arch1, 1M-node graph, 2 epochs")
    ds = big_dataset()
    sage_launches = main_path_phase(dev, card, ds)

    print("[6/13] streaming pass against plain version")
    s_err, s_timing = stream_check_phase(dev, card)

    print("[7/13] gather campaign: stream and kernel phases")
    s_launches, _, _ = campaign_phase(dev, card)

    print("[8/13] small input, GCN [5, 10, 15]: card against CPU")
    small_input_phase(dev, model="gcn", fanout=(5, 10, 15))

    print("[9/13] GCN Table 1: [5, 10, 15], 1M-node graph, 2 epochs + evaluate")
    gcn_launches = gcn_phase(dev, card, ds)

    print("[10/13] small input, PinSAGE: card against CPU")
    small_input_phase(dev, model="pinsage",
                      sample_type=SampleType.RANDOM_WALK)

    print("[11/13] PinSAGE, 3 x 5 walks W=4 L=3, 1M-node graph, 2 epochs + "
          "evaluate")
    pinsage_launches = pinsage_phase(dev, card, ds)

    print("[12/13] small input, GAT: card against CPU, eval-mode logits and "
          "gradients")
    gat_small_phase(dev)

    print("[13/13] GAT 8 x 256 at [25, 10], 1M-node graph, 2 epochs + "
          "evaluate")
    gat_launches = gat_phase(dev, card, ds)
    print(f"  smoke wall time so far {time.perf_counter() - t_start:.1f} s")

    k_ms, p_ms = timing["feature gather"]
    best = min(s_timing, key=lambda c: s_timing[c][0])
    print(f"  stream_add_one ms/plain_ms below: chunk {best}, the fastest")
    print(json.dumps({"kernels": [{
        "name": "gather_rows",
        "route": "cuda",
        "source": "fgnn_tpu_torch/csrc/gather_rows.cu",
        "replaces": "fgnn_tpu/ops/pallas_gather2.py:131",
        "launches": (sage_launches + gcn_launches + pinsage_launches
                     + gat_launches),
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }, {
        "name": "stream_add_one",
        "route": "cuda",
        "source": "fgnn_tpu_torch/csrc/stream_add_one.cu",
        "replaces": "tools/gather_campaign.py:129",
        "launches": s_launches,
        "max_abs_err": s_err,
        "ms": s_timing[best][0],
        "plain_ms": s_timing[best][1],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
