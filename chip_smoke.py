#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``fgnn_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, none of which catches a failure (any failure exits non-zero):
  1. device: needs CUDA; prints the card's name and power limit
     (nvidia-smi) and turns TF32 off for float32 products;
  2. build: compiles the four kernels (row gather, streaming pass, segment
     sum, row scatter-add) from fgnn_tpu_torch/csrc with nvcc for sm_90a,
     one nvcc each, together;
  3. row gather against its plain version: bit-equal (torch.equal) at the
     main path's two shapes and on a matrix of dtypes, widths, alignments
     and id patterns; both, and ``torch.index_select`` over the same rows,
     timed with CUDA events at the main-path shapes;
  4. small input: the port's GraphSAGE training step on the card against
     the same step on the CPU, from the same parameters and injected
     uniforms;
  5. the main path: GraphSAGE arch1 on the 1M-node synthetic graph at the
     benchmark's configuration (bench.py), two epochs through
     OneChipEngine, with the row gather's launch count taken over that run
     (three a step) and the segment sum's and the scatter-add's (one each
     a step: layer 2's regular block; layer 1 aggregates the input
     features, which take no gradient, so its dst_invperm unpermute has no
     backward);
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
     the row gather's launch count over them (four a step), the segment
     sum's and the scatter-add's (three each a step, one a layer), the
     first step's sampled edges against the NumPy sampler, then evaluate()
     on the test set;
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
 14. small input, the host-resident table behind the static cache
     (PRESAMPLE 25%) and the dynamic cache: card against CPU from the same
     parameters and injected uniforms (presample included), misses per
     step equal and losses within 1e-4; each combine bit-equal to its plain
     version on the card;
 15. the GraphSAGE main-path configuration with the feature table in host
     memory (feat_budget=0): hit rates of PRESAMPLE, DEGREE and RANDOM at
     10% and 20% cache, one epoch each; the static combine against its
     plain version at the main path's shapes; two pipelined epochs through
     run_epochs at PRESAMPLE 10% (a third under torch.profiler for the
     card's busy share, a fourth with half the host's intra-op threads),
     eight steps of it stage by stage with a sync after each, one
     synchronous epoch of the same, and one epoch each of the uncached host
     path and of the dynamic cache; epoch times, miss bytes, peak memory,
     row-gather launches per step, the host gather's and the pinned
     upload's GB/s.
 16. small input, KHOP1 (GraphSAGE), WEIGHTED_KHOP (GraphSAGE),
     WEIGHTED_KHOP_HASH_DEDUP (GraphSAGE) and WEIGHTED_KHOP_PREFIX (GCN
     [5, 10, 15]): card against CPU as in 4, each step's sampled batch
     equal exactly; then the direct-index dedup against the one-sort dedup
     on the main path's two hops, equal, both timed with CUDA events;
 17. the weighted tables of the 1M-node graph (built once on the host,
     timed); pick frequencies on the card of vertices of degree above 128
     and of 26-128 (alias and prefix within TV_BOUND of the weights over 1M
     draws, hash-dedup picks distinct and complete outside its stream
     branch's shortfall rows); then at batch 8000, hidden 256, bf16:
     GraphSAGE [25, 10] WEIGHTED_KHOP for two epochs through run_epochs,
     evaluate() and a third epoch under torch.profiler, GCN [5, 10, 15]
     WEIGHTED_KHOP_PREFIX, GraphSAGE WEIGHTED_KHOP_HASH_DEDUP and GraphSAGE
     KHOP1 one epoch each; the first step's edges of the with-replacement
     samplers equal to the host's count of fanout x [deg > 0] over each
     hop's frontier; launches per step checked;
 18. small input, arch0 (HostSamplingEngine: the C++ host samplers, built
     with g++ at first use): GraphSAGE KHOP2 and WEIGHTED_KHOP and
     PinSAGE on the card against the CPU, the same host batches, losses
     within 1e-4;
 19. arch0 at the bench configuration (GraphSAGE [25, 10], batch 8000,
     hidden 256) on the 1M-node graph: two epochs, eight synced steps stage
     by stage, a third epoch under torch.profiler; one epoch each at
     PRESAMPLE 10% and of PinSAGE 3 x 5 (W=4, L=3).
 20. the entry points. Small input, on the card: an epoch at profile
     level 3 with the trace, node access and the sanity checker on equals
     a level-1 epoch (losses within 1e-5, edges equal; the trace lanes also
     show as torch.profiler ranges); a session-driven epoch equals
     run_epoch; a checkpoint saved after epoch 0 and restored into a new
     engine resumes at epoch 1 with the saved parameters and matches the
     uninterrupted epoch 1 within 1e-5. Then the app
     (``python -m fgnn_tpu_torch.examples.train_gnn``) as a subprocess at
     the bench configuration (GraphSAGE arch1 [25, 10], batch 8000, hidden
     256, 1M nodes): two epochs at profile level 1, one at level 3 with
     the trace and node access, each parsed with the runner's parse_log:
     the keys, non-zero L2/L3 items at level 3, the trace's L0-L2 lanes,
     the row gather's launches (three a step), the same epoch-0 loss
     within 1e-4; then the app's level-1 configuration driven through
     OneChipEngine in this process for two epochs, its steady epoch
     beside the app's;
 21. the Table-1 ablation (``python -m fgnn_tpu_torch.exp.table1``) at its
     defaults with two epochs, one row at a time: five rows, each rc 0
     with a finite epoch_time and non-zero stage columns. It runs beside
     phases 32-34 with phase 34's runners (the smoke's time limit), so the
     times it prints are not measurements;
 22. small input, arch5 (``FactoredEngine``) S=1 with T=1 and T=2 and
     arch6 (``SGNNEngine``) W=1 and W=2, every role on the card, against
     the CPU: one epoch from the same parameters and CPU-drawn uniforms,
     edges equal, loss and parameters within 1e-4;
 23. at the bench configuration, in a process of its own (``python -m
     fgnn_tpu_torch.tools.factored_epochs``): arch5 S=1 T=1 on
     [cuda:0, cuda:0], the table on the trainer, three epochs; its cache
     mode (PRESAMPLE 10%) pipelined and synchronous, two epochs each,
     bit-equal; arch6 W=1 and W=2, two epochs each; then an arch5 epoch
     under torch.profiler for the card's busy seconds, over the profiled
     and the unprofiled epoch. Losses finite and falling, no overflow, the
     row gather's launches per group; epoch times, edges/s, hit rates,
     peak memory;
 24. the row gather at the arch5 and arch6 paths' own shapes at the bench
     configuration (untiered plans; arch5's dedup'd last hop gathers in
     layer 1, arch6's feature gather takes [frontier | picks]): the first
     group's gathers of an epoch, as the path made them, bit-equal to the
     plain version and timed beside their bound and ``index_select``;
 25. arch5 S=1 T=2 on one card at the bench configuration: one group's
     data-parallel step against one replica's step on the same batches
     and weighted loss, parameters within 1e-4;
 26. the switcher (``FGNN_TPU_SWITCHER_FORCE=1``, S=1 T=1) and the async
     trainers (T=2, averaging every 2 groups), one epoch each: finite
     losses, the switcher's tail engaged;
 27. the reference's multi-device gates (``python -m
     fgnn_tpu_torch.tools.multichip``, a process of its own under
     deterministic algorithms, on the reference's 800-node input; it runs
     beside phases 29-31 and is checked after them): on one
     card ``--devices cuda:0``, every role on cuda:0 (S=1, T=3, W=4), so
     (a) and (b), the placement gates, are refused by name and (c)-(h)
     run: arch6's finite loss, no overflow, arch5's loss within 5% of
     arch6's, and cache mode, PinSAGE's walk and the forced switcher each
     bit-equal over two runs; with two or more cards, every gate over
     every card (see the tool), each one's seconds printed;
 28. the app, ``train_gnn --arch arch5 --devices cuda:0,cuda:0`` at the
     bench configuration, two epochs: rc 0, its devices, keys and
     launches;
 29. a process per role on one card, small input, in a process of its own
     with deterministic algorithms: the factored app
     (``train_factored_multihost``, the 2000-node graph, dropout 0.5) as a
     sampler process and a trainer process on cuda:0, with the table on
     the trainer and in cache mode (PRESAMPLE 20%), against
     ``FactoredEngine`` on [cuda:0, cuda:0] in that process: losses and
     parameters bit-equal;
 30. a process per role at the bench configuration (``python -m
     fgnn_tpu_torch.tools.multiprocess_epochs``, two epochs, sampler and
     trainer on cuda:0): finite, falling losses, three row-gather launches
     a group in the trainer process, the epoch-0 loss (an epoch under
     deterministic algorithms, so through the scatter-add's deterministic
     path) equal to ``FactoredEngine``'s in one process; epoch 1's time
     beside it, the bytes and seconds a wave takes to cross. Then the
     data-parallel demo (``train_multihost``) as 2 processes on cuda:0: the
     same parameter checksum on both, a falling loss;
 31. one runner row end to end: Table 4's arch5 and arch6 rows at n = 2
     (GCN [5, 10, 15], its own 200,000-node graph, level 1 and level 2
     runs, two epochs each): rc 0, finite epoch times, stage columns,
     launches.
 32. converted data on the card: the vendored ogbn-products fixture (300
     nodes, OGB's raw csv.gz layout) through the port's datagen
     (``fgnn_tpu_torch/data/datagen.py``) into
     ``chiprun_out/smoke_datagen/``, loaded, GraphSAGE [5, 5] trained on the
     card for 8 epochs (the loss falls, test accuracy above 1.5/47), the row
     gather's launches counted; then one float32 step on the card against
     the CPU from the same parameters and uniforms, within 1e-4 (as 4);
 33. the cache-policy experiments in process at their defaults (1M nodes,
     skew 6, pref 0.5; table2 200,000 nodes): fig10, fig11, fig5a and
     table2, each table printed. Gates: the optimal ranking at or above
     every policy at every cache size (it is built from the accesses it is
     scored on), random within 0.01 of the cache fraction (fig10, fig11),
     every table2 similarity within [0, 100]. Then fig5b (weighted_khop)
     at 200,000 nodes, gated as fig5a: depth cut, its alias tables at the
     default 1M nodes take 30 s on the host (``python -m
     fgnn_tpu_torch.exp.fig5 --sample-type weighted_khop`` runs it there);
 34. the single-device app runners through the port's runner: fig17b,
     table6, fig4a then fig4b over its table, fig12 and the auto_runner
     ``breakdown`` suite. The five runners start, one thread each (their
     rows one at a time), before phase 32 and run beside 32-33 (the times
     they print are not measurements: PERF.md takes them from runs at the
     defaults, one runner alone); they are checked after 33. Every row rc
     0 with a finite epoch time and K1 launches, which join the
     ``kernels`` line's count. Depth cut from the defaults (the smoke's
     time limit): two epochs a row in each; fig4a at 0 / 10 / 20% (not
     0-30% in five rows); fig12 GraphSAGE only (not GCN too);
 35. ``python -m fgnn_tpu_torch.tools.bandwidth_bench`` at its defaults
     (1M x 128 f32, 200,000 rows), after 34 and 36, the card otherwise idle:
     host gather, memcpy, H2D pageable and pinned, K1 bit-equal to its
     plain version there and timed beside ``index_select`` and its bound.
 36. the papers100M- and uk-union-scale tools at full width on a cut node
     count, each a process of its own, into a temporary directory outside
     the repository (removed after): the papers100M rehearsal
     (``fgnn_tpu_torch.tools.papers100m_rehearsal``, 2,000,000 nodes,
     lognormal(3), 128-dim features from the 1M-row mock table, 172 classes,
     batch 8000, [25, 10], hidden 256) with ``--gen-only``, then its hbm and
     cache modes, two epochs each; the Table-1 driver
     (``fgnn_tpu_torch.exp.table1_papers100m``) over its four rows with
     ``--skip-stages`` (a process a row) into
     ``chiprun_out/smoke_table1_papers100m/``; the uk-union tool's
     ``generate`` and ``run_epoch`` (arch0 GraphSAGE [25, 10], two epochs)
     at 2,000,000 nodes and 30M edges through its keyword parameters.
     Gates: every process rc 0, losses finite, the cache mode's hit rate in
     (0, 1], K1 launched in every training process; its launches join the
     ``kernels`` line's count. Then, in this process over the same 2M-node
     dataset, the rehearsal's hbm and cache engines each hold one step's
     feature gather against its plain version, bit for bit
     (``papers100m_rehearsal.check_step``): the mock gather from the 1M-row
     table against ``index_select`` of the ids modulo its rows, the combine
     over the 300,000-row cache against ``combine_reference``. The phase
     starts, in a thread, with phase 29 and runs beside 29-34 (the times it
     prints are not measurements: PERF.md takes them from ``python -m
     fgnn_tpu_torch.tools.scale_runs``); it is awaited and checked after 34,
     before 35, so that phase 35 times the card and the host alone.
 37. the port's benchmark, ``python -m bench_torch.run --cell
     sage_hbm_syn1M --epochs 2`` (BENCHMARK.json's main-path cell, one
     warm-up and 2 measured epochs), a process of its own started beside
     phases 32-34 and checked after them: rc 0, every metric and layer
     metric of the cell printed by name, its last line ``correct`` (its
     step held against the plain float64 reference, ``check`` lines), and
     K1 launched in its timed run (the launches join the ``kernels`` line's
     count). Its times are not measurements: PERF.md takes the cells'
     numbers from ``python -m bench_torch.spread``.
 38. the segment sum (K4, ``csrc/segment_sum_rows.cu``) and the row
     scatter-add (K5, ``csrc/scatter_add_rows.cu``) on the first batch of
     phases 9 and 5's engines, every block as the training step takes it
     (``fgnn_tpu_torch.tools.segment_kernels``): GCN's three regular blocks
     (float32, 256 / 256 / 172 wide) and GraphSAGE's regular hop-0 block
     (bf16, 256 wide) through K4 and K5 with the block's K and mask,
     GraphSAGE's ``dst_invperm`` unpermute (bf16, 128 wide) through K5
     with K = 1; GCN's four K1 gathers (the input features, each layer's
     messages). K1 bit-equal to its plain version; K4 and K5 against
     theirs within the float32 summation-order bound of each element, and
     bit-equal on integer-valued rows; K5 under deterministic algorithms
     bit-equal over two runs and to the plain version on integer-valued
     rows; each timed beside its plain version, its library call
     (``where`` + ``sum``, ``index_add_``, ``index_select``) and its bound,
     K5 split into its CSR stages and its sum, its deterministic mode into
     the sort and the sum. Then K5's edge cases, checked the same way
     (``segment_kernels.edge_cases``): a permutation, repeats with padding,
     a masked block, rows that receive no slot, rows of 1,000 and 100,000
     slots, an all-padding block, each at widths 172 and 7 in float32 and
     bf16 and 256 wide off the 8-byte grid. It runs right after phase 9.
The app and role processes read the bytecode this process compiles
(``fgnn_tpu_torch/_build/pycache``): without it each one compiles torch's
sources again on a machine whose packages hold none.
The 1M-node graph is built once and shared by 5, 9, 11, 13, 15, 16, 17,
19, 24-26 and 38 (the apps and phase 23's process build their own). Prints
a JSON line of kernel results (each with its bound on this card and the
time of the one PyTorch call that computes the same function), then as its
last line ``{"ok": true, "device": {...}}``.
"""
import atexit
import json
import math
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

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
# cache shares of phase 15's hit-rate runs
CACHE_SHARES = (0.1, 0.2)
# phase 17: the largest total variation allowed between a weighted
# sampler's pick frequencies (1M draws of one vertex) and its normalised
# weights; the sampling noise alone is about 0.4 sqrt(deg / 1M), under 0.01
# up to degree 600
TV_BOUND = 0.02
# gather_rows launches in one GAT training step at [25, 10] with the tiered
# no-dedup last hop (forward only; the backward is the scatter-add kernel):
GAT_LAUNCHES_PER_STEP = (
    1    # the feature gather
    + 1  # layer 1: er[dst] over the tiered block (el[src], feat[src] slice)
    + 1  # layer 1: the tiered aggregation's dst_invperm unpermute
    + 1  # layer 2: el[src] over the regular hop-0 block
    + 1  # layer 2: er[dst]
    + 1  # layer 2: feat[src]
)
# segment sum (K4) and scatter-add (K5) launches a training step: one each
# a regular, gathered block with a gradient. GCN: its three layers.
# GraphSAGE [25, 10]: layer 2's hop-0 block; layer 1 aggregates the input
# features, which take no gradient, so its dst_invperm gather has no backward
GCN_KERNEL_STEPS = {"segment_sum_rows": 3, "scatter_add_rows": 3}
SAGE_KERNEL_STEPS = {"segment_sum_rows": 1, "scatter_add_rows": 1}


# the H100 SXM data sheet's memory rate (700 W); a kernel's bound is the
# bytes it must move over this rate (every kernel moves bytes: no products)
HBM_BYTES_PER_S = 3.35e12


def bound_ms(moved_bytes):
    return moved_bytes / HBM_BYTES_PER_S * 1e3


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


def time_gather(table, ids, name, card):
    """The row gather, its plain version and ``index_select`` over the same
    rows timed with CUDA events (median ms), beside the bound: each valid
    row read once, every output row written once, the ids read once."""
    import torch
    from fgnn_tpu_torch.ops.gather import gather_rows, gather_rows_reference
    from fgnn_tpu_torch.tools.gather_campaign import median_ms

    (n, d), m = table.shape, ids.shape[0]
    # the one PyTorch call for the same rows: index_select over the ids
    # with padding clamped to row 0 (it cannot write zero rows itself)
    rows = ids.clamp(min=0).long()
    k_ms, p_ms, l_ms = median_ms([
        lambda: gather_rows(table, ids),
        lambda: gather_rows_reference(table, ids),
        lambda: torch.index_select(table, 0, rows)])
    valid = int((ids >= 0).sum())
    moved = (valid + m) * d * table.element_size() + m * 4
    timing = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
              "bound_ms": bound_ms(moved)}
    dtype = str(table.dtype).replace("torch.", "")
    for who, ms in (("kernel", k_ms), ("plain", p_ms), ("index_select", l_ms)):
        print(f"  {name} [{n}, {d}] {dtype}, {m} ids ({m - valid} padding), "
              f"{who}: {ms:.4f} ms, {m / ms / 1e3:.1f} M rows/s, "
              f"{moved / ms / 1e6:.1f} GB/s ({card})")
    print(f"  {name}: bound {timing['bound_ms']:.4f} ms ({moved} B at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s), kernel at "
          f"{timing['bound_ms'] / k_ms:.1%} of it")
    return timing


def kernel_phase(dev, card):
    import torch

    gen = torch.Generator(dev).manual_seed(0)
    max_err = 0.0
    timing = {}
    for name, (n, d, m) in MAIN_SHAPES.items():
        table = torch.randn((n, d), generator=gen, device=dev).to(torch.bfloat16)
        ids = padded_ids(n, m, 0.3, gen, dev)
        max_err = max(max_err, check_equal(table, ids, name))
        timing[name] = time_gather(table, ids, name, card)

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


def small_dataset():
    """The 2000-node graph of the card-against-CPU phases, with the
    weighted samplers' tables."""
    from fgnn_tpu_torch.data import build_alias_tables, make_synthetic_dataset

    ds = make_synthetic_dataset(num_node=2000, avg_degree=8, feat_dim=32,
                                num_class=8, train_frac=0.5, seed=42)
    build_alias_tables(ds, seed=0)
    return ds


def small_config(model, **kw):
    from fgnn_tpu_torch.config import RunConfig, SampleType

    return RunConfig(model=model, batch_size=128, num_hidden=32,
                     sample_type=SampleType.KHOP2, dropout=0.0, lr=0.003,
                     compute_dtype="float32").replace(**kw)


def small_engines(dev, model, **kw):
    """The port's engine on the CPU and on the card, with the same
    parameters, over a 2000-node graph."""
    from fgnn_tpu_torch.config import SampleType
    from fgnn_tpu_torch.engine import OneChipEngine

    ds = small_dataset()
    cfg = small_config(model, **kw)
    cpu = OneChipEngine(cfg, ds, "cpu")
    gpu = OneChipEngine(cfg, ds, dev)
    gpu.model.load_state_dict(cpu.model.state_dict())
    # GraphSAGE and GAT run the tiered no-dedup last hop with the uniform
    # samplers without replacement, GCN dedups every hop, PinSAGE's walks,
    # KHOP1 and the weighted samplers are untiered
    tiered = (model in ("graphsage", "gat")
              and cfg.sample_type in (SampleType.KHOP0, SampleType.KHOP2))
    check((cpu.plan.tier_layout is not None) == tiered,
          f"{model}: tier layout {cpu.plan.tier_layout}")
    return cpu, gpu


def check_batches_equal(a, b, label):
    """Two sampled batches (any devices) equal in every tensor and layout
    field."""
    import dataclasses

    import torch

    def same(x, y, what):
        check((x is None) == (y is None), f"{label}: {what} present on one "
              "side only")
        if x is not None and isinstance(x, torch.Tensor):
            check(torch.equal(x.cpu(), y.cpu()), f"{label}: {what} differ")
        elif x is not None:
            check(x == y, f"{label}: {what} {x} != {y}")

    check(len(a.blocks) == len(b.blocks), f"{label}: block counts differ")
    for i, (x, y) in enumerate(zip(a.blocks, b.blocks)):
        for f in dataclasses.fields(x):
            same(getattr(x, f.name), getattr(y, f.name), f"block {i} {f.name}")
    for f in ("input_nodes", "num_input", "output_nodes", "num_output",
              "overflowed"):
        same(getattr(a, f), getattr(b, f), f)


def small_input_phase(dev, model="graphsage", fanout=(10, 3), blocks=False,
                      **kw):
    """The port's step on the card agrees with the same step on the CPU;
    with ``blocks``, each step's sampled batch too, exactly."""
    import torch

    cpu, gpu = small_engines(dev, model, fanout=fanout, **kw)
    gen = torch.Generator().manual_seed(1)
    shapes = cpu.uniform_shapes(cpu.dedup_last_hop)
    for seeds, n, step in cpu.shuffler.batches(0):
        rand = [torch.rand(s, generator=gen) for s in shapes]
        if blocks:
            check_batches_equal(
                cpu.sample(torch.as_tensor(seeds), n, rand,
                           cpu.dedup_last_hop),
                gpu.sample(torch.as_tensor(seeds, device=dev), n,
                           [r.to(dev) for r in rand], gpu.dedup_last_hop),
                f"{model} {cpu.cfg.sample_type.value} step {step}")
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
    from fgnn_tpu_torch.data import make_synthetic_dataset

    t0 = time.perf_counter()
    ds = make_synthetic_dataset(num_node=1_000_000, avg_degree=15,
                                feat_dim=128, num_class=NUM_CLASS,
                                train_frac=0.25, seed=0)
    print(f"  dataset: {ds.num_node} nodes, {ds.num_edge} edges "
          f"({time.perf_counter() - t0:.1f} s on the host)")
    return ds


def main_path_phase(dev, card, ds):
    import torch
    from fgnn_tpu_torch.config import RunConfig, SampleType
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
    counts = dict(cuda_lib.launches)
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
    check_kernel_steps(counts, SAGE_KERNEL_STEPS, steps)
    return launches, eng, counts


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
        # plain version and library call are one op here: torch.add(x, 1)
        k_ms, p_ms = median_ms([lambda: stream_add_one(full, chunk),
                                lambda: stream_add_one_reference(full)])
        timing[chunk] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": p_ms,
                         "bound_ms": bound_ms(moved)}
        print(f"  [{n}, {d}] f32 chunk {chunk}: kernel {k_ms:.4f} ms "
              f"({moved / k_ms / 1e6:.1f} GB/s r+w), plain x + 1 "
              f"{p_ms:.4f} ms ({moved / p_ms / 1e6:.1f} GB/s); bound "
              f"{bound_ms(moved):.4f} ms ({card})")
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
    from fgnn_tpu_torch.config import RunConfig
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


def check_kernel_steps(counts, per_step, steps):
    """Each kernel of ``per_step`` launched its count a step over ``steps``
    steps, by the launch counts ``counts``."""
    for name, n in per_step.items():
        got = counts.get(name, 0)
        print(f"  {name} launches {got} over {steps} steps "
              f"({got / steps:g} a step)")
        check(got == n * steps, f"{got} {name} launches for {steps} steps, "
              f"not {n} a step")


def train_phase(dev, card, ds, eng, launches_per_step, below_uniform=True,
                kernel_steps=None, counts=None):
    """Two epochs through run_epochs, then evaluate() on the test set.
    Gates: finite losses, epoch 1 below epoch 0 (and below ln 172, the
    loss of a uniform guess, if ``below_uniform``), no cap overflow,
    ``launches_per_step`` row-gather launches a step (and each kernel of
    ``kernel_steps`` its count a step), accuracy in (1/172, 1]. Every
    kernel's launches over the two epochs go into ``counts``. Returns
    (results, launches)."""
    import torch
    from fgnn_tpu_torch.ops import cuda_lib

    torch.cuda.reset_peak_memory_stats(dev)
    cuda_lib.reset_launches()
    results = eng.run_epochs(0, 2)
    launches = cuda_lib.launches.get("gather_rows", 0)
    if counts is not None:
        counts.update(cuda_lib.launches)
    seen = dict(cuda_lib.launches)
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
    check_kernel_steps(seen, kernel_steps or {}, steps)
    check(1.0 / NUM_CLASS < acc <= 1.0, f"evaluate() accuracy {acc}")
    return results, launches


def gcn_phase(dev, card, ds):
    """GCN of the source paper's Table 1 (exp/table1/run.py: fanout 5 10
    15) at full width: two epochs through run_epochs, then evaluate()."""
    from fgnn_tpu_torch.config import SampleType

    eng = big_engine(dev, ds, model="gcn", fanout=(5, 10, 15),
                     sample_type=SampleType.KHOP2)
    check(eng.dedup_last_hop and eng.plan.tier_layout is None,
          "GCN must dedup its last hop, untiered")
    first_step_phase(dev, eng, lambda seeds, n: numpy_first_step_edges(
        ds, eng, seeds, n), "NumPy sampler")
    # per step: the feature gather and the three layers' gather_src; each
    # layer's segment sum and, in the backward, its scatter-add
    counts = {}
    launches = train_phase(dev, card, ds, eng, 4,
                           kernel_steps=GCN_KERNEL_STEPS, counts=counts)[1]
    return launches, eng, counts


def segment_kernel_phase(dev, card, engines):
    """Phase 38 (see the module docstring). Returns the results of
    ``tools.segment_kernels.run``."""
    import torch
    from fgnn_tpu_torch.tools import segment_kernels

    t0 = time.perf_counter()
    results = segment_kernels.run(dev, card, engines)
    print(f"  {len(results)} blocks checked and timed in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    edges = segment_kernels.edge_cases(dev, torch.Generator(dev).manual_seed(1))
    print(f"  {len(edges)} K5 edge cases in {time.perf_counter() - t0:.1f} s; "
          "largest error "
          f"{max(max(e.values()) for e in edges.values()):.3g}")
    return results


def pinsage_phase(dev, card, ds):
    """PinSAGE at the reference app's configuration (RunConfig and
    examples/common_config.py defaults: 3 hops of num_neighbor 5, 4 walks
    of length 3, restart 0.5): two epochs through run_epochs, then
    evaluate()."""
    from fgnn_tpu_torch.config import SampleType

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
    from fgnn_tpu_torch.config import SampleType

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


def cache_small_phase(dev):
    """Host-resident table on a small input, static cache (PRESAMPLE 25%,
    the presample's uniforms injected) and dynamic cache: three steps on
    the card against the CPU from the same parameters and uniforms, misses
    and edges equal, losses within 1e-4 (float32 sums in another order);
    then each combine on the card bit-equal to its plain version."""
    import torch
    from fgnn_tpu_torch.cache.dynamic import combine_feats, combine_feats_reference
    from fgnn_tpu_torch.cache.manager import combine_reference
    from fgnn_tpu_torch.config import CachePolicy, RunConfig, SampleType
    from fgnn_tpu_torch.data import make_synthetic_dataset
    from fgnn_tpu_torch.engine import OneChipEngine

    ds = make_synthetic_dataset(num_node=2000, avg_degree=8, feat_dim=32,
                                num_class=8, train_frac=0.5, seed=42)
    base = RunConfig(model="graphsage", fanout=(10, 3), batch_size=128,
                     num_hidden=32, sample_type=SampleType.KHOP2, dropout=0.0,
                     lr=0.003, compute_dtype="float32")
    # the presample draws are fixed per (epoch, step); their shapes are the
    # dedup sampler's under the plan, which the cache does not change
    shapes = OneChipEngine(base, ds, "cpu", feat_budget=0).uniform_shapes(True)

    def draws(epoch, step, device="cpu"):
        gen = torch.Generator().manual_seed(1000 * epoch + step)
        return [torch.rand(s, generator=gen).to(device) for s in shapes]

    for policy, pct in ((CachePolicy.PRESAMPLE, 0.25),
                        (CachePolicy.DYNAMIC_CACHE, 0.1)):
        cfg = base.replace(cache_policy=policy, cache_percentage=pct)
        cpu = OneChipEngine(cfg, ds, "cpu", feat_budget=0,
                            presample_rand=draws)
        gpu = OneChipEngine(cfg, ds, dev, feat_budget=0,
                            presample_rand=lambda e, s: draws(e, s, dev))
        gpu.model.load_state_dict(cpu.model.state_dict())
        check(not gpu.feat_on_device and gpu.dedup_last_hop,
              "the small cached engine must keep its table on the host")
        if cpu.cache is not None:
            check(torch.equal(cpu.cache.cache_table,
                              gpu.cache.cache_table.cpu()),
                  "presample rankings differ between card and CPU")
        gen = torch.Generator().manual_seed(3)
        for seeds, n, step in cpu.shuffler.batches(0):
            rand = [torch.rand(s, generator=gen) for s in shapes]
            lc, _, ec, _ = cpu.step(torch.as_tensor(seeds), n, rand)
            lg, _, eg, _ = gpu.step(torch.as_tensor(seeds, device=dev), n,
                                    [r.to(dev) for r in rand])
            check(cpu.last_rows == gpu.last_rows,
                  f"{policy.name} step {step}: (misses, rows) cpu "
                  f"{cpu.last_rows} gpu {gpu.last_rows}")
            check(int(ec) == int(eg), f"step {step}: edges {int(ec)} != {int(eg)}")
            check(abs(float(lc) - float(lg)) < 1e-4,
                  f"{policy.name} step {step}: loss cpu {float(lc)} gpu "
                  f"{float(lg)}")
            print(f"  {policy.name} {pct:.0%} step {step}: loss cpu "
                  f"{float(lc):.6f} gpu {float(lg):.6f}, misses/rows "
                  f"{gpu.last_rows}, edges {int(eg)}")
            if step == 2:
                break
        batch = gpu.sample(torch.as_tensor(seeds, device=dev), n,
                           [r.to(dev) for r in rand], True)
        if gpu.cache is not None:
            index = gpu.cache.get_miss_cache_index(batch.input_nodes)
            rows, miss, _ = gpu.cache.upload_miss(index)
            out = gpu.cache.combine(index, rows, miss)
            ref = combine_reference(gpu.cache.cache_data, index, rows)
        else:
            dyn = gpu.dyn_cache
            split = dyn.split_and_advance(batch.input_nodes)
            f = dyn.host.fetch(split.miss_ids,
                               torch.stack([split.num_miss, split.num_hit]))
            rows, (miss, _), ready = dyn.host.load(f, dyn.dtype)
            dyn.host.ready(ready)
            out = combine_feats(dyn.state.feats, split, rows, miss)
            ref = combine_feats_reference(dyn.state.feats, split, rows)
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"{policy.name} combine != plain version")
        print(f"  {policy.name} combine on the card bit-equal to its plain "
              f"version ({miss} misses of {int(batch.num_input)} rows)")


def host_engine(dev, ds, **kw):
    """The GraphSAGE main-path configuration (bench.py) with the feature
    table in host memory, and ``kw`` on top."""
    from fgnn_tpu_torch.config import RunConfig, SampleType
    from fgnn_tpu_torch.engine import OneChipEngine

    cfg = RunConfig(model="graphsage", fanout=(25, 10), batch_size=8000,
                    num_hidden=256, sample_type=SampleType.KHOP2, dropout=0.5,
                    lr=0.003, compute_dtype="bfloat16").replace(**kw)
    t0 = time.perf_counter()
    eng = OneChipEngine(cfg, ds, dev, feat_budget=0)
    check(not eng.feat_on_device and eng.dedup_last_hop,
          "feat_budget=0 must keep the table on the host and dedup every hop")
    print(f"  engine init {time.perf_counter() - t0:.1f} s "
          f"({cfg.cache_policy.name if cfg.use_cache else 'no cache'} "
          f"{cfg.cache_percentage:.0%}); final input cap "
          f"{eng.plan.final_input_cap}")
    return eng


def host_epochs(dev, card, eng, label, n=1, start=0):
    """``n`` epochs through run_epochs with the launch count, the host
    gather's and upload's counters and the peak memory taken over them."""
    import torch
    from fgnn_tpu_torch.ops import cuda_lib

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    eng.host_feat.reset_counters()
    cuda_lib.reset_launches()
    results = eng.run_epochs(start, n)
    launches = cuda_lib.launches.get("gather_rows", 0)
    peak = torch.cuda.max_memory_allocated(dev)
    c = eng.host_feat.counters()
    for r in results:
        r["hit_rate"] = 1.0 - r["miss_bytes"] / r["feature_bytes"]
        print(f"  {label} epoch {r['epoch']}: loss {r['loss']:.4f} acc "
              f"{r['acc']:.4f} epoch_time {r['epoch_time']:.4f} s (mean step "
              f"{r['epoch_time'] / r['num_step'] * 1e3:.2f} ms over "
              f"{r['num_step']}); hit rate {r['hit_rate']:.4f}; miss_bytes "
              f"{r['miss_bytes']} of feature_bytes {r['feature_bytes']}; "
              f"sampled_edges {r['sampled_edges']} ({card})")
    steps = sum(r["num_step"] for r in results)
    print(f"  {label}: gather_rows launches {launches} ({launches / steps:g} "
          f"a step); host gather {c['gather_rows']} rows, {c['gather_bytes']} "
          f"B in {c['gather_s']:.4f} s = "
          f"{c['gather_bytes'] / max(c['gather_s'], 1e-9) / 1e9:.2f} GB/s; "
          f"pinned upload {c['upload_bytes']} B in {c['upload_ms']:.4f} ms "
          f"device time = {c['upload_bytes'] / max(c['upload_ms'], 1e-9) / 1e6:.2f}"
          f" GB/s; overflow {eng.last_overflowed}; peak memory {peak} B "
          f"({card})")
    check(not eng.last_overflowed, f"{label}: an epoch overflowed its caps")
    return results, launches, steps


def profiled_epoch(dev, card, label, fn, plain_s):
    """Run ``fn`` (an epoch) under torch.profiler and print the card's busy
    seconds (``tools/factored_epochs.busy_share``) over the profiled wall
    time and over ``plain_s``, the same engine's last epoch without the
    profiler: the profiler slows the host's launch path, so the first share
    reads low. Then the top kernels by device time."""
    from fgnn_tpu_torch.tools.factored_epochs import busy_share

    b = busy_share(dev, fn)
    print(f"  {label} under torch.profiler: wall {b['wall_s']:.4f} s, card "
          f"busy {b['busy_s']:.4f} s = {b['busy_share']:.1%} of it, "
          f"{b['busy_s'] / plain_s:.1%} of the unprofiled epoch's "
          f"{plain_s:.4f} s; top device time: "
          + ", ".join(f"{n[:40]} {ms:.1f} ms" for n, ms in b["top_kernels_ms"])
          + f" ({card})")


def cache_stages(dev, card, eng, steps=8):
    """Where a static-cache step's time goes: ``steps`` steps run stage by
    stage with a sync after each (host clock), medians in ms. The host
    gather (conversion included) and the upload are split by the loader's
    own counters (host clock and CUDA events)."""
    import statistics

    import torch

    host, cache = eng.host_feat, eng.cache
    seeds_all, nums_all = eng.shuffler.epoch_arrays(5)
    gen = torch.Generator(dev).manual_seed(9)
    names = ("sample", "split", "ids to host", "gather+upload", "combine",
             "train")
    spans = {k: [] for k in names + ("host gather", "upload")}
    for i in range(steps):
        t = [time.perf_counter()]

        def stage():
            torch.cuda.synchronize()
            t.append(time.perf_counter())

        batch = eng.sample(torch.as_tensor(seeds_all[i], device=dev),
                           int(nums_all[i]), gen, True)
        stage()
        index = cache.get_miss_cache_index(batch.input_nodes)
        stage()
        f = host.fetch(index.miss_ids, torch.stack([index.num_miss,
                                                    index.num_hit]))
        stage()
        host.reset_counters()
        rows, (miss, _), ready = host.load(f, cache.dtype)
        host.ready(ready)
        stage()
        c = host.counters()
        feats = cache.combine(index, rows, miss)
        stage()
        eng.train_on(batch, feats)
        stage()
        for k, a, b in zip(names, t, t[1:]):
            spans[k].append((b - a) * 1e3)
        spans["host gather"].append(c["gather_s"] * 1e3)
        spans["upload"].append(c["upload_ms"])
    med = {k: statistics.median(v) for k, v in spans.items()}
    print(f"  synced stages of a PRESAMPLE 10% step, median of {steps} (ms): "
          + ", ".join(f"{k} {v:.2f}" for k, v in med.items())
          + f"; sum of stages {sum(med[k] for k in names):.2f} ({card})")


def cache_phase(dev, card, ds):
    """Phase 15 (see the module docstring). Returns the row-gather launches
    over its full runs."""
    import torch
    from fgnn_tpu_torch.cache.manager import combine_reference
    from fgnn_tpu_torch.config import CachePolicy

    # --- hit rates by policy ---------------------------------------------
    hits = {}
    for policy in (CachePolicy.PRESAMPLE, CachePolicy.DEGREE,
                   CachePolicy.RANDOM):
        for pct in CACHE_SHARES:
            eng = host_engine(dev, ds, cache_policy=policy,
                              cache_percentage=pct)
            (r,), _, _ = host_epochs(dev, card, eng, f"{policy.name} {pct:.0%}")
            hits[policy.name, pct] = r["hit_rate"]
            del eng
    print("  hit rates (one epoch each): " + "; ".join(
        f"{p} {s:.0%} {h:.4f}" for (p, s), h in hits.items()) + f" ({card})")
    for pct in CACHE_SHARES:
        pre = hits["PRESAMPLE", pct]
        check(pre > hits["DEGREE", pct] and pre > hits["RANDOM", pct],
              f"presample's hit rate {pre} is not above degree's and "
              f"random's at {pct:.0%}")
        check(abs(hits["RANDOM", pct] - pct) < 0.02,
              f"random's hit rate {hits['RANDOM', pct]} is not within 2 "
              f"points of {pct:.0%}")

    # --- the static combine at the main path's shapes ---------------------
    eng = host_engine(dev, ds, cache_policy=CachePolicy.PRESAMPLE,
                      cache_percentage=0.1)
    check(eng.pipelined, "PRESAMPLE 10% must run the pipelined epoch")
    seeds_all, nums_all = eng.shuffler.epoch_arrays(0)
    batch = eng.sample(torch.as_tensor(seeds_all[0], device=dev),
                       int(nums_all[0]), torch.Generator(dev).manual_seed(7),
                       True)
    index = eng.cache.get_miss_cache_index(batch.input_nodes)
    rows, miss, hit = eng.cache.upload_miss(index)
    out = eng.cache.combine(index, rows, miss)
    ref = combine_reference(eng.cache.cache_data, index, rows)
    torch.cuda.synchronize()
    check(torch.equal(out, ref), "static combine != plain version at the "
          "main path's shapes")
    print(f"  combine bit-equal to its plain version: cache "
          f"{list(eng.cache.cache_data.shape)} bf16, {index.hit.shape[0]} ids, "
          f"{hit} hits, {miss} misses")
    del batch, index, rows, out, ref

    # --- full runs --------------------------------------------------------
    results, launches, steps = host_epochs(dev, card, eng,
                                           "PRESAMPLE 10% pipelined", n=2)
    check(launches == 3 * steps, f"{launches} launches for {steps} steps "
          "(the combine and two gather_src a step)")
    l0, l1 = results[0]["loss"], results[1]["loss"]
    check(math.isfinite(l0) and math.isfinite(l1), f"losses {l0}, {l1}")
    check(l1 < l0, f"epoch-1 loss {l1} is not below epoch 0's {l0}")
    check(l1 < math.log(NUM_CLASS), f"epoch-1 loss {l1} is not below ln 172")
    total = launches
    profiled_epoch(dev, card, "PRESAMPLE 10% pipelined epoch 2",
                   lambda: eng.run_epoch(2), results[1]["epoch_time"])
    # the host gather shares the host's cores with the thread that launches
    # the card's work: one epoch with half the intra-op threads
    threads = torch.get_num_threads()
    torch.set_num_threads(max(threads // 2, 1))
    try:
        host_epochs(dev, card, eng, f"PRESAMPLE 10% pipelined, "
                    f"{torch.get_num_threads()} of {threads} host threads",
                    start=3)
    finally:
        torch.set_num_threads(threads)
    cache_stages(dev, card, eng)
    del eng

    eng = host_engine(dev, ds, cache_policy=CachePolicy.PRESAMPLE,
                      cache_percentage=0.1, pipeline=False)
    check(not eng.pipelined, "pipeline=False must run the synchronous epoch")
    host_epochs(dev, card, eng, "PRESAMPLE 10% synchronous")
    del eng

    for label, kw, per_step in (
            ("no cache (host path)", {}, 2),
            ("DYNAMIC_CACHE pipelined",
             dict(cache_policy=CachePolicy.DYNAMIC_CACHE, cache_percentage=0.1),
             3)):
        eng = host_engine(dev, ds, **kw)
        (r,), launches, steps = host_epochs(dev, card, eng, label)
        check(math.isfinite(r["loss"]), f"{label}: loss {r['loss']}")
        check(launches == per_step * steps,
              f"{label}: {launches} launches for {steps} steps")
        total += launches
        del eng
    return total


# --- phases 16-19: KHOP1, the weighted samplers and arch0 -------------------

def remap_phase(dev, card, ds):
    """The direct-index dedup against the one-sort dedup on the main path's
    two hops (GraphSAGE [25, 10], batch 8000: hop 0 dedups on the main
    path, hop 1 on the host-resident path and GCN's): equal outputs, and
    both timed with CUDA events; the one-sort dedup with counts (GCN's)
    too, its first four outputs equal to the call's without."""
    import torch
    from fgnn_tpu_torch.config import SampleType
    from fgnn_tpu_torch.ops.hashtable import (unique_and_remap,
                                              unique_and_remap_direct)
    from fgnn_tpu_torch.ops.sampling import sample_layer
    from fgnn_tpu_torch.tools.gather_campaign import median_ms

    eng = big_engine(dev, ds, model="graphsage", fanout=(25, 10),
                     sample_type=SampleType.KHOP2)
    plan, graph = eng.plan, eng.graph
    seeds_all, nums_all = eng.shuffler.epoch_arrays(0)
    cur = torch.as_tensor(seeds_all[0], device=dev)
    num = torch.tensor(int(nums_all[0]), dtype=torch.int32, device=dev)
    gen = torch.Generator(dev).manual_seed(11)
    times = {}
    for hop in range(plan.num_layer):
        nbrs, _ = sample_layer(graph, cur, plan.fanouts[hop], SampleType.KHOP2,
                               gen)
        cap = plan.num_unique_cap[hop]
        sort = unique_and_remap(cur, num, nbrs, cap)
        direct = unique_and_remap_direct(cur, num, nbrs, cap, ds.num_node)
        counted = unique_and_remap(cur, num, nbrs, cap, with_counts=True)
        for name, x, y, z in zip(("unique", "num_unique", "locals", "overflow"),
                                 sort, direct, counted):
            check(torch.equal(x, y), f"hop {hop}: direct remap {name} != "
                  "the one-sort dedup's")
            check(torch.equal(x, z), f"hop {hop}: the dedup with counts: "
                  f"{name} != the one without")
        s_ms, c_ms, d_ms = median_ms([
            lambda: unique_and_remap(cur, num, nbrs, cap),
            lambda: unique_and_remap(cur, num, nbrs, cap, with_counts=True),
            lambda: unique_and_remap_direct(cur, num, nbrs, cap, ds.num_node)],
            inner=2)
        times[hop] = (s_ms, c_ms, d_ms)
        print(f"  hop {hop}: {cur.shape[0]} frontier slots, {nbrs.shape[0]} "
              f"picks, cap {cap}, {int(sort[1])} unique: one-sort dedup "
              f"{s_ms:.4f} ms, with counts {c_ms:.4f} ms, direct-index dedup "
              f"{d_ms:.4f} ms over a {ds.num_node}-node table, outputs equal "
              f"({card})")
        cur, num = sort[0], sort[1]
    del eng
    return times


def other_samplers_small_phase(dev):
    """Phase 16's card-against-CPU runs: each new sampler's blocks exact,
    losses within 1e-4."""
    from fgnn_tpu_torch.config import SampleType

    for model, fanout, st in (
            ("graphsage", (10, 3), SampleType.KHOP1),
            ("graphsage", (10, 3), SampleType.WEIGHTED_KHOP),
            ("graphsage", (10, 3), SampleType.WEIGHTED_KHOP_HASH_DEDUP),
            ("gcn", (5, 10, 15), SampleType.WEIGHTED_KHOP_PREFIX)):
        print(f"  {model} {list(fanout)} {st.value}:")
        small_input_phase(dev, model=model, fanout=fanout, blocks=True,
                          sample_type=st)


def alias_tables(ds):
    """The weighted samplers' tables of the 1M graph, built once."""
    from fgnn_tpu_torch.data import build_alias_tables

    t0 = time.perf_counter()
    build_alias_tables(ds, seed=0)
    print(f"  build_alias_tables: {ds.num_edge} edges in "
          f"{time.perf_counter() - t0:.1f} s on the host")


def pick_frequency_phase(dev, card, ds, graph):
    """Pick frequencies on the card for vertices of degree above 128 and
    of degree 26-128: alias and prefix within TV_BOUND of the normalised
    weights from ~1M draws; hash-dedup picks distinct, min(deg, fanout) of
    them outside the stream branch's shortfall rows."""
    import numpy as np
    import torch
    from fgnn_tpu_torch.config import SampleType
    from fgnn_tpu_torch.ops import sampling

    indptr = np.asarray(ds.indptr)
    deg = np.diff(indptr)
    rng = np.random.default_rng(4)
    verts = np.concatenate([
        rng.choice(np.nonzero(deg > 128)[0], 3, replace=False),
        rng.choice(np.nonzero((deg >= 26) & (deg <= 128))[0], 3,
                   replace=False)])
    prefix = np.asarray(ds.prob_prefix_table, np.float64)
    gen = torch.Generator(dev).manual_seed(5)
    fanout, rows = 25, 40_000
    worst = 0.0
    for v in verts:
        o, d = int(indptr[v]), int(deg[v])
        w = np.concatenate([prefix[o:o + 1], np.diff(prefix[o:o + d])])
        # by neighbour id (the synthetic graph may repeat an id in a list)
        ids = np.asarray(ds.indices[o:o + d])
        p = np.bincount(ids, weights=w / w.sum(), minlength=ds.num_node)
        inputs = torch.full((rows,), int(v), dtype=torch.int32, device=dev)
        for st in (SampleType.WEIGHTED_KHOP, SampleType.WEIGHTED_KHOP_PREFIX):
            nbrs, valid = sampling.sample_layer(graph, inputs, fanout, st, gen)
            check(bool(valid.all()), f"{st.value}: a pick of vertex {v} is "
                  "invalid")
            emp = np.bincount(nbrs.cpu().numpy(), minlength=ds.num_node)
            tv = 0.5 * np.abs(emp / emp.sum() - p).sum()
            worst = max(worst, tv)
            print(f"  vertex {v} (deg {d}) {st.value}: {rows * fanout} "
                  f"draws, total variation from the weights {tv:.5f}")
            check(tv < TV_BOUND, f"{st.value} vertex {v}: TV {tv} >= "
                  f"{TV_BOUND}")
        # hash-dedup on CSR slots (the sampler's own unit)
        t = torch.tensor([o], device=dev)
        dd = torch.tensor([d], dtype=torch.int32, device=dev)
        width = sampling.draw_width(SampleType.WEIGHTED_KHOP_HASH_DEDUP, fanout)
        u = torch.rand((4000, width), generator=gen, device=dev)
        picks, ok = sampling._weighted_gumbel_dedup(
            u, dd.expand(4000), t.expand(4000), graph, fanout)
        picks, ok = picks.cpu().numpy(), ok.cpu().numpy()
        counts = ok.sum(1)
        for row, m in zip(picks, ok):
            check(len(set(row[m].tolist())) == int(m.sum()),
                  f"hash-dedup vertex {v}: a repeated pick")
        short = int((counts < min(d, fanout)).sum())
        if d <= sampling.GUMBEL_MAX_DEG:
            check(short == 0, f"hash-dedup vertex {v} (Gumbel branch): "
                  f"{short} rows short of {min(d, fanout)} picks")
        print(f"  vertex {v} (deg {d}) hash-dedup: 4000 rows of distinct "
              f"picks, {short} short of {min(d, fanout)} (stream branch "
              f"shortfall rows: {short / 4000:.2%})")
    print(f"  worst total variation {worst:.5f} (bound {TV_BOUND}) ({card})")


def with_replacement_edges(eng, batch):
    """The independent count of a with-replacement sampler's edges: per
    hop, fanout times the frontier's valid vertices of degree > 0, the
    frontier read from the unique list's prefix."""
    import numpy as np

    indptr = np.asarray(eng.ds.indptr)
    inputs = batch.input_nodes.cpu().numpy()
    want = []
    for hop in range(eng.plan.num_layer):
        front = inputs[:eng.plan.num_input_cap[hop]]
        if hop == 0:
            front = front[:int(batch.num_output)]
        front = front[front >= 0]
        want.append(eng.plan.fanouts[hop]
                    * int((indptr[front + 1] - indptr[front] > 0).sum()))
    return want


def other_sampler_runs(dev, card, ds):
    """Phase 17's runs at batch 8000, hidden 256, bf16. Returns the row
    gather's launches over them."""
    import torch
    from fgnn_tpu_torch.config import SampleType
    from fgnn_tpu_torch.ops import cuda_lib

    total = 0
    for label, kw, n_epochs, per_step in (
            ("GraphSAGE [25, 10] WEIGHTED_KHOP",
             dict(model="graphsage", fanout=(25, 10),
                  sample_type=SampleType.WEIGHTED_KHOP), 2, 2),
            ("GCN [5, 10, 15] WEIGHTED_KHOP_PREFIX",
             dict(model="gcn", fanout=(5, 10, 15),
                  sample_type=SampleType.WEIGHTED_KHOP_PREFIX), 1, 4),
            ("GraphSAGE [25, 10] WEIGHTED_KHOP_HASH_DEDUP",
             dict(model="graphsage", fanout=(25, 10),
                  sample_type=SampleType.WEIGHTED_KHOP_HASH_DEDUP), 1, 2),
            ("GraphSAGE [25, 10] KHOP1",
             dict(model="graphsage", fanout=(25, 10),
                  sample_type=SampleType.KHOP1), 1, 2)):
        print(f"  {label}:")
        eng = big_engine(dev, ds, **kw)
        check(eng.plan.tier_layout is None, f"{label}: a tier layout")
        seeds_all, nums_all = eng.shuffler.epoch_arrays(0)
        batch = eng.sample(torch.as_tensor(seeds_all[0], device=dev),
                           int(nums_all[0]), torch.Generator(dev).manual_seed(1),
                           eng.dedup_last_hop)
        per_hop = [int(b.mask.sum()) for b in reversed(batch.blocks)]
        check(not bool(batch.overflowed), f"{label}: first batch overflowed")
        if eng.cfg.sample_type != SampleType.WEIGHTED_KHOP_HASH_DEDUP:
            want = with_replacement_edges(eng, batch)
            print(f"  first step sampled edges per hop: card {per_hop}, "
                  f"host count of fanout x [deg > 0] {want}")
            check(per_hop == want, f"{label}: edges {per_hop} != {want}")
        else:
            print(f"  first step sampled edges per hop: card {per_hop}")
        del batch
        if n_epochs == 2:
            results, launches = train_phase(dev, card, ds, eng, per_step)
            profiled_epoch(dev, card, "epoch 2", lambda: eng.run_epoch(2),
                           results[-1]["epoch_time"])
        else:
            torch.cuda.reset_peak_memory_stats(dev)
            cuda_lib.reset_launches()
            (r,) = eng.run_epochs(0, 1)
            launches = cuda_lib.launches.get("gather_rows", 0)
            peak = torch.cuda.max_memory_allocated(dev)
            print(f"  epoch 0: loss {r['loss']:.4f} acc {r['acc']:.4f} "
                  f"sampled_edges {r['sampled_edges']} epoch_time "
                  f"{r['epoch_time']:.4f} s, mean step "
                  f"{r['epoch_time'] / r['num_step'] * 1e3:.2f} ms over "
                  f"{r['num_step']} steps; gather_rows launches {launches} "
                  f"({launches / r['num_step']:g} a step); peak memory {peak} "
                  f"B ({card})")
            check(math.isfinite(r["loss"]), f"{label}: loss {r['loss']}")
            check(not eng.last_overflowed, f"{label}: the epoch overflowed")
            check(launches == per_step * r["num_step"],
                  f"{label}: {launches} launches for {r['num_step']} steps")
        total += launches
        del eng
    return total


def other_samplers_phase(dev, card, ds):
    """Phase 17 (see the module docstring)."""
    from fgnn_tpu_torch.config import SampleType

    alias_tables(ds)
    eng = big_engine(dev, ds, model="graphsage", fanout=(25, 10),
                     sample_type=SampleType.WEIGHTED_KHOP_HASH_DEDUP)
    pick_frequency_phase(dev, card, ds, eng.graph)
    del eng
    return other_sampler_runs(dev, card, ds)


def arch0_small_phase(dev):
    """arch0 on a small input: HostSamplingEngine on the card and on the
    CPU from the same parameters draws the same host batches, and the
    losses agree within 1e-4."""
    from fgnn_tpu_torch.config import SampleType
    from fgnn_tpu_torch.host_engine import HostSamplingEngine

    ds = small_dataset()
    for model, kw in (
            ("graphsage", dict(fanout=(10, 3), sample_type=SampleType.KHOP2)),
            ("graphsage", dict(fanout=(10, 3),
                               sample_type=SampleType.WEIGHTED_KHOP)),
            ("pinsage", dict(sample_type=SampleType.RANDOM_WALK))):
        cfg = small_config(model, **kw)
        cpu = HostSamplingEngine(cfg, ds, "cpu")
        gpu = HostSamplingEngine(cfg, ds, dev)
        gpu.model.load_state_dict(cpu.model.state_dict())
        for seeds, n, step in cpu.shuffler.batches(0):
            lc, _, bc = cpu.step(seeds, n)
            lg, _, bg = gpu.step(seeds, n)
            check_batches_equal(bc, bg, f"arch0 {model} step {step}")
            check(abs(float(lc) - float(lg)) < 1e-4,
                  f"arch0 {model} step {step}: loss cpu {float(lc)} gpu "
                  f"{float(lg)}")
            print(f"  {model} {cfg.sample_type.value} step {step}: loss cpu "
                  f"{float(lc):.6f} gpu {float(lg):.6f}, host batches equal")
            if step == 2:
                break


def arch0_engine(dev, ds, **kw):
    """arch0 at the bench configuration (GraphSAGE [25, 10], batch 8000,
    hidden 256; float32, as the reference's arch0), ``kw`` on top."""
    from fgnn_tpu_torch.config import RunConfig, SampleType
    from fgnn_tpu_torch.host_engine import HostSamplingEngine

    cfg = RunConfig(model="graphsage", fanout=(25, 10), batch_size=8000,
                    num_hidden=256, sample_type=SampleType.KHOP2, dropout=0.5,
                    lr=0.003).replace(**kw)
    t0 = time.perf_counter()
    eng = HostSamplingEngine(cfg, ds, dev)
    print(f"  arch0 engine init {time.perf_counter() - t0:.1f} s; plan "
          f"{eng.plan}")
    return eng


def arch0_epochs(dev, card, eng, label, per_step, n=1, start=0):
    """``n`` epochs with the launch count, the host gather's counters and
    the peak memory over them."""
    import torch
    from fgnn_tpu_torch.ops import cuda_lib

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    eng.host_feat.reset_counters()
    cuda_lib.reset_launches()
    results = eng.run_epochs(start, n)
    launches = cuda_lib.launches.get("gather_rows", 0)
    peak = torch.cuda.max_memory_allocated(dev)
    c = eng.host_feat.counters()
    steps = sum(r["num_step"] for r in results)
    for r in results:
        extra = ""
        if "miss_bytes" in r:
            extra = (f"; hit rate "
                     f"{1.0 - r['miss_bytes'] / r['feature_bytes']:.4f}")
        print(f"  {label} epoch {r['epoch']}: loss {r['loss']:.4f} acc "
              f"{r['acc']:.4f} epoch_time {r['epoch_time']:.4f} s (mean step "
              f"{r['epoch_time'] / r['num_step'] * 1e3:.2f} ms over "
              f"{r['num_step']}){extra} ({card})")
    print(f"  {label}: gather_rows launches {launches} ({launches / steps:g} "
          f"a step); host gather {c['gather_rows']} rows, {c['gather_bytes']} "
          f"B in {c['gather_s']:.4f} s = "
          f"{c['gather_bytes'] / max(c['gather_s'], 1e-9) / 1e9:.2f} GB/s; "
          f"upload {c['upload_bytes']} B in {c['upload_ms']:.4f} ms device "
          f"time; overflow {eng.last_overflowed}; peak memory {peak} B "
          f"({card})")
    check(all(math.isfinite(r["loss"]) for r in results),
          f"{label}: losses {[r['loss'] for r in results]}")
    check(not eng.last_overflowed, f"{label}: an epoch overflowed its caps")
    check(launches == per_step * steps,
          f"{label}: {launches} launches for {steps} steps")
    return results, launches


def arch0_stages(dev, card, eng, steps=8):
    """Where an arch0 step's time goes: ``steps`` steps stage by stage with
    a sync after each (host clock), medians in ms; the host gather and the
    feature upload split by the loader's counters (host clock, CUDA
    events)."""
    import statistics

    import numpy as np
    import torch
    from fgnn_tpu_torch.host_engine import batch_to

    host = eng.host_feat
    rng = np.random.default_rng(9)
    names = ("host sample", "batch upload", "host gather + feature upload",
             "train")
    spans = {k: [] for k in names + ("host gather", "feature upload")}
    for seeds, n, i in eng.shuffler.batches(5):
        if i == steps:
            break
        torch.cuda.synchronize()
        t = [time.perf_counter()]

        def stage():
            torch.cuda.synchronize()
            t.append(time.perf_counter())

        hb = eng.sample(rng, seeds, n)
        stage()
        b = batch_to(hb, dev)
        stage()
        host.reset_counters()
        feats = eng.features(hb, b)
        stage()
        c = host.counters()
        eng.train_on(b, feats)
        stage()
        for k, a, z in zip(names, t, t[1:]):
            spans[k].append((z - a) * 1e3)
        spans["host gather"].append(c["gather_s"] * 1e3)
        spans["feature upload"].append(c["upload_ms"])
    med = {k: statistics.median(v) for k, v in spans.items()}
    print(f"  synced stages of an arch0 step, median of {steps} (ms): "
          + ", ".join(f"{k} {v:.2f}" for k, v in med.items())
          + f"; sum of stages {sum(med[k] for k in names):.2f} ({card})")


def arch0_phase(dev, card, ds):
    """Phase 19 (see the module docstring). Returns the row gather's
    launches over its runs."""
    from fgnn_tpu_torch.config import CachePolicy, SampleType

    eng = arch0_engine(dev, ds)
    # every hop dedups: each layer's gather_src launches the row gather
    results, total = arch0_epochs(dev, card, eng, "arch0 GraphSAGE", 2, n=2)
    l0, l1 = results[0]["loss"], results[1]["loss"]
    check(l1 < l0, f"arch0 epoch-1 loss {l1} is not below epoch 0's {l0}")
    arch0_stages(dev, card, eng)
    profiled_epoch(dev, card, "arch0 GraphSAGE epoch 2",
                   lambda: eng.run_epoch(2), results[1]["epoch_time"])
    del eng
    for label, kw, per_step in (
            ("arch0 GraphSAGE PRESAMPLE 10%",
             dict(cache_policy=CachePolicy.PRESAMPLE, cache_percentage=0.1),
             3),
            ("arch0 PinSAGE 3 x 5, W=4, L=3",
             dict(model="pinsage", sample_type=SampleType.RANDOM_WALK,
                  num_layer_rw=3, num_neighbor=5, num_random_walk=4,
                  random_walk_length=3, random_walk_restart_prob=0.5), 3)):
        eng = arch0_engine(dev, ds, **kw)
        _, launches = arch0_epochs(dev, card, eng, label, per_step)
        total += launches
        del eng
    return total


# --- phases 20-21: the entry points and Table 1 ----------------------------

OBSERVE_ENV = ("FGNN_TPU_DUMP_TRACE", "FGNN_TPU_LOG_NODE_ACCESS")
# the trace lanes an observed level-3 step of the device-resident table emits
STEP_LANES = ("kL0Event_Train_Step", "kL1Event_Sample", "kL1Event_Copy",
              "kL1Event_Train", "kL2Event_Sample_Shuffle",
              "kL2Event_Copy_Extract", "kL2Event_Sample_Core",
              "kL2Event_Sample_IdRemap")
APP_ARGS = ["--arch", "arch1", "--model", "graphsage", "--fanout", "25", "10",
            "--batch-size", "8000", "--num-hidden", "256",
            "--synthetic-nodes", "1000000", "--synthetic-train-frac", "0.25"]
APP_KEYS = ("init_time", "epoch_time", "epoch_time:min", "num_step",
            "sample_time", "copy_time", "extract_time", "train_time",
            "init:presample", "init:load_dataset", "init:copy",
            "init:build_cache", "first_epoch_loss", "launches:gather_rows")
APP_L23_ITEMS = ("L2_shuffle_time", "L2_core_sample_time", "L2_id_remap_time",
                 "L2_id_copy_time", "L2_extract_time", "L3_khop_sample_coo_time",
                 "L3_remap_unique_time", "L3_remap_map_edge_time")
STAGE_COLUMNS = ("sample_time", "copy_time", "extract_time", "train_time")


def observe_small_phase(dev):
    """Phase 20's small input (see the module docstring)."""
    import tempfile

    import torch
    import fgnn_tpu_torch.session as sam
    from fgnn_tpu_torch.engine import OneChipEngine
    from fgnn_tpu_torch.train.loop import train_step
    from fgnn_tpu_torch.utils.profiler import Profiler

    ds = small_dataset()
    cfg = small_config("graphsage", fanout=(10, 3), dropout=0.5)

    # observing an epoch does not change it
    Profiler.reset()
    (plain,) = OneChipEngine(cfg, ds, dev).run_epochs(0, 1)
    for k in OBSERVE_ENV:
        os.environ[k] = "1"
    Profiler.reset()
    try:
        eng = OneChipEngine(cfg.replace(profile_level=3, sanity_check=True),
                            ds, dev)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]) as tp:
            (obs,) = eng.run_epochs(0, 1)
        ranges = {e.name for e in tp.events()}
        prof = Profiler.get()
        lanes = prof.lane_summary()
        touched = int((prof.node_access_frequency() > 0).sum())
    finally:
        for k in OBSERVE_ENV:
            os.environ.pop(k, None)
        Profiler.reset()
    check(obs["sampled_edges"] == plain["sampled_edges"],
          f"observed edges {obs['sampled_edges']} != {plain['sampled_edges']}")
    check(abs(obs["loss"] - plain["loss"]) < 1e-5 and
          abs(obs["acc"] - plain["acc"]) < 1e-5,
          f"observed epoch {obs} != plain {plain}")
    missing = [n for n in STEP_LANES if n not in lanes or n not in ranges]
    check(not missing, f"lanes missing from the trace or torch.profiler: "
          f"{missing}")
    check(touched > 0, "node access counted nothing")
    print(f"  level 3 + trace + node access + checker: loss {obs['loss']:.6f} "
          f"(level 1 {plain['loss']:.6f}), edges {obs['sampled_edges']} equal; "
          f"{len(lanes)} lanes, {touched} nodes touched")

    # a session-driven epoch equals run_epoch
    (ref,) = OneChipEngine(cfg, ds, dev).run_epochs(0, 1)
    sam._reset_for_tests()
    sam.config({**{f: getattr(cfg, f) for f in (
        "fanout", "batch_size", "num_hidden", "dropout", "lr", "seed",
        "compute_dtype")}, "model": "graphsage", "arch": 1,
        "sample_type": cfg.sample_type.value})
    sam._session.ds = ds
    sam.sample_init(0, dev)
    eng = sam._session.engine
    losses = []
    for _ in range(sam.steps_per_epoch()):
        sam.sample_once()
        key = sam.get_next_batch()
        _, feats, labels = sam.get_blocks(key, 2)
        loss, _ = train_step(eng.model, eng.optimizer, sam.get_batch(key),
                             feats, labels, eng.dst_caps, cfg.batch_size,
                             generator=eng.dropout_gen)
        losses.append(loss)
        sam.release_batch(key)
    s_loss = float(torch.stack(losses).mean())
    sam.shutdown()
    check(abs(s_loss - ref["loss"]) < 1e-5,
          f"session epoch loss {s_loss} != run_epoch's {ref['loss']}")
    print(f"  session-driven epoch: loss {s_loss:.6f}, run_epoch "
          f"{ref['loss']:.6f}")

    # checkpoint after epoch 0, restored into a new engine
    with tempfile.TemporaryDirectory() as d:
        ccfg = cfg.replace(ckpt_dir=d, ckpt_every=1)
        a = OneChipEngine(ccfg, ds, dev)
        check(a.start_epoch == 0, f"fresh start_epoch {a.start_epoch}")
        a.run_epoch(0)
        saved = {k: v.clone() for k, v in a.model.state_dict().items()}
        b = OneChipEngine(ccfg, ds, dev)
        check(b.start_epoch == 1, f"resumed start_epoch {b.start_epoch}")
        for k, v in b.model.state_dict().items():
            check(torch.equal(v, saved[k]), f"restored {k} != saved")
        ra, rb = a.run_epoch(1), b.run_epoch(1)
    check(abs(ra["loss"] - rb["loss"]) < 1e-5
          and ra["sampled_edges"] == rb["sampled_edges"],
          f"resumed epoch 1 {rb} != uninterrupted {ra}")
    print(f"  checkpoint: resumed at epoch 1, parameters equal the saved "
          f"ones; epoch 1 loss {rb['loss']:.6f} (uninterrupted "
          f"{ra['loss']:.6f})")


def app_phase(card):
    """Phase 20's app runs (see the module docstring). Returns the row
    gather's launches over them."""
    from fgnn_tpu_torch.exp.runner import run_app

    out = os.path.join(REPO, "chiprun_out", "smoke_app")
    runs = {}
    for label, level, epochs, env in (
            ("level1", 1, 2, {}),
            ("level3", 3, 1, {k: "1" for k in OBSERVE_ENV})):
        t0 = time.perf_counter()
        r = run_app(APP_ARGS + ["--profile-level", str(level),
                                "--num-epoch", str(epochs)], out, label,
                    env=env, timeout=600)
        check(r.returncode == 0, f"app {label}: rc {r.returncode}, see "
              f"{r.log_path}")
        v = r.values
        missing = [k for k in APP_KEYS if k not in v]
        check(not missing, f"app {label}: keys missing {missing}")
        steps = int(v["num_step"]) * epochs
        launches = int(v["launches:gather_rows"])
        check(launches == 3 * steps, f"app {label}: {launches} gather_rows "
              f"launches for {steps} steps")
        print(f"  app {label} ({epochs} epochs, {time.perf_counter() - t0:.1f} "
              f"s with its start): epoch_time {v['epoch_time']} s (min "
              f"{v['epoch_time:min']}), init_time {v['init_time']} s, stages "
              + ", ".join(f"{k} {v[k]}" for k in STAGE_COLUMNS)
              + f", first epoch loss {v['first_epoch_loss']}, gather_rows "
              f"launches {launches} ({card})")
        runs[label] = (v, launches)
    v3 = runs["level3"][0]
    zero = [k for k in APP_L23_ITEMS if float(v3.get(k, 0.0)) <= 0.0]
    check(not zero, f"app level 3: L2/L3 items zero or missing: {zero}")
    print("  app level 3 step items (s): " + ", ".join(
        f"{k} {v3[k]}" for k in APP_L23_ITEMS) + f" ({card})")
    with open(os.path.join(out, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    lanes = {e["name"] for e in events if e.get("ph") == "X"}
    missing = [n for n in STEP_LANES if n not in lanes]
    check(not missing, f"app trace: lanes missing {missing}")
    check(os.path.getsize(os.path.join(out, "node_ranking.bin")) > 0,
          "app: node_ranking.bin is empty")
    l1 = float(runs["level1"][0]["first_epoch_loss"])
    l3 = float(v3["first_epoch_loss"])
    check(abs(l1 - l3) <= 1e-4, f"app epoch-0 loss level 1 {l1} != level 3 "
          f"{l3}")
    print(f"  app trace: {len(events)} events on {len(lanes)} lanes; epoch-0 "
          f"loss level 1 {l1}, level 3 {l3}")
    engine_driven(runs["level1"][0], v3, card)
    return sum(n for _, n in runs.values())


def engine_driven(app, app3, card):
    """The app's level-1 configuration driven here through OneChipEngine,
    from the app's own argument parser and dataset loader: its steady epoch
    beside the app's, and the same epoch-0 loss; then eight steps stage by
    stage with a sync after each, beside the app's level-3 stage items of a
    step. This process ran epochs under torch.profiler's CUDA activity
    before (phases 15, 17, 19), which leaves later epochs slower than a
    fresh process runs them (``python -m
    fgnn_tpu_torch.tools.profiler_residue``). These launches are not the
    app's and are not counted."""
    import argparse
    import statistics

    import torch
    from fgnn_tpu_torch.engine import OneChipEngine, device_sync
    from fgnn_tpu_torch.examples import common_config
    from fgnn_tpu_torch.utils.profiler import Profiler

    p = argparse.ArgumentParser()
    p.add_argument("--model", default="graphsage")
    common_config.add_common_arguments(p)
    args = p.parse_args(APP_ARGS + ["--num-epoch", "2"])
    Profiler.reset()
    cfg = common_config.build_run_config(
        args, args.model, common_config.MODEL_SAMPLE_TYPE[args.model])
    eng = OneChipEngine(cfg, common_config.load_app_dataset(args),
                        torch.device(args.device))
    r = [eng.run_epoch(e) for e in range(2)]
    steady = r[1]["epoch_time"]
    check(abs(r[0]["loss"] - float(app["first_epoch_loss"])) <= 1e-4,
          f"engine-driven epoch-0 loss {r[0]['loss']} != the app's "
          f"{app['first_epoch_loss']}")
    print(f"  the app's configuration driven through OneChipEngine here: "
          f"epoch 1 {steady:.4f} s; the app's {app['epoch_time']} s "
          f"({float(app['epoch_time']) / steady - 1:+.1%}) ({card})")
    ms = {"sample": [], "extract": [], "train": []}
    for _, (seeds, n, _) in zip(range(8), eng.shuffler.batches(len(r))):
        device_sync(eng.device)
        t0 = time.perf_counter()
        batch = eng.sample(torch.as_tensor(seeds, device=eng.device), n,
                           eng.sample_gen, eng.dedup_last_hop)
        device_sync(eng.device)
        t1 = time.perf_counter()
        feats = eng.features(batch)
        device_sync(eng.device)
        t2 = time.perf_counter()
        eng.train_on(batch, feats)
        device_sync(eng.device)
        t3 = time.perf_counter()
        for k, dt in zip(ms, (t1 - t0, t2 - t1, t3 - t2)):
            ms[k].append(1e3 * dt)
    steps = int(app3["num_step"])
    items = {"sample": 1e3 * float(app3["sample_time"]) / steps,
             "extract": 1e3 * float(app3["L2_extract_time"]),
             "train": 1e3 * float(app3["train_time"]) / steps}
    print("  synced stages of a step here, median of 8 (ms): " + ", ".join(
        f"{k} {statistics.median(v):.3f}" for k, v in ms.items())
        + "; the app's level-3 items of a step (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in items.items()) + f" ({card})")
    Profiler.reset()


TABLE1_OUT = os.path.join(REPO, "chiprun_out", "smoke_table1")


def start_table1(pool):
    """Phase 21's runner, started on ``pool``: its future."""
    from fgnn_tpu_torch.exp import table1

    return pool.submit(table1.main, ["--num-epoch", "2", "--out-dir",
                                     TABLE1_OUT])


def table1_phase(card, rc):
    """Phase 21's checks (see the module docstring), once its runner has
    returned ``rc``. Returns the row gather's launches over its runs."""
    check(rc == 0, f"table1: rc {rc}")
    with open(os.path.join(TABLE1_OUT, "table1.json")) as f:
        rows = json.load(f)["results"]
    check(len(rows) == 5, f"table1: {len(rows)} rows")
    total = 0
    for r in rows:
        v, name = r["values"], r["config"]["system"]
        check(r["rc"] == 0, f"table1 {name}: rc {r['rc']}")
        check(math.isfinite(float(v["epoch_time"])),
              f"table1 {name}: epoch_time {v['epoch_time']}")
        zero = [k for k in STAGE_COLUMNS if float(v[k]) <= 0.0]
        check(not zero, f"table1 {name}: zero stage columns {zero}")
        launches = int(v["launches:gather_rows"])
        check(launches > 0, f"table1 {name}: no gather_rows launch")
        total += launches
        print(f"  {name}: epoch_time {v['epoch_time']} s (level 2: "
              f"{v['epoch_time_l2']} s); " + ", ".join(
                  f"{k} {v[k]}" for k in STAGE_COLUMNS)
              + f"; gather_rows launches {launches} over "
              f"{int(v['num_step']) * 2} steps ({card})")
    return total


# --- phases 22-28: the multi-device engines (arch5, arch6) on one card -------

# the row gathers of a batch on arch5's main path, in the order it makes
# them: the feature gather and gather_src on both dedup'd hops (the plan has
# no tiers, so no dst_invperm); in cache mode the combine takes the feature
# gather's place
ARCH5_GATHERS = ("feature gather", "layer-1 gather_src", "layer-2 gather_src")
ARCH5_LAUNCHES_PER_BATCH = len(ARCH5_GATHERS)
# arch6 GraphSAGE: the feature gather and the dedup'd hop's gather_src (the
# no-dedup last hop's gather_src is a slice)
ARCH6_GATHERS = ("feature gather", "layer-2 gather_src")
ARCH6_LAUNCHES_PER_BATCH = len(ARCH6_GATHERS)


def multi_device_small_phase(dev):
    """arch5 (S=1 with T=1 and T=2) and arch6 (W=1 and W=2) on the small
    input, every role on the card, against the same engine on the CPU: one
    epoch from the same parameters and CPU-drawn uniforms, the sampled
    edges equal, the loss and the parameters after it within 1e-4."""
    import torch
    from fgnn_tpu_torch.parallel.factored import FactoredEngine, SGNNEngine

    ds = small_dataset()
    for label, cls, n, kw in (
            ("arch5 S=1 T=1", FactoredEngine, 2, {"num_train_worker": 1}),
            ("arch5 S=1 T=2", FactoredEngine, 3, {"num_train_worker": 2}),
            ("arch6 W=1", SGNNEngine, 1, {"num_train_worker": 1}),
            ("arch6 W=2", SGNNEngine, 2, {"num_train_worker": 2})):
        cfg = small_config("graphsage", fanout=(10, 3), **kw)
        shapes = {}

        def draws(epoch, step):
            gen = torch.Generator().manual_seed(1000 * epoch + step)
            return [torch.rand(s, generator=gen) for s in shapes["s"]]

        cpu = cls(cfg, ds, ["cpu"] * n, rand_fn=draws)
        gpu = cls(cfg, ds, [dev] * n, rand_fn=draws)
        shapes["s"] = cpu.uniform_shapes(cpu.dedup_last_hop)
        gpu.model.load_state_dict(cpu.model.state_dict())
        rc, rg = cpu.run_epoch(0), gpu.run_epoch(0)
        err = max(float((p.detach().cpu() - q.detach()).abs().max())
                  for p, q in zip(gpu.model.parameters(),
                                  cpu.model.parameters()))
        check(rc["sampled_edges"] == rg["sampled_edges"],
              f"{label}: edges cpu {rc['sampled_edges']} gpu "
              f"{rg['sampled_edges']}")
        check(abs(rc["loss"] - rg["loss"]) < 1e-4 and err < 1e-4,
              f"{label}: loss cpu {rc['loss']} gpu {rg['loss']}, parameters "
              f"differ by {err}")
        print(f"  {label}: {rg['num_step']} batches, loss cpu "
              f"{rc['loss']:.6f} gpu {rg['loss']:.6f}, parameters max |diff| "
              f"{err:.2e}, edges {rg['sampled_edges']}")


def factored_epochs_phase(card):
    """arch5 (table on the trainer, then cache mode pipelined and
    synchronous) and arch6 (W=1, W=2) at the main path's configuration, in
    a process of its own (``python -m
    fgnn_tpu_torch.tools.factored_epochs``): its epochs run before any
    torch.profiler session of that process, the busy share's epoch last.
    Gates: finite, falling losses, no overflow, the row gather's launches
    per group, the cache mode's two runs bit-equal. Returns the launches
    over its runs."""
    import subprocess

    out_dir = os.path.join(REPO, "chiprun_out", "smoke_factored")
    os.makedirs(out_dir, exist_ok=True)
    log_path = os.path.join(out_dir, "factored_epochs.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        proc = subprocess.run(
            [sys.executable, "-m", "fgnn_tpu_torch.tools.factored_epochs"],
            stdout=f, stderr=subprocess.STDOUT, cwd=REPO, timeout=600)
    with open(log_path) as f:
        lines = f.read().splitlines()
    check(proc.returncode == 0, f"factored_epochs: rc {proc.returncode}, see "
          f"{log_path}")
    print(f"  factored_epochs: {time.perf_counter() - t0:.1f} s with its "
          "start")
    return factored_report(json.loads(lines[-1]))


def factored_report(result):
    """Phase 23's prints and gates over the tool's JSON line; returns the
    row gather's launches over its runs."""
    runs = result["runs"]
    total = 0
    for name, per_batch, batches in (
            ("arch5", ARCH5_LAUNCHES_PER_BATCH, 1),
            ("arch5_cache_pipelined", ARCH5_LAUNCHES_PER_BATCH, 1),
            ("arch5_cache_synchronous", ARCH5_LAUNCHES_PER_BATCH, 1),
            ("arch6_w1", ARCH6_LAUNCHES_PER_BATCH, 1),
            ("arch6_w2", ARCH6_LAUNCHES_PER_BATCH, 2)):
        r = runs[name]
        eps = r["epochs"]
        # a group (arch5, T=1) or a local step (arch6, W batches)
        groups = sum(x["num_step"] for x in eps) // batches
        launches = r["launches"].get("gather_rows", 0)
        total += launches
        for x in eps:
            hit = (f", hit rate {x['hit_rate']:.4f}" if "hit_rate" in x
                   else "")
            print(f"  {name} epoch {x['epoch']}: loss {x['loss']:.4f} acc "
                  f"{x['acc']:.4f} epoch_time {x['epoch_time']:.4f} s over "
                  f"{x['num_step']} batches, {x['sampled_edges']} sampled "
                  f"edges = {x['edges_per_s'] / 1e6:.2f} M edges/s{hit} "
                  f"({result['card']})")
        print(f"  {name}: init {r['init_s']:.2f} s, peak memory "
              f"{r['peak_bytes']} B, gather_rows launches {launches} "
              f"({launches / groups:g} a group of {batches})")
        losses = [x["loss"] for x in eps]
        check(all(math.isfinite(x) for x in losses), f"{name}: losses {losses}")
        check(losses[-1] < losses[0], f"{name}: losses do not fall: {losses}")
        check(not r["overflowed"], f"{name}: an epoch overflowed its caps")
        check(launches == per_batch * batches * groups,
              f"{name}: {launches} gather_rows launches for {groups} groups "
              f"of {batches}")
    check(runs["arch5_cache_bit_equal"], "arch5 cache mode: the pipelined "
          "and synchronous runs differ in losses or parameters")
    busy = runs["arch5_busy"]
    print(f"  arch5 cache mode: pipelined and synchronous bit-equal in losses "
          f"and parameters")
    print(f"  arch5 epoch under torch.profiler: wall {busy['wall_s']:.4f} s, "
          f"card busy {busy['busy_s']:.4f} s = {busy['busy_share']:.1%} of "
          f"it, {busy['busy_share_unprofiled']:.1%} of the last unprofiled "
          f"epoch's {busy['unprofiled_epoch_s']:.4f} s; top kernels (ms): "
          + ", ".join(f"{k[:48]} {v:.1f}" for k, v in busy["top_kernels_ms"])
          + f" ({result['card']})")
    return total


def bench_config(**kw):
    """The main path's configuration (bench.py), for the multi-device
    engines."""
    from fgnn_tpu_torch.config import RunConfig, SampleType

    return RunConfig(model="graphsage", fanout=(25, 10), batch_size=8000,
                     num_hidden=256, sample_type=SampleType.KHOP2,
                     dropout=0.5, lr=0.003, compute_dtype="bfloat16",
                     **kw)


def path_gathers(run, count):
    """The first ``count`` row gathers that ``run()`` makes, as the
    (table, ids) each was given, in order. All of the multi-device
    engines' gathers go through ``ops.gather.gather_rows`` (the feature
    gather and ``gather_src``, both by ``GatherRows``)."""
    from fgnn_tpu_torch.ops import gather

    calls, real = [], gather.gather_rows

    def spy(table, ids):
        if len(calls) < count:
            calls.append((table.detach(), ids))
        return real(table, ids)

    gather.gather_rows = spy
    try:
        run()
    finally:
        gather.gather_rows = real
    return calls


def factored_kernel_phase(dev, card, ds):
    """The row gather at the shapes the arch5 and arch6 paths give it at the
    bench configuration: their plans have no degree tiers, arch5 dedups the
    last hop (so layer 1's gather_src gathers) and arch6 does not (so its
    feature gather takes the whole [frontier | picks] list). One epoch of
    FactoredEngine S=1, T=1 and of SGNNEngine W=1; the first group's (the
    first batch's) gathers, kept as they were made, are held against the
    plain version bit for bit and timed with CUDA events. Returns the
    largest |diff|."""
    from fgnn_tpu_torch.parallel.factored import FactoredEngine, SGNNEngine

    max_err = 0.0
    for arch, cls, devices, names in (
            ("arch5", FactoredEngine, [dev, dev], ARCH5_GATHERS),
            ("arch6", SGNNEngine, [dev], ARCH6_GATHERS)):
        eng = cls(bench_config(), ds, devices)
        print(f"  {arch} plan {eng.plan}")
        calls = path_gathers(lambda: eng.run_epoch(0), len(names))
        check(len(calls) == len(names), f"{arch}: {len(calls)} row gathers "
              f"in an epoch, {len(names)} expected in its first group")
        for name, (table, ids) in zip(names, calls):
            label = f"{arch} {name}"
            max_err = max(max_err, check_equal(table, ids, label))
            time_gather(table, ids, label, card)
        del eng, calls
    print(f"  {len(ARCH5_GATHERS) + len(ARCH6_GATHERS)} path shapes bit-equal "
          f"to the plain version, max |diff| {max_err}")
    return max_err


def arch5_reduce_phase(dev, ds):
    """arch5, S=1, T=2 on one card at full width: one group's data-parallel
    step (two replicas, the gradients summed into the first, one Adam step)
    against one replica's step on the same two batches with the same
    weighted loss and dropout draws; the parameters within 1e-4."""
    import copy

    import torch
    from fgnn_tpu_torch.ops.extract import label_gather
    from fgnn_tpu_torch.parallel.factored import FactoredEngine, step_generator
    from fgnn_tpu_torch.train.loop import make_optimizer, masked_cross_entropy

    cfg = bench_config(num_train_worker=2)
    eng = FactoredEngine(cfg, ds, [dev] * 3)
    model = copy.deepcopy(eng.model)
    opt = make_optimizer(model.parameters(), cfg.lr)
    items = []
    for seeds, n, step in list(eng.shufflers[0].batches(0))[:2]:
        b = eng.sample(dev, torch.as_tensor(seeds, device=dev), n,
                       step_generator(dev, cfg.seed, step), True)
        items.append((b, eng._feats_for(b, None, dev, count=False)))
    gens = lambda: [step_generator(dev, 77, i) for i in range(2)]
    loss, _ = eng._dp_step(items, [dev, dev], gens())
    # one replica, the reference's weighted loss over both batches
    B = cfg.batch_size
    ws = [(b.num_output > 0).float() for b, _ in items]
    wsum = torch.stack(ws).sum().clamp(min=1.0)
    opt.zero_grad(set_to_none=True)
    model.train()
    total = 0
    for (b, f), w, g in zip(items, ws, gens()):
        logits = model(b, f, eng.dst_caps, generator=g)
        l, _ = masked_cross_entropy(logits[:B], label_gather(
            eng._label(dev), b.output_nodes)[:B])
        total = total + l * w
    (total / wsum).backward()
    opt.step()
    err = max(float((p.detach() - q.detach()).abs().max()) for p, q in
              zip(eng.model.parameters(), model.parameters()))
    one = float((total / wsum).detach())
    lerr = abs(float(loss) - one)
    print(f"  one group of 2 batches: loss {float(loss):.6f} (one replica "
          f"{one:.6f}), parameters after the step max |diff| {err:.2e}")
    check(lerr < 1e-4 and err < 1e-4, f"T=2 reduce: loss differs by {lerr}, "
          f"parameters by {err}")


def switcher_async_phase(dev, card, ds):
    """The switcher (FGNN_TPU_SWITCHER_FORCE=1, S=1, T=1) and the async
    trainers (T=2, averaging every 2 groups), one epoch each at the main
    path's configuration on one card: finite losses, the switcher's tail
    engaged on both devices. Their epoch times carry the residue of the
    torch.profiler sessions of phases 15-19."""
    import torch
    from fgnn_tpu_torch.parallel.async_dp import AsyncFactoredEngine
    from fgnn_tpu_torch.parallel.switcher import SwitcherEngine

    base = bench_config()
    os.environ["FGNN_TPU_SWITCHER_FORCE"] = "1"
    try:
        sw = SwitcherEngine(base.replace(have_switcher=True), ds, [dev] * 2)
        r = sw.run_epoch(0)
    finally:
        os.environ.pop("FGNN_TPU_SWITCHER_FORCE", None)
    tail = getattr(sw, "tail_batches", 0)
    print(f"  switcher: reserve {sw._tail_reserve_batches} of {sw.num_step} "
          f"batches, tail trained {tail} on {sw.num_full} devices; loss "
          f"{r['loss']:.4f}, epoch_time {r['epoch_time']:.4f} s ({card})")
    check(math.isfinite(r["loss"]), f"switcher loss {r['loss']}")
    check(tail > 0 and sw.num_full == 2, "the switcher's tail did not engage")
    del sw
    an = AsyncFactoredEngine(base.replace(async_train=True, async_sync_every=2,
                                          num_train_worker=2), ds, [dev] * 3)
    r = an.run_epoch(0)
    acc = an.evaluate()
    print(f"  async T=2, averaging every 2 groups: loss {r['loss']:.4f}, "
          f"epoch_time {r['epoch_time']:.4f} s; evaluate() {acc:.4f} ({card})")
    check(math.isfinite(r["loss"]), f"async loss {r['loss']}")
    check(1.0 / NUM_CLASS < acc <= 1.0, f"async evaluate() accuracy {acc}")
    torch.cuda.empty_cache()


def multichip_run():
    """Phase 27's process: the tool over every card (one card: four roles
    on cuda:0). Returns (its result, its seconds with its start)."""
    import subprocess

    import torch

    devices = ",".join(f"cuda:{i}" for i in range(torch.cuda.device_count()))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fgnn_tpu_torch.tools.multichip", "--devices",
         devices], cwd=REPO, capture_output=True, text=True, timeout=600)
    return proc, time.perf_counter() - t0


def multichip_phase(run):
    """Phase 27's checks: every gate passes, and on one card (a) and (b)
    alone are refused."""
    import torch

    n = torch.cuda.device_count()
    proc, seconds = run
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        if line.startswith("gate "):
            print(f"  {line}")
    check(proc.returncode == 0 and lines, f"multichip: rc {proc.returncode}"
          f"\n{proc.stdout[-3000:]}\n{proc.stderr[-4000:]}")
    r = json.loads(lines[-1])
    gates = {g["name"]: g for g in r["gates"]}
    refused = sorted(k for k, g in gates.items() if g["ok"] is None)
    check(sorted(gates) == list("abcdefgh") and r["ok"],
          f"multichip: gates {sorted(gates)}, ok {r['ok']}")
    check(refused == ([] if n > 1 else ["a", "b"]),
          f"multichip on {n} card(s): refused {refused}")
    print(f"  multichip on {r['devices']} ({r['card']}): every gate passed, "
          f"refused {refused or 'none'}, {seconds:.1f} s with its start "
          "(beside phases 29-31)")


APP5_ARGS = ["--arch", "arch5", "--devices", "cuda:0,cuda:0", "--model",
             "graphsage", "--fanout", "25", "10", "--batch-size", "8000",
             "--num-hidden", "256", "--synthetic-nodes", "1000000",
             "--synthetic-train-frac", "0.25", "--num-epoch", "2"]


def app5_phase(card):
    """``python -m fgnn_tpu_torch.examples.train_gnn --arch arch5 --devices
    cuda:0,cuda:0`` at the bench configuration, two epochs, as a user runs
    it: rc 0, the role devices, the result keys, the row gather's launches
    per group. Returns its launches."""
    from fgnn_tpu_torch.exp.runner import run_app

    out = os.path.join(REPO, "chiprun_out", "smoke_app")
    t0 = time.perf_counter()
    r = run_app(APP5_ARGS, out, "arch5", timeout=600)
    check(r.returncode == 0, f"app arch5: rc {r.returncode}, see {r.log_path}")
    v = r.values
    missing = [k for k in ("devices", "init_time", "epoch_time",
                           "first_epoch_loss", "num_step",
                           "launches:gather_rows") if k not in v]
    check(not missing, f"app arch5: keys missing {missing}")
    check(v["devices"] == "cuda:0,cuda:0", f"app arch5: devices {v['devices']}")
    steps = int(v["num_step"]) * 2
    launches = int(v["launches:gather_rows"])
    check(launches == ARCH5_LAUNCHES_PER_BATCH * steps,
          f"app arch5: {launches} gather_rows launches for {steps} groups")
    check(math.isfinite(float(v["first_epoch_loss"])),
          f"app arch5: first epoch loss {v['first_epoch_loss']}")
    print(f"  app arch5 ({time.perf_counter() - t0:.1f} s with its start): "
          f"init_time {v['init_time']} s, epoch_time {v['epoch_time']} s, "
          f"first epoch loss {v['first_epoch_loss']}, gather_rows launches "
          f"{launches} over {steps} groups ({card})")
    return launches


# phase 29's role processes: the factored app under deterministic
# algorithms (the gradients' scatter-adds use atomics otherwise)
DETERMINISTIC_APP = [
    sys.executable, "-c",
    "import sys, torch; torch.use_deterministic_algorithms(True); "
    "from fgnn_tpu_torch.examples.train_factored_multihost import main; "
    "sys.exit(main(sys.argv[1:]))"]
RANK_TIMEOUT = 300


def processes_small():
    """Phase 29's runs (see the module docstring), in a process of its own
    with deterministic algorithms: both modes' role processes start
    together, and each mode's single-process engine runs here meanwhile."""
    import argparse
    import re

    import torch
    from fgnn_tpu_torch.examples.train_factored_multihost import (
        app_config, app_dataset)
    from fgnn_tpu_torch.parallel import multihost as mh
    from fgnn_tpu_torch.parallel.factored import FactoredEngine

    torch.use_deterministic_algorithms(True)
    out = os.path.join(REPO, "chiprun_out", "smoke_processes")
    modes = {"table on the trainer": 0.0, "cache mode": 0.2}
    groups = {}
    for label, pct in modes.items():
        args = ["--synthetic-nodes", "2000", "--devices", "cuda:0",
                "--dropout", "0.5", "--num-epoch", "2",
                "--cache-percentage", str(pct),
                "--save-params", os.path.join(out, label.split()[0])]
        groups[label] = mh.start_ranks([DETERMINISTIC_APP + args] * 2,
                                       env={"FGNN_TPU_DIST_TIMEOUT": "300"},
                                       cwd=REPO)
    # the one-process runs while the role processes run: only bits count
    one = {}
    try:
        for label, pct in modes.items():
            cfg = app_config(argparse.Namespace(
                batch_size=128, num_hidden=32, cache_percentage=pct,
                dropout=0.5))
            eng = FactoredEngine(cfg, app_dataset(2000), ["cuda:0", "cuda:0"])
            one[label] = (
                [f"{eng.run_epoch(e)['loss']:.8f}" for e in range(2)],
                {k: v.cpu() for k, v in eng.model.state_dict().items()})
    finally:
        done = {label: mh.wait_ranks(groups[label], RANK_TIMEOUT)
                for label in modes}
    for label in modes:
        res = done[label]
        for i, (rc, text) in enumerate(res):
            check(rc == 0, f"{label}: rank {i} exited {rc}:\n{text[-3000:]}")
        got = dict(re.findall(r"test_result:([^=]+)=(\S+)", res[1][1]))
        losses, state = one[label]
        saved = torch.load(os.path.join(out, label.split()[0], "params.pt"))
        same = all(torch.equal(saved[k], v) for k, v in state.items())
        check(losses == [got["epoch0_loss"], got["epoch1_loss"]] and same,
              f"{label}: 2 processes {got} against one process {losses}, "
              f"parameters equal: {same}")
        print(f"  {label}: sampler and trainer processes on cuda:0 "
              f"bit-equal to FactoredEngine on [cuda:0, cuda:0]: losses "
              f"{losses}, parameters equal")


def processes_small_phase():
    import subprocess

    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.processes_small()"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    print(proc.stdout, end="")
    check(proc.returncode == 0, f"processes on one card: rc {proc.returncode}"
          f"\n{proc.stderr[-4000:]}")


def multiprocess_phase(card):
    """Phase 30 (see the module docstring). Returns the trainer process's
    row-gather launches."""
    import re
    import subprocess

    import torch
    from fgnn_tpu_torch.parallel import multihost as mh

    out_dir = os.path.join(REPO, "chiprun_out", "smoke_multiprocess")
    os.makedirs(out_dir, exist_ok=True)
    log_path = os.path.join(out_dir, "multiprocess_epochs.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        proc = subprocess.run(
            [sys.executable, "-m", "fgnn_tpu_torch.tools.multiprocess_epochs",
             "--epochs", "2", "--deterministic-epochs", "1", "--out-dir",
             out_dir],
            stdout=f, stderr=subprocess.STDOUT, cwd=REPO, timeout=900)
    with open(log_path) as f:
        lines = f.read().splitlines()
    check(proc.returncode == 0, f"multiprocess_epochs: rc {proc.returncode}, "
          f"see {log_path}")
    r = json.loads(lines[-1])
    print(f"  multiprocess_epochs: {time.perf_counter() - t0:.1f} s with its "
          f"starts; host {r['host_cpu']}, {r['host_cores']} cores")
    launches = 0
    for x in r["multi"]:
        eps = x["epochs"]
        n_waves = x["num_waves"] * len(eps)
        print(f"  {x['role']} process on {x['device']}: init {x['init_s']:.2f} "
              f"s, epochs " + " / ".join(f"{e['epoch_time']:.4f}" for e in eps)
              + " s, " + " / ".join(f"{e['edges_per_s'] / 1e6:.2f}"
                                     for e in eps)
              + f" M edges/s; {x['batch_bytes']} bytes a batch, "
              f"{sum(e['wave_bytes'] for e in eps) / n_waves:.0f} a wave, "
              "waited a wave (ms) " + " / ".join(
                  f"{e['wave_wait_s'] / x['num_waves'] * 1e3:.3f}"
                  for e in eps)
              + f", a lone wave's broadcast "
              f"{x['probe_broadcast_s'] * 1e3:.3f} ms; peak "
              f"{x['peak_bytes']} B ({card})")
        if x["role"] != "trainer":
            continue
        losses = [e["loss"] for e in eps]
        k1 = x["launches"].get("gather_rows", 0)
        launches += k1
        check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
              f"trainer losses {losses}")
        check(k1 == ARCH5_LAUNCHES_PER_BATCH * x["groups"],
              f"trainer process: {k1} gather_rows launches for "
              f"{x['groups']} groups")
        print(f"  trainer losses {losses}; gather_rows launches {k1} "
              f"({k1 / x['groups']:g} a group)")
    one = r["single"]["epochs"]
    print("  FactoredEngine in one process, same devices: epochs "
          + " / ".join(f"{e['epoch_time']:.4f}" for e in one) + " s, losses "
          f"{[e['loss'] for e in one]}, peak {r['single']['peak_bytes']} B "
          f"({card})")
    check(r["epoch0_loss_equal"], "the epoch-0 loss of the processes differs "
          "from one process's")
    print(f"  epoch-0 loss equal (deterministic algorithms): "
          f"{r['epoch0_loss_equal']}; epoch 1 (atomics): every loss "
          f"{r['losses_equal']}, parameters {r['params_equal']}")
    n = torch.cuda.device_count()
    print(f"  the placements across cards did not run: the smoke needs one "
          f"card, and this machine has {n} (python -m "
          "fgnn_tpu_torch.tools.multiprocess_epochs --devices cuda:0,cuda:1 "
          "or cuda:0,cuda:1,cuda:2 runs them)")

    t0 = time.perf_counter()
    res = mh.wait_ranks(mh.start_ranks(
        [[sys.executable, "-m", "fgnn_tpu_torch.examples.train_multihost",
          "--device", "cuda:0"]] * 2,
        env={"FGNN_TPU_DIST_TIMEOUT": "300"}, cwd=REPO), RANK_TIMEOUT)
    vals = []
    for i, (rc, text) in enumerate(res):
        check(rc == 0, f"data-parallel demo rank {i}: rc {rc}\n{text[-3000:]}")
        vals.append(dict(re.findall(r"test_result:([^=]+)=(\S+)", text)))
    check(vals[0] == vals[1], f"data-parallel demo: ranks differ {vals}")
    check(vals[0]["grad_route"] == "host", "data-parallel demo: two ranks "
          f"on cuda:0 took the gradient route {vals[0]['grad_route']}")
    check(float(vals[0]["epoch1_loss"]) < float(vals[0]["epoch0_loss"]),
          f"data-parallel demo: loss does not fall {vals[0]}")
    print(f"  data-parallel demo, 2 processes on cuda:0 "
          f"({time.perf_counter() - t0:.1f} s with their starts): {vals[0]}")
    return launches


def runner_phase(card):
    """Phase 31 (see the module docstring). Returns the row gather's
    launches over the rows' level-1 runs."""
    from fgnn_tpu_torch.exp import table4

    out = os.path.join(REPO, "chiprun_out", "smoke_table4")
    t0 = time.perf_counter()
    rc = table4.main(["--models", "gcn", "--num-workers", "2", "--devices",
                      "cuda:0", "--num-epoch", "2", "--out-dir", out])
    check(rc == 0, f"table4: rc {rc}, see {out}")
    with open(os.path.join(out, "table4.json")) as f:
        rows = json.load(f)["results"]
    launches = 0
    for r in rows:
        v = r["values"]
        check(r["rc"] == 0 and math.isfinite(float(v["epoch_time"]))
              and float(v["train_time"]) > 0,
              f"table4 {r['config']['run_arch']}: {v}")
        launches += int(v["launches:gather_rows"])
        print(f"  table4 {r['config']['model']} {r['config']['run_arch']} "
              f"on {v['devices']}: epoch_time {v['epoch_time']} s, sample "
              f"{v['sample_time']}, copy {v['copy_time']}, extract "
              f"{v['extract_time']}, train {v['train_time']}, init "
              f"{v['init_time']} s, gather_rows launches "
              f"{v['launches:gather_rows']} ({card})")
    print(f"  table4 rows: {time.perf_counter() - t0:.1f} s")
    return launches



# --- phases 32-35: the converters, the cache-policy experiments, the
# bandwidth toolkit and the single-device app runners -------------------------

PRODUCTS_CLASSES = 47
# phase 33's fig5b: its alias tables are a per-vertex loop on the host
# (30 s at the default 1M nodes), so the smoke cuts the graph
FIG5B_NODES = 200_000


def datagen_phase(dev):
    """Phase 32 (see the module docstring). Returns the row gather's
    launches over the 8 epochs and evaluate()."""
    import torch
    from fgnn_tpu_torch.config import RunConfig, SampleType
    from fgnn_tpu_torch.data import load_dataset
    from fgnn_tpu_torch.data.datagen import convert_ogb
    from fgnn_tpu_torch.engine import OneChipEngine
    from fgnn_tpu_torch.ops import cuda_lib

    out = os.path.join(REPO, "chiprun_out", "smoke_datagen")
    t0 = time.perf_counter()
    path = convert_ogb("ogbn-products",
                       os.path.join(REPO, "tests", "fixtures", "ogb_raw"), out)
    ds = load_dataset("products", root=out)
    print(f"  converted {path}: {ds.num_node} nodes, {ds.num_edge} edges, "
          f"{ds.feat_dim}-dim features, {ds.num_class} classes "
          f"({time.perf_counter() - t0:.2f} s)")
    check(ds.num_node == 300 and ds.num_edge == 2 * 1930
          and ds.prob_table is not None, "converted products fixture")
    cfg = RunConfig(model="graphsage", fanout=(5, 5), batch_size=64,
                    num_hidden=64, sample_type=SampleType.KHOP0,
                    dropout=0.0, lr=0.01)
    eng = OneChipEngine(cfg, ds, dev)
    cuda_lib.reset_launches()
    losses = [eng.run_epoch(e)["loss"] for e in range(8)]
    acc = eng.evaluate()
    launches = cuda_lib.launches.get("gather_rows", 0)
    print(f"  GraphSAGE [5, 5] on the card, 8 epochs: loss {losses[0]:.4f} "
          f"-> {losses[-1]:.4f}, test accuracy {acc:.4f} (chance "
          f"{1 / PRODUCTS_CLASSES:.4f}); gather_rows launches {launches}")
    check(losses[-1] < losses[0], f"losses do not fall: {losses}")
    check(acc > 1.5 / PRODUCTS_CLASSES, f"accuracy {acc} not above chance")
    check(launches > 0, "no gather_rows launch")

    # one step on the card against the CPU, float32, same parameters and
    # uniforms (as phase 4)
    cfg32 = cfg.replace(compute_dtype="float32")
    cpu = OneChipEngine(cfg32, ds, "cpu")
    gpu = OneChipEngine(cfg32, ds, dev)
    gpu.model.load_state_dict(cpu.model.state_dict())
    gen = torch.Generator().manual_seed(1)
    seeds, n, _ = next(cpu.shuffler.batches(0))
    rand = [torch.rand(s, generator=gen)
            for s in cpu.uniform_shapes(cpu.dedup_last_hop)]
    lc, _, ec, _ = cpu.step(torch.as_tensor(seeds), n, rand)
    lg, _, eg, _ = gpu.step(torch.as_tensor(seeds, device=dev), n,
                            [r.to(dev) for r in rand])
    check(int(ec) == int(eg), f"edges {int(ec)} != {int(eg)}")
    check(abs(float(lc) - float(lg)) < 1e-4,
          f"loss cpu {float(lc)} gpu {float(lg)}")
    print(f"  one step on the converted data: loss cpu {float(lc):.6f} gpu "
          f"{float(lg):.6f}, edges {int(eg)}")
    return launches


def print_table(path):
    with open(path) as f:
        for line in f:
            if not line.startswith("#"):
                print("    " + line.rstrip("\n"))


def check_policies(name, results, num_node=None):
    """optimal >= every policy at every percentage; with ``num_node`` at
    1M, random within 0.01 of the cache fraction."""
    for pct, best in results["optimal"].items():
        for pol, row in results.items():
            check(row[pct] <= best, f"{name}: {pol} {row[pct]} above optimal "
                  f"{best} at {pct}")
        if "random" in results and num_node == 1_000_000:
            check(abs(results["random"][pct] - pct) <= 0.01,
                  f"{name}: random {results['random'][pct]} at {pct}")


def cache_exps_phase():
    """Phase 33 (see the module docstring)."""
    from fgnn_tpu_torch.exp import fig5, fig10, fig11, table2

    out = os.path.join(REPO, "chiprun_out")
    t0 = time.perf_counter()
    r10 = fig10.main(["--out-dir", os.path.join(out, "smoke_fig10")])
    check_policies("fig10", r10, 1_000_000)
    print_table(os.path.join(out, "smoke_fig10", "fig10.dat"))
    print(f"  fig10: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    r11 = fig11.main(["--out-dir", os.path.join(out, "smoke_fig11")])
    rates = {r["policy"]: {0.1: r["hit_rate"]} for r in r11}
    check_policies("fig11", rates, 1_000_000)
    print_table(os.path.join(out, "smoke_fig11", "fig11.dat"))
    print(f"  fig11: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    r5 = fig5.main(["--out-dir", os.path.join(out, "smoke_fig5")])
    check_policies("fig5a", r5)
    print_table(os.path.join(out, "smoke_fig5", "fig5a.dat"))
    print(f"  fig5a: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    r5b = fig5.main(["--sample-type", "weighted_khop", "--synthetic-nodes",
                     str(FIG5B_NODES), "--out-dir",
                     os.path.join(out, "smoke_fig5")])
    check_policies("fig5b", r5b)
    print_table(os.path.join(out, "smoke_fig5", "fig5b.dat"))
    print(f"  fig5b at {FIG5B_NODES} nodes: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rows = table2.main(["--out-dir", os.path.join(out, "smoke_table2")])
    check(len(rows) == 3, f"table2: {len(rows)} rows")
    for r in rows:
        check(0.0 <= r["epoch_similarity"] <= 100.0,
              f"table2 {r['sample_type']}: {r['epoch_similarity']}")
    print_table(os.path.join(out, "smoke_table2", "table2.dat"))
    print(f"  table2: {time.perf_counter() - t0:.1f} s")


def bandwidth_phase():
    """Phase 35 (see the module docstring)."""
    from fgnn_tpu_torch.tools import bandwidth_bench

    bandwidth_bench.main([])   # raises if K1 differs from its plain version


def start_app_runners(pool):
    """Phase 34's runners, started on ``pool`` (see the module docstring):
    ``{name: (future, table)}``."""
    from fgnn_tpu_torch.exp import auto_runner, fig4a, fig12, fig17b, table6

    out = os.path.join(REPO, "chiprun_out")
    two = ["--num-epoch", "2"]
    runs = {
        "fig17b": (fig17b, two, "fig17b"),
        "table6": (table6, two, "table6"),
        "fig4a": (fig4a, two + ["--percentages", "0", "0.1", "0.2"],
                  "fig4a"),
        "fig12": (fig12, two + ["--models", "graphsage"], "fig12"),
        "breakdown": (auto_runner, two + ["breakdown"], "breakdown"),
    }
    return {name: (pool.submit(mod.main, argv + [
        "--out-dir", os.path.join(out, f"smoke_{name}")]), table)
        for name, (mod, argv, table) in runs.items()}


def app_runners_phase(runs):
    """Phase 34's checks, once its runners (``start_app_runners``) end.
    Returns the row gather's launches over every row."""
    from fgnn_tpu_torch.exp import fig4b

    out = os.path.join(REPO, "chiprun_out")
    rcs = {name: f.result() for name, (f, _) in runs.items()}
    rc = fig4b.main(["--fig4a", os.path.join(out, "smoke_fig4a", "fig4a.json"),
                     "--out-dir", os.path.join(out, "smoke_fig4b")])
    check(rc == 0, f"fig4b: rc {rc}")
    launches = 0
    for name, (_, table) in runs.items():
        d = os.path.join(out, f"smoke_{name}")
        check(rcs[name] == 0, f"{name}: rc {rcs[name]}, see {d}")
        with open(os.path.join(d, f"{table}.json")) as f:
            rows = json.load(f)["results"]
        for r in rows:
            v = r["values"]
            check(r["rc"] == 0 and math.isfinite(float(v["epoch_time"])),
                  f"{name}: {r['config']} rc {r['rc']}")
            n = int(v.get("launches:gather_rows", 0))
            check(n > 0, f"{name}: a row without gather_rows launches")
            launches += n
        print(f"  {name}: {len(rows)} rows, rc 0, gather_rows launches "
              f"{sum(int(r['values'].get('launches:gather_rows', 0)) for r in rows)}")
        print_table(os.path.join(d, f"{table}.dat"))
    print("  fig4b (over the fig4a rows above):")
    print_table(os.path.join(out, "smoke_fig4b", "fig4b.dat"))
    return launches


# --- phase 37: the port's benchmark ------------------------------------------

BENCH_CELL = "sage_hbm_syn1M"
BENCH_OUT = os.path.join(REPO, "chiprun_out", "smoke_bench")


def bench_run():
    """Phase 37's process: the benchmark's main-path cell at 2 measured
    epochs, its output in ``chiprun_out/smoke_bench/``. Returns its rc and
    output lines."""
    import subprocess

    os.makedirs(BENCH_OUT, exist_ok=True)
    log = os.path.join(BENCH_OUT, f"{BENCH_CELL}.log")
    with open(log, "w") as f:
        rc = subprocess.run(
            [sys.executable, "-m", "bench_torch.run", "--cell", BENCH_CELL,
             "--seed", "0", "--epochs", "2"], cwd=REPO, stdout=f,
            stderr=subprocess.STDOUT).returncode
    with open(log) as f:
        return rc, f.read().splitlines()


def bench_phase(result):
    """Phase 37's checks: rc 0, every metric and layer metric of the cell
    printed by name, the last line ``correct``. Returns K1's launches in
    the timed run."""
    rc, lines = result
    check(rc == 0, f"bench_torch.run --cell {BENCH_CELL}: rc {rc}; "
          + "\n".join(lines[-30:]))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for kind, group in (("metric", "metrics"), ("layer", "layer_metrics")):
        for m in bench[group]:
            if BENCH_CELL in m["workloads"]:
                check(any(x.startswith(f"{kind} {m['name']} ") for x in lines),
                      f"bench: no {kind} line for {m['name']}")
    last = json.loads(lines[-1])
    check(last["correct"] is True, f"bench: last line {lines[-1]}")
    launches = last["launches"]["gather_rows"]
    check(launches > 0, "bench: no gather_rows launch in the timed run")
    for x in lines:
        if x.startswith(("metric ", "layer ", "check ", "info ")):
            print(f"  {x}")
    print(f"  bench {BENCH_CELL}: rc 0, every metric printed, correct; "
          f"gather_rows launches {launches}; wall {last['wall_s']:.1f} s "
          f"(beside phases 32-34)")
    return launches


# --- phase 36: the papers100M- and uk-union-scale tools ---------------------

SCALE_NODES = 2_000_000
UK_SMALL = dict(num_node=2_000_000, target_edges=30_000_000)
UK_RUN = (
    "import sys\n"
    "from fgnn_tpu_torch.tools import ukunion_rehearsal as u\n"
    "u.generate(sys.argv[1], num_node={num_node}, "
    "target_edges={target_edges})\n"
    "u.run_epoch(sys.argv[1], 8000, 80000, 2, 'cuda', num_node={num_node})\n"
).format(**UK_SMALL)
SCALE_TABLE1_OUT = os.path.join(REPO, "chiprun_out",
                                "smoke_table1_papers100m")


def scale_tools_run(data):
    """Phase 36's processes (see the module docstring), one after another,
    their datasets under ``data``: ``[(label, rc, seconds, output)]``. Runs
    in a thread beside phases 29-34 and prints nothing;
    :func:`scale_tools_phase` checks and prints."""
    import subprocess

    p100m = os.path.join(data, "p100m_ds")
    reh = [sys.executable, "-m", "fgnn_tpu_torch.tools.papers100m_rehearsal",
           "--num-node", str(SCALE_NODES), "--cache-dir", p100m]
    runs = [
        ("rehearsal --gen-only", reh + ["--gen-only"]),
        ("rehearsal --mode hbm", reh + ["--mode", "hbm", "--num-epoch", "2"]),
        ("rehearsal --mode cache",
         reh + ["--mode", "cache", "--num-epoch", "2"]),
        ("table1_papers100m", [
            sys.executable, "-m", "fgnn_tpu_torch.exp.table1_papers100m",
            "--num-node", str(SCALE_NODES), "--num-epoch", "2",
            "--skip-stages", "--rows", "hbm", "cache", "dev", "host",
            "--cache-dir", p100m, "--out-dir", SCALE_TABLE1_OUT]),
        ("ukunion generate + run_epoch",
         [sys.executable, "-c", UK_RUN, os.path.join(data, "ukunion_ds")]),
    ]
    out = []
    for label, argv in runs:
        t0 = time.perf_counter()
        r = subprocess.run(argv, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True, cwd=REPO,
                           timeout=900)
        out.append((label, r.returncode, time.perf_counter() - t0, r.stdout))
        if r.returncode:
            break
    return out


def scale_kernel_phase(dev, data):
    """Phase 36's in-process checks: the rehearsal's two engines at
    ``SCALE_NODES`` over the dataset its ``--gen-only`` saved in ``data``,
    each holding one step's feature gather against its plain version, bit
    for bit (``papers100m_rehearsal.check_step``): the mock gather from the
    1M-row table against ``index_select`` of the ids modulo its rows, and
    the cache combine against ``combine_reference``. Returns the max
    |difference|."""
    import torch
    from fgnn_tpu_torch.engine import OneChipEngine
    from fgnn_tpu_torch.tools import papers100m_rehearsal as reh

    ds = reh.load_cached(os.path.join(data, "p100m_ds",
                                      reh.stamp(SCALE_NODES)),
                         SCALE_NODES, 0.01)
    check(ds.empty_feat, "the 2M-node dataset must read a mock table")
    max_err = 0.0
    for mode in ("hbm", "cache"):
        eng = OneChipEngine(reh.engine_config(mode), ds, dev,
                            feat_budget=0 if mode == "cache" else None)
        check((eng.cache is not None) == (mode == "cache"),
              f"{mode}: the engine's path")
        what, err = reh.check_step(eng)
        torch.cuda.synchronize()
        print(f"  {mode} mode: {what}: bit-equal to its plain version")
        max_err = max(max_err, err)
        del eng
        torch.cuda.empty_cache()
    return max_err


def scale_tools_phase(card, runs):
    """Phase 36's checks over :func:`scale_tools_run`'s processes. Returns
    the row gather's launches over them."""
    import ast
    import re

    total = 0
    for label, rc, seconds, text in runs:
        check(rc == 0, f"{label}: rc {rc}\n{text[-3000:]}")
        lines = text.splitlines()
        epochs = [ast.literal_eval(m.group(1)) for ln in lines
                  for m in [re.match(r"^\[epoch \d+\] (\{.*\})$", ln)] if m]
        losses = [e["loss"] for e in epochs]
        losses += [float(m.group(1)) for ln in lines
                   for m in [re.match(r"^\[\w+\] epoch \d+: \S+ "
                                      r"loss=(\S+)", ln)
                             or re.match(r"^test_result:epoch\d+_loss=(\S+)",
                                         ln)] if m]
        counts = [int(m.group(1)) for ln in lines
                  for m in [re.match(
                      r"^test_result:launches:gather_rows=(\d+)$", ln)] if m]
        hits = [1 - e["miss_bytes"] / e["feature_bytes"] for e in epochs
                if e.get("feature_bytes")]
        print(f"  {label} ({seconds:.1f} s with its start, beside phases "
              f"29-34): " + "; ".join(
                  ln.strip() for ln in lines
                  if ln.startswith(("[gen]", "[init]", "[result]", "# engine",
                                    "# generated", "[hbm]", "[cache]",
                                    "[dev]", "[host]", "# epoch"))))
        if label == "rehearsal --gen-only":
            continue
        check(losses and all(math.isfinite(x) for x in losses),
              f"{label}: losses {losses}")
        check(counts and all(n > 0 for n in counts),
              f"{label}: gather_rows launches {counts}")
        if label == "rehearsal --mode cache":
            check(len(hits) == 2 and all(0 < h <= 1 for h in hits),
                  f"{label}: hit rates {hits}")
            print(f"  cache mode hit rates {[round(h, 4) for h in hits]}")
        if label == "table1_papers100m":
            check(len(counts) == 4, f"{label}: {len(counts)} rows reported")
        total += sum(counts)
        print(f"  {label}: losses {[round(x, 4) for x in losses]}, "
              f"gather_rows launches {sum(counts)} ({card})")
    check(len(runs) == 5, f"phase 36 stopped after {runs[-1][0]}")
    print_table(os.path.join(SCALE_TABLE1_OUT, "table1_papers100m.dat"))
    return total


def main() -> int:
    # The app processes of phases 20-21 read the bytecode this process
    # compiles: where the installed packages carry none and cannot take it,
    # each process would compile torch's sources again.
    cache = os.path.join(REPO, "fgnn_tpu_torch", "_build", "pycache")
    sys.pycache_prefix = cache
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = cache
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a CUDA device", file=sys.stderr)
        return 1
    from fgnn_tpu_torch.config import SampleType
    from fgnn_tpu_torch.ops import cuda_lib
    from fgnn_tpu_torch.tools.gather_campaign import card_name

    t_start = time.perf_counter()
    print("[1/38] device")
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

    print("[2/38] build")
    kernels = ("gather_rows", "stream_add_one", "segment_sum_rows",
               "scatter_add_rows")
    cuda_lib.build(kernels)
    for name in kernels:
        print(f"  {name} built in {cuda_lib.build_seconds[name]:.2f} s (all "
              f"built together) -> {cuda_lib.library_path(name)}")

    print("[3/38] row gather against plain version")
    max_err, timing = kernel_phase(dev, card)

    print("[4/38] small input, GraphSAGE: card against CPU")
    small_input_phase(dev)

    print("[5/38] main path: GraphSAGE arch1, 1M-node graph, 2 epochs")
    ds = big_dataset()
    sage_launches, sage_eng, sage_counts = main_path_phase(dev, card, ds)

    print("[6/38] streaming pass against plain version")
    s_err, s_timing = stream_check_phase(dev, card)

    print("[7/38] gather campaign: stream and kernel phases")
    s_launches, _, _ = campaign_phase(dev, card)

    print("[8/38] small input, GCN [5, 10, 15]: card against CPU")
    small_input_phase(dev, model="gcn", fanout=(5, 10, 15))

    print("[9/38] GCN Table 1: [5, 10, 15], 1M-node graph, 2 epochs + evaluate")
    gcn_launches, gcn_eng, gcn_counts = gcn_phase(dev, card, ds)

    print("[38/38] segment sum (K4) and row scatter-add (K5) against their "
          "plain versions at the GCN and GraphSAGE blocks' shapes")
    seg_results = segment_kernel_phase(
        dev, card, [("GCN", gcn_eng), ("GraphSAGE", sage_eng)])
    del gcn_eng, sage_eng
    torch.cuda.empty_cache()

    print("[10/38] small input, PinSAGE: card against CPU")
    small_input_phase(dev, model="pinsage",
                      sample_type=SampleType.RANDOM_WALK)

    print("[11/38] PinSAGE, 3 x 5 walks W=4 L=3, 1M-node graph, 2 epochs + "
          "evaluate")
    pinsage_launches = pinsage_phase(dev, card, ds)

    print("[12/38] small input, GAT: card against CPU, eval-mode logits and "
          "gradients")
    gat_small_phase(dev)

    print("[13/38] GAT 8 x 256 at [25, 10], 1M-node graph, 2 epochs + "
          "evaluate")
    gat_launches = gat_phase(dev, card, ds)

    print("[14/38] small input, host-resident table, PRESAMPLE and "
          "DYNAMIC_CACHE: card against CPU")
    cache_small_phase(dev)

    print("[15/38] GraphSAGE main path, feature table in host memory: hit "
          "rates, pipelined cache epochs, host path, dynamic cache")
    cache_launches = cache_phase(dev, card, ds)

    print("[16/38] small input, KHOP1 and the weighted samplers: card "
          "against CPU; the direct-index dedup at the main path's shapes")
    other_samplers_small_phase(dev)
    remap_phase(dev, card, ds)

    print("[17/38] KHOP1 and the weighted samplers at full width, 1M-node "
          "graph")
    other_launches = other_samplers_phase(dev, card, ds)

    print("[18/38] small input, arch0 (host sampling): card against CPU")
    arch0_small_phase(dev)

    print("[19/38] arch0 at the bench configuration, 1M-node graph")
    arch0_launches = arch0_phase(dev, card, ds)
    print(f"  smoke wall time so far {time.perf_counter() - t_start:.1f} s")

    t20 = time.perf_counter()
    print("[20/38] entry points: observed epoch, session, checkpoint (small "
          "input); the app at the bench configuration")
    observe_small_phase(dev)
    app_launches = app_phase(card)

    print("[21/38] Table 1 through the port's app, 2 epochs a row: runs "
          "later, beside phases 32-34")
    print(f"  phase 20: {time.perf_counter() - t20:.1f} s; smoke wall time "
          f"{time.perf_counter() - t_start:.1f} s")

    t22 = time.perf_counter()
    print("[22/38] small input, arch5 S=1 T=1 and T=2, arch6 W=1 and W=2 on "
          "one card: card against CPU")
    multi_device_small_phase(dev)

    print("[23/38] arch5 (table on the trainer, cache mode) and arch6 (W=1, "
          "W=2) at the main path's configuration, in a process of their own")
    torch.cuda.empty_cache()
    factored_launches = factored_epochs_phase(card)

    print("[24/38] row gather against plain version at the arch5 and arch6 "
          "paths' shapes")
    max_err = max(max_err, factored_kernel_phase(dev, card, ds))

    print("[25/38] arch5 S=1 T=2 on one card: the data-parallel step against "
          "one replica's")
    arch5_reduce_phase(dev, ds)

    print("[26/38] the switcher (forced tail) and the async trainers, one "
          "epoch each")
    switcher_async_phase(dev, card, ds)
    del ds
    torch.cuda.empty_cache()

    print("[28/38] the app on arch5, both roles on one card, 2 epochs")
    app5_launches = app5_phase(card)
    print(f"  phases 22-28: {time.perf_counter() - t22:.1f} s; smoke wall "
          f"time {time.perf_counter() - t_start:.1f} s")

    t29 = time.perf_counter()
    print("[36/38] the papers100M- and uk-union-scale tools at 2,000,000 "
          "nodes: started now, beside phases 29-34, checked after them")
    # removed at exit, after the interpreter has joined the thread
    scale_data = tempfile.mkdtemp(prefix="fgnn_scale_smoke_")
    atexit.register(shutil.rmtree, scale_data, ignore_errors=True)
    scale_pool = ThreadPoolExecutor(1)
    scale_future = scale_pool.submit(scale_tools_run, scale_data)
    print("[27/38] the reference's multi-device gates (tools.multichip) over "
          "every card: started now, beside phases 29-31, checked after them")
    gates_pool = ThreadPoolExecutor(1)
    gates_future = gates_pool.submit(multichip_run)

    print("[29/38] a process per role on one card, small input: against one "
          "process, bit for bit")
    processes_small_phase()

    print("[30/38] a process per role at the bench configuration, 2 epochs; "
          "the data-parallel demo as 2 processes")
    mp_launches = multiprocess_phase(card)

    print("[31/38] Table 4's arch5 and arch6 rows at n = 2 through the port's "
          "runner")
    runner_launches = runner_phase(card)
    print("[27/38] the reference's multi-device gates: their checks")
    multichip_phase(gates_future.result())
    gates_pool.shutdown()
    print(f"  phases 29-31: {time.perf_counter() - t29:.1f} s; smoke wall "
          f"time {time.perf_counter() - t_start:.1f} s")

    t32 = time.perf_counter()
    print("[21/38] and [34/38]: Table 1 and the app runners through the "
          "port's runner (fig17b, table6, fig4a with fig4b, fig12, the "
          "auto_runner breakdown suite): started now, beside phases 32-33, "
          "checked after them")
    print("[37/38] the port's benchmark, the main-path cell at 2 measured "
          "epochs: started now, beside phases 32-34, checked after them")
    with ThreadPoolExecutor(7) as pool:
        table1_run = start_table1(pool)
        runs = start_app_runners(pool)
        bench_future = pool.submit(bench_run)
        print("[32/38] converted data on the card: the products fixture "
              "through the port's datagen, 8 epochs, one step against the "
              "CPU")
        datagen_launches = datagen_phase(dev)

        print("[33/38] the cache-policy experiments in process at their "
              "defaults: fig10, fig11, fig5a, table2; fig5b at 200,000 "
              "nodes")
        cache_exps_phase()

        print("[34/38] the app runners: waiting for them, then their checks")
        apps_launches = app_runners_phase(runs)
        print("[21/38] Table 1: waiting for it, then its checks")
        table1_launches = table1_phase(card, table1_run.result())
        print("[37/38] the port's benchmark: waiting for it, then its checks")
        bench_launches = bench_phase(bench_future.result())
    print(f"  phases 21 and 32-34: {time.perf_counter() - t32:.1f} s")

    t36 = time.perf_counter()
    print("[36/38] the papers100M- and uk-union-scale tools: waiting for them, "
          "then their checks; K1 at their shapes against its plain version")
    scale_launches = scale_tools_phase(card, scale_future.result())
    scale_pool.shutdown()
    max_err = max(max_err, scale_kernel_phase(dev, scale_data))
    print(f"  phase 36: {time.perf_counter() - t36:.1f} s after phase 34; "
          f"smoke wall time {time.perf_counter() - t_start:.1f} s")

    print("[35/38] bandwidth_bench at its defaults: host gather, memcpy, H2D, "
          "K1 against index_select")
    bandwidth_phase()
    print(f"  phases 32-36: {time.perf_counter() - t32:.1f} s; smoke wall "
          f"time {time.perf_counter() - t_start:.1f} s")

    best = min(s_timing, key=lambda c: s_timing[c]["ms"])
    print(f"  stream_add_one times below: chunk {best}, the fastest; "
          "gather_rows times: the feature-gather shape; segment_sum_rows and "
          "scatter_add_rows times: GCN's layer-1 block (2,492,160 slots, "
          "float32, 256 wide), the largest; launches: phases 5 and 9")
    gcn1 = seg_results["GCN layer 1 regular"]
    seg_err = {name: max(r[name]["max_abs_err"] for r in seg_results.values()
                         if name in r)
               for name in ("segment_sum_rows", "scatter_add_rows")}
    print(json.dumps({"kernels": [dict(
        name="gather_rows",
        route="cuda",
        source="fgnn_tpu_torch/csrc/gather_rows.cu",
        replaces="fgnn_tpu/ops/pallas_gather2.py:131",
        launches=(sage_launches + gcn_launches + pinsage_launches
                  + gat_launches + cache_launches + other_launches
                  + arch0_launches + app_launches + table1_launches
                  + factored_launches + app5_launches + mp_launches
                  + runner_launches + datagen_launches + apps_launches
                  + scale_launches + bench_launches),
        max_abs_err=max_err,
        bound_by="bytes",
        **timing["feature gather"],
    ), dict(
        name="stream_add_one",
        route="cuda",
        source="fgnn_tpu_torch/csrc/stream_add_one.cu",
        replaces="tools/gather_campaign.py:129",
        launches=s_launches,
        max_abs_err=s_err,
        bound_by="bytes",
        **s_timing[best],
    )] + [dict(
        name=name,
        route="cuda",
        source=f"fgnn_tpu_torch/csrc/{name}.cu",
        replaces=replaces,
        launches=(sage_counts.get(name, 0) + gcn_counts.get(name, 0)),
        max_abs_err=seg_err[name],
        bound_by="bytes",
        **{k: gcn1[name][k]
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
    ) for name, replaces in (
        ("segment_sum_rows", "fgnn_tpu/models/aggregate.py:33 (no "
         "pallas_call: the XLA ops of segment_agg's regular branch)"),
        ("scatter_add_rows", "fgnn_tpu/ops/extract.py:19 (no pallas_call: "
         "XLA's scatter-add, the VJP of device_gather)"))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
