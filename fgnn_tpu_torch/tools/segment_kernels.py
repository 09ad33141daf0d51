"""K4 (``segment_sum_rows``) and K5 (``scatter_add_rows``) on one CUDA
device, at the shapes a training step gives them, with K1 (``gather_rows``)
at GCN's gathers.

    python -m fgnn_tpu_torch.tools.segment_kernels [--out PATH]

Builds the three kernels, then samples the first batch of an epoch of GCN
[5, 10, 15] and of GraphSAGE [25, 10] (batch 8000, hidden 256, bf16) on
bench.py's 1M-node synthetic graph, and takes each layer's block as the
step takes it:

* a regular, gathered block (each GCN layer, float32 messages of the
  layer's output width; GraphSAGE's hop-0 block, bf16 messages of the
  layer's input width): K4 on ``[E, D]`` messages under the block's mask
  and K5 with the block's K and mask from the ``[dst_cap, D]`` gradient
  into the layer's source rows;
* a tiered block's ``dst_invperm`` unpermute (GraphSAGE's layer 1): K5
  with K = 1, the backward of that row gather;
* GCN's four K1 gathers: the input features (the engine's table, the
  batch's input nodes) and each layer's ``[E, D]`` messages from its
  source rows.

Then K5 on edge cases (:func:`edge_cases`): a permutation, repeats with
padding, a masked block, rows that receive no slot, a row past K5's chunk
of 128 slots and one of 100,000 slots, an all-padding block, widths 172
and 7, float32 and bf16, and a base pointer off the 8-byte grid that
forces the one-element path.

The values are random (a seeded generator on the card). Each kernel is held
against its plain version on the same inputs: K1 bit-equal; K4 and K5
within the float32 summation-order bound ``2 (n - 1) 2^-24 sum |x|`` of
each output element (n its terms; plus one bf16 rounding, ``2^-7 |ref|``,
for bf16 outputs), and bit-equal on integer-valued rows, where every sum is
exact; K5 under deterministic algorithms bit-equal over two runs and to
the plain version on integer-valued rows. Then each step shape is timed
with CUDA events (the median of 7 samples of 3 back-to-back calls queued
behind a spin, as ``gather_campaign.median_ms``; each call with the
wrapper's allocations) beside its plain version, the library call
(``where`` + ``sum`` for K4, one ``index_add_`` into a float32 buffer for
K5, ``index_select`` for K1) and its bound: the bytes the function must
move (each valid row of the input read once, the ids and mask once, each
output row written once) over 3.35 TB/s. K5 is split into its sum stage
(``csr_sum_rows`` on the sorted CSR of the same slots, which differs from
the CSR K5 builds only in the order inside a row) and the rest, its CSR
stages (count, scan, fill: K5's time less the sum's); its deterministic
mode into the sort (``sorted_segments``) and the same sum. Every line
carries the card's ``nvidia-smi`` name and power limit. Without a CUDA
device the tool exits non-zero; it has no CPU mode.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Sequence

import torch

from ..ops import cuda_lib
from ..ops.gather import KERNEL as GATHER_KERNEL
from ..ops.gather import gather_rows, gather_rows_reference
from ..ops.segment import (SCATTER_KERNEL, SEGMENT_KERNEL, csr_sum_rows,
                           scatter_add_rows, scatter_add_rows_reference,
                           segment_sum_rows, segment_sum_rows_reference,
                           sorted_segments)
from .gather_campaign import card_name, median_ms

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet, 700 W
REPS, INNER = 7, 3
U = 2.0 ** -24                # float32 unit roundoff
BF16_ULP = 2.0 ** -7          # one bf16 rounding step, relative to the value


def bound_ms(moved_bytes: int) -> float:
    return moved_bytes / HBM_BYTES_PER_S * 1e3


def block_cases(eng, batch) -> List[dict]:
    """The K4 / K5 work of one training step of ``eng`` on ``batch``, one
    dict a kernel call, in layer order."""
    from ..models.aggregate import _regular, _tiered
    from ..models.gnn import GraphConv, SAGEConv

    cases = []
    for i, (layer, block) in enumerate(zip(eng.model.layers, batch.blocks)):
        dst_cap = eng.dst_caps[i]
        src_rows = batch.input_nodes.shape[0] if i == 0 else eng.dst_caps[i - 1]
        if isinstance(layer, GraphConv):
            width, dtype = layer.weight.out_features, torch.float32
        elif isinstance(layer, SAGEConv):
            width, dtype = layer.fc_neigh.in_features, (layer.dtype
                                                        or torch.float32)
        else:
            continue
        if _regular(block, dst_cap) and block.src_slice_offset is None:
            cases.append(dict(
                label=f"layer {i + 1} regular", regular=True, block=block,
                K=block.slots_per_dst, dst_cap=dst_cap, num_rows=src_rows,
                width=width, dtype=dtype))
        elif _tiered(block):
            cases.append(dict(
                label=f"layer {i + 1} dst_invperm", regular=False,
                ids=block.dst_invperm, num_rows=dst_cap, width=width,
                dtype=dtype))
    return cases


def first_batch(eng, dev):
    seeds_all, nums_all = eng.shuffler.epoch_arrays(0)
    return eng.sample(torch.as_tensor(seeds_all[0], device=dev),
                      int(nums_all[0]), torch.Generator(dev).manual_seed(1),
                      eng.dedup_last_hop)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def _within_order(out, ref, absum, terms, what) -> float:
    """|out - ref| within the float32 summation-order bound of each element
    (plus a bf16 rounding for bf16 outputs); returns max |out - ref|."""
    diff = (out.double() - ref.double()).abs()
    tol = 2 * (terms.double() - 1).clamp(min=0) * U * absum.double()
    if out.dtype == torch.bfloat16:
        tol = tol + BF16_ULP * ref.double().abs()
    _check(bool((diff <= tol).all()),
           f"{what}: max |diff| {float(diff.max())} beyond the summation-order "
           f"bound (worst excess {float((diff - tol).max())})")
    return float(diff.max()) if diff.numel() else 0.0


def _integer_rows(shape, dtype, gen, dev):
    return torch.randint(-4, 5, shape, generator=gen, device=dev).to(dtype)


def _deterministic(fn):
    """``fn`` run under deterministic algorithms, the flag restored after."""
    def run():
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            return fn()
        finally:
            torch.use_deterministic_algorithms(was)
    return run


def _print(name, label, shape, times, moved, card):
    print(f"  {name} {label} {shape}: kernel {times['ms']:.4f} ms, plain "
          f"{times['plain_ms']:.4f}, library {times['library_ms']:.4f}, bound "
          f"{times['bound_ms']:.4f} ms ({moved} B at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s; kernel at "
          f"{times['bound_ms'] / times['ms']:.1%} of it) ({card})", flush=True)


def segment_case(case, gen, dev, card) -> dict:
    """K4 on a regular block: checks, then times."""
    block, K, dst_cap, D = case["block"], case["K"], case["dst_cap"], case["width"]
    dtype, mask = case["dtype"], block.mask
    E = dst_cap * K
    rows = torch.randn((E, D), generator=gen, device=dev).to(dtype)
    out = segment_sum_rows(rows, mask, dst_cap, K)
    ref = segment_sum_rows_reference(rows, mask, dst_cap, K)
    absum = segment_sum_rows_reference(rows.float().abs(), mask, dst_cap, K)
    terms = mask.reshape(dst_cap, K).sum(1, keepdim=True)
    err = _within_order(out, ref, absum, terms, f"K4 {case['label']}")
    ints = _integer_rows((E, D), dtype, gen, dev)
    _check(torch.equal(segment_sum_rows(ints, mask, dst_cap, K),
                       segment_sum_rows_reference(ints, mask, dst_cap, K)),
           f"K4 {case['label']}: integer rows differ from the plain version")
    m3, r3 = mask.reshape(dst_cap, K, 1), rows.reshape(dst_cap, K, D)
    k_ms, p_ms, l_ms = median_ms([
        lambda: segment_sum_rows(rows, mask, dst_cap, K),
        lambda: segment_sum_rows_reference(rows, mask, dst_cap, K),
        lambda: torch.where(m3, r3, 0).sum(1)], reps=REPS, inner=INNER)
    elt = rows.element_size()
    valid = int(mask.sum())
    moved = valid * D * elt + E + dst_cap * D * elt
    times = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                 bound_ms=bound_ms(moved), max_abs_err=err, valid_slots=valid)
    _print(SEGMENT_KERNEL, case["label"],
           f"[{E}, {D}] {str(dtype)[6:]} K={K} -> [{dst_cap}, {D}]", times,
           moved, card)
    return times


def check_scatter(grad_out, ids, num_rows, K, mask, label, gen) -> dict:
    """K5 on one scatter held against its plain version: the order bound,
    integer-valued rows bit-equal, the deterministic mode bit-equal over
    two runs and on integer-valued rows; returns the max errors, the valid
    slots and each row's count of them."""
    dev = grad_out.device
    args = (ids, num_rows, K, mask)
    out = scatter_add_rows(grad_out, *args)
    ref = scatter_add_rows_reference(grad_out, *args)
    absum = scatter_add_rows_reference(grad_out.float().abs(), *args)
    valid = ids >= 0 if mask is None else (ids >= 0) & mask
    terms = torch.bincount(ids[valid].long(), minlength=num_rows)[:, None]
    err = _within_order(out, ref, absum, terms, f"K5 {label}")
    # integer-valued rows at grad_out's offset from the 16-byte grid
    off = grad_out.data_ptr() % 16 // grad_out.element_size()
    ints = torch.empty(grad_out.numel() + off, dtype=grad_out.dtype,
                       device=dev)[off:].view(grad_out.shape)
    ints.copy_(_integer_rows(tuple(grad_out.shape), grad_out.dtype, gen, dev))
    ref_ints = scatter_add_rows_reference(ints, *args)
    _check(torch.equal(scatter_add_rows(ints, *args), ref_ints),
           f"K5 {label}: integer rows differ from the plain version")
    det = _deterministic(lambda: scatter_add_rows(grad_out, *args))
    first = det()
    _check(torch.equal(first, det()),
           f"K5 deterministic {label}: two runs differ")
    _check(torch.equal(_deterministic(
        lambda: scatter_add_rows(ints, *args))(), ref_ints),
        f"K5 deterministic {label}: integer rows differ from the plain "
        "version")
    det_err = _within_order(first, ref, absum, terms,
                            f"K5 deterministic {label}")
    return dict(err=err, det_err=det_err, valid=valid, terms=terms)


def scatter_case(case, gen, dev, card) -> Dict[str, dict]:
    """K5 (then its deterministic mode) on a regular block or a general
    unpermute: checks, then times, each split into its stages."""
    D, dtype, num_rows = case["width"], case["dtype"], case["num_rows"]
    if case["regular"]:
        block = case["block"]
        K, ids, mask, num_dst = case["K"], block.src_local, block.mask, \
            case["dst_cap"]
    else:
        K, ids, mask, num_dst = 1, case["ids"], None, case["ids"].shape[0]
    grad_out = torch.randn((num_dst, D), generator=gen, device=dev).to(dtype)
    args = (ids, num_rows, K, mask)
    c = check_scatter(grad_out, ids, num_rows, K, mask, case["label"], gen)
    valid, terms = c["valid"], c["terms"]

    ptr, idx = sorted_segments(ids, num_rows, K, mask)
    src = (grad_out if K == 1 else grad_out.unsqueeze(1).expand(
        -1, K, -1).reshape(-1, D)).float().masked_fill(~valid[:, None], 0)
    index = ids.clamp(min=0).long()
    buf = torch.zeros((num_rows, D), device=dev)
    k_ms, d_ms, sort_ms, sum_ms, p_ms, l_ms = median_ms([
        lambda: scatter_add_rows(grad_out, *args),
        _deterministic(lambda: scatter_add_rows(grad_out, *args)),
        lambda: sorted_segments(ids, num_rows, K, mask),
        lambda: csr_sum_rows(grad_out, ptr, idx),
        lambda: scatter_add_rows_reference(grad_out, *args),
        lambda: buf.index_add_(0, index, src)], reps=REPS, inner=INNER)
    del src, buf, ptr, idx
    elt = grad_out.element_size()
    E = ids.shape[0]
    moved = (num_dst * D * elt + E * 4 + (0 if mask is None else E)
             + num_rows * D * elt)
    shape = (f"[{num_dst}, {D}] {str(dtype)[6:]} K={K} -> [{num_rows}, {D}], "
             f"{int(valid.sum())} of {E} slots valid, up to "
             f"{int(terms.max())} into one row")
    result = {}
    for name, ms, e, parts in (
            (SCATTER_KERNEL, k_ms, c["err"],
             dict(sum_ms=sum_ms, csr_ms=k_ms - sum_ms)),
            (f"{SCATTER_KERNEL} deterministic", d_ms, c["det_err"],
             dict(sort_ms=sort_ms, sum_ms=sum_ms))):
        result[name] = dict(ms=ms, plain_ms=p_ms, library_ms=l_ms,
                            bound_ms=bound_ms(moved), max_abs_err=e, **parts)
        _print(name, case["label"], shape, result[name], moved, card)
        print("    " + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
              + f" ({card})", flush=True)
    return result


def gather_cases(eng, batch) -> List[dict]:
    """GCN's K1 gathers of one step: the input features, then each layer's
    messages from its source rows (float32, the layer's output width)."""
    from ..models.gnn import GraphConv

    cases = [dict(label="feature gather", table=eng.feat_dev,
                  ids=batch.input_nodes)]
    for i, (layer, block) in enumerate(zip(eng.model.layers, batch.blocks)):
        if not isinstance(layer, GraphConv):
            continue
        src_rows = batch.input_nodes.shape[0] if i == 0 else eng.dst_caps[i - 1]
        cases.append(dict(label=f"layer {i + 1} gather", ids=block.src_local,
                          shape=(src_rows, layer.weight.out_features)))
    return cases


def gather_case(case, gen, dev, card) -> dict:
    """K1 bit-equal to its plain version, then timed beside it and
    ``index_select`` over the same rows (padding clamped to row 0)."""
    ids = case["ids"]
    table = case.get("table")
    if table is None:
        table = torch.randn(case["shape"], generator=gen, device=dev)
    _check(torch.equal(gather_rows(table, ids),
                       gather_rows_reference(table, ids)),
           f"K1 {case['label']}: differs from the plain version")
    rows = ids.clamp(min=0).long()
    k_ms, p_ms, l_ms = median_ms([
        lambda: gather_rows(table, ids),
        lambda: gather_rows_reference(table, ids),
        lambda: torch.index_select(table, 0, rows)], reps=REPS, inner=INNER)
    (n, d), m = table.shape, ids.shape[0]
    valid = int((ids >= 0).sum())
    moved = (valid + m) * d * table.element_size() + m * 4
    times = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                 bound_ms=bound_ms(moved), max_abs_err=0.0)
    _print(GATHER_KERNEL, case["label"],
           f"[{n}, {d}] {str(table.dtype)[6:]}, {m} ids ({m - valid} "
           "padding)", times, moved, card)
    return times


def _edge_scatters(dev, gen):
    """``(label, ids, num_rows, K, mask)`` of each edge case."""
    def randint(hi, n):
        return torch.randint(0, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    def rand(n):
        return torch.rand(n, generator=gen, device=dev)

    def hub(ids, row, n):
        ids[torch.randperm(ids.shape[0], generator=gen, device=dev)[:n]] = row
        return ids

    yield "permutation", torch.randperm(
        80_000, generator=gen, device=dev).int(), 80_000, 1, None
    ids = randint(30_000, 60_000)
    yield "repeats with padding", torch.where(
        rand(ids.shape[0]) < 0.25, -1, ids).int(), 30_000, 1, None
    ids, mask = randint(20_000, 8_000 * 5), rand(8_000 * 5) < 0.7
    yield "masked block", torch.where(
        ~mask & (rand(ids.shape[0]) < 0.5), -1, ids).int(), 20_000, 5, mask
    yield ("rows without slots", randint(5_000, 4_000 * 5), 15_000, 5,
           rand(4_000 * 5) < 0.8)
    yield ("a row of 1,000 slots", hub(randint(10_000, 4_000 * 5), 7, 1_000),
           10_000, 5, torch.ones(4_000 * 5, dtype=torch.bool, device=dev))
    yield ("a row of 100,000 slots", hub(randint(50_000, 150_000), 5,
                                         100_000), 50_000, 1, None)
    yield ("all padding", torch.full((2_000 * 5,), -1, dtype=torch.int32,
                                     device=dev), 3_000, 5,
           torch.zeros(2_000 * 5, dtype=torch.bool, device=dev))


def edge_cases(dev, gen) -> Dict[str, dict]:
    """K5 on the cases a step's blocks may not show, each checked as the
    step shapes are (:func:`check_scatter`): widths 172 and 7 in float32
    and bf16, and 256 wide with ``grad_out`` one element off its 8-byte
    grid (the one-element path). Returns each case's max errors."""
    results = {}
    for label, ids, num_rows, K, mask in _edge_scatters(dev, gen):
        num_dst = ids.shape[0] // K
        for D, dtype, misaligned in ((172, torch.float32, False),
                                     (172, torch.bfloat16, False),
                                     (7, torch.float32, False),
                                     (7, torch.bfloat16, False),
                                     (256, torch.float32, True),
                                     (256, torch.bfloat16, True)):
            name = (f"{label}, D {D} {str(dtype)[6:]}"
                    + (", misaligned" if misaligned else ""))
            flat = torch.empty(num_dst * D + misaligned, dtype=dtype,
                               device=dev)
            g = flat[int(misaligned):].view(num_dst, D)
            g.copy_(torch.randn((num_dst, D), generator=gen, device=dev))
            _check(misaligned == (g.data_ptr() % 8 != 0),
                   f"{name}: alignment not as the case needs")
            c = check_scatter(g, ids, num_rows, K, mask, name, gen)
            results[name] = dict(max_abs_err=c["err"],
                                 det_max_abs_err=c["det_err"])
    print(f"  K5 edge cases: {len(results)} held against the plain version",
          flush=True)
    return results


def run(dev, card, engines) -> Dict[str, dict]:
    """Every K4 / K5 call of one training step of each ``(name, engine)``
    and GCN's K1 gathers, checked and timed; ``{"<name> <case>": {kernel:
    times}}``."""
    gen = torch.Generator(dev).manual_seed(0)
    results = {}
    for name, eng in engines:
        batch = first_batch(eng, dev)
        for case in block_cases(eng, batch):
            label = f"{name} {case['label']}"
            case = dict(case, label=label)
            entry = {}
            if case["regular"]:
                entry[SEGMENT_KERNEL] = segment_case(case, gen, dev, card)
            entry.update(scatter_case(case, gen, dev, card))
            results[label] = entry
        if name == "GCN":
            for case in gather_cases(eng, batch):
                label = f"{name} {case['label']}"
                results[label] = {GATHER_KERNEL: gather_case(
                    dict(case, label=label), gen, dev, card)}
        del batch
        torch.cuda.empty_cache()
    return results


def bench_engines(dev, ds):
    """GCN [5, 10, 15] and GraphSAGE [25, 10] at batch 8000, hidden 256,
    bf16, dropout 0.5, lr 0.003 (the benchmark's GCN and main-path cells'
    configurations)."""
    from ..config import RunConfig, SampleType
    from ..engine import OneChipEngine

    base = RunConfig(batch_size=8000, num_hidden=256, dropout=0.5, lr=0.003,
                     compute_dtype="bfloat16",
                     sample_type=SampleType.KHOP2)
    return [("GCN", OneChipEngine(base.replace(model="gcn", fanout=(5, 10, 15)),
                                  ds, dev)),
            ("GraphSAGE", OneChipEngine(base.replace(model="graphsage",
                                                     fanout=(25, 10)), ds, dev))]


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join("chiprun_out",
                                                 "segment_kernels.json"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("segment_kernels: no CUDA device", file=sys.stderr)
        return 1
    from ..data import make_synthetic_dataset

    card = card_name()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    cuda_lib.build([GATHER_KERNEL, SEGMENT_KERNEL, SCATTER_KERNEL])
    ds = make_synthetic_dataset(num_node=1_000_000, avg_degree=15,
                                feat_dim=128, num_class=172, train_frac=0.25,
                                seed=0)
    results = run(dev, card, bench_engines(dev, ds))
    edges = edge_cases(dev, torch.Generator(dev).manual_seed(1))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "results": results, "edge_cases": edges},
                  f, indent=1)
    print(json.dumps({"card": card, "cases": len(results),
                      "edge_cases": len(edges)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
