"""K4 (``segment_sum_rows``) and K5 (``scatter_add_rows``) on one CUDA
device, at the shapes a training step gives them.

    python -m fgnn_tpu_torch.tools.segment_kernels [--out PATH]

Builds both kernels, then samples the first batch of an epoch of GCN
[5, 10, 15] and of GraphSAGE [25, 10] (batch 8000, hidden 256, bf16) on
bench.py's 1M-node synthetic graph, and takes each layer's block as the
step takes it:

* a regular, gathered block (each GCN layer, float32 messages of the
  layer's output width; GraphSAGE's hop-0 block, bf16 messages of the
  layer's input width): K4 on ``[E, D]`` messages under the block's mask
  and K5 in regular mode from the ``[dst_cap, D]`` gradient into the
  layer's source rows;
* a tiered block's ``dst_invperm`` unpermute (GraphSAGE's layer 1): K5 in
  general mode (K = 1), the backward of that row gather.

The values are random (a seeded generator on the card). Each kernel is held
against its plain version on the same inputs: K4 and atomic K5 within the
float32 summation-order bound ``2 (n - 1) 2^-24 sum |x|`` of each output
element (n its terms; plus one bf16 rounding, ``2^-7 |ref|``, for bf16
outputs), and bit-equal on integer-valued rows, where every sum is exact;
K5 under deterministic algorithms bit-equal over two runs and to the plain
version on integer-valued rows. Then each is timed with CUDA events (the
median of 7 samples of 3 back-to-back calls queued behind a spin, as
``gather_campaign.median_ms``) beside its plain version, the library call
(``where`` + ``sum`` for K4, one ``index_add_`` into a float32 buffer for
K5) and its bound: the bytes the function must move (each valid row of the
input read once, the ids and mask once, each output row written once) over
3.35 TB/s. Every line carries the card's ``nvidia-smi`` name and power
limit. Without a CUDA device the tool exits non-zero; it has no CPU mode.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Sequence

import torch

from ..ops import cuda_lib
from ..ops.segment import (SCATTER_KERNEL, SEGMENT_KERNEL, scatter_add_rows,
                           scatter_add_rows_reference, segment_sum_rows,
                           segment_sum_rows_reference)
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


def scatter_case(case, gen, dev, card) -> Dict[str, dict]:
    """K5 (atomic, then deterministic) on a regular block or a general
    unpermute: checks, then times."""
    D, dtype, num_rows = case["width"], case["dtype"], case["num_rows"]
    if case["regular"]:
        block = case["block"]
        K, ids, mask, num_dst = case["K"], block.src_local, block.mask, \
            case["dst_cap"]
    else:
        K, ids, mask, num_dst = 1, case["ids"], None, case["ids"].shape[0]
    grad_out = torch.randn((num_dst, D), generator=gen, device=dev).to(dtype)
    args = (ids, num_rows, K, mask)
    out = scatter_add_rows(grad_out, *args)
    ref = scatter_add_rows_reference(grad_out, *args)
    absum = scatter_add_rows_reference(grad_out.float().abs(), *args)
    valid = ids >= 0 if mask is None else (ids >= 0) & mask
    terms = torch.bincount(ids[valid].long(), minlength=num_rows)[:, None]
    err = _within_order(out, ref, absum, terms, f"K5 {case['label']}")
    ints = _integer_rows((num_dst, D), dtype, gen, dev)
    ref_ints = scatter_add_rows_reference(ints, *args)
    _check(torch.equal(scatter_add_rows(ints, *args), ref_ints),
           f"K5 {case['label']}: integer rows differ from the plain version")
    det = _deterministic(lambda: scatter_add_rows(grad_out, *args))
    det_ints = _deterministic(lambda: scatter_add_rows(ints, *args))
    first = det()
    _check(torch.equal(first, det()),
           f"K5 deterministic {case['label']}: two runs differ")
    _check(torch.equal(det_ints(), ref_ints),
           f"K5 deterministic {case['label']}: integer rows differ from the "
           "plain version")
    det_err = _within_order(first, ref, absum, terms,
                            f"K5 deterministic {case['label']}")

    src = (grad_out if K == 1 else grad_out.unsqueeze(1).expand(
        -1, K, -1).reshape(-1, D)).float().masked_fill(~valid[:, None], 0)
    index = ids.clamp(min=0).long()
    buf = torch.zeros((num_rows, D), device=dev)
    k_ms, d_ms, p_ms, l_ms = median_ms([
        lambda: scatter_add_rows(grad_out, *args), det,
        lambda: scatter_add_rows_reference(grad_out, *args),
        lambda: buf.index_add_(0, index, src)], reps=REPS, inner=INNER)
    del src, buf
    elt = grad_out.element_size()
    E = ids.shape[0]
    moved = (num_dst * D * elt + E * 4 + (0 if mask is None else E)
             + num_rows * D * elt)
    shape = (f"[{num_dst}, {D}] {str(dtype)[6:]} K={K} -> [{num_rows}, {D}], "
             f"{int(valid.sum())} of {E} slots valid, up to "
             f"{int(terms.max())} into one row")
    result = {}
    for name, ms, e in ((SCATTER_KERNEL, k_ms, err),
                        (f"{SCATTER_KERNEL} deterministic", d_ms, det_err)):
        result[name] = dict(ms=ms, plain_ms=p_ms, library_ms=l_ms,
                            bound_ms=bound_ms(moved), max_abs_err=e)
        _print(name, case["label"], shape, result[name], moved, card)
    return result


def run(dev, card, engines) -> Dict[str, dict]:
    """Every K4 / K5 call of one training step of each ``(name, engine)``,
    checked and timed; ``{"<name> <case>": {kernel: times}}``."""
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
    cuda_lib.build([SEGMENT_KERNEL, SCATTER_KERNEL])
    ds = make_synthetic_dataset(num_node=1_000_000, avg_degree=15,
                                feat_dim=128, num_class=172, train_frac=0.25,
                                seed=0)
    results = run(dev, card, bench_engines(dev, ds))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "results": results}, f, indent=1)
    print(json.dumps({"card": card, "cases": len(results)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
