"""Synthetic power-law graph generator + dataset writer (the port's copy of
``fgnn_tpu/data/synthetic.py``).

Generates a skewed-degree CSR graph for tests and runs without a download,
and writes a dataset in the source system's binary layout (meta.txt + .bin,
datagen/README.md:30-47) so the mmap loader round-trips. For the same
arguments it gives the reference's arrays bit for bit: it draws from the
same NumPy generator in the same order.
"""
from __future__ import annotations

import os

import numpy as np

from .. import constants
from .schema import Dataset


def make_synthetic_dataset(
    num_node: int = 10_000,
    avg_degree: int = 15,
    feat_dim: int = 64,
    num_class: int = 16,
    train_frac: float = 0.1,
    seed: int = 0,
    power: float = 1.5,
    neighbor_skew: float = 2.0,
    name: str = "synthetic",
    empty_feat_rows: int = 0,
    neighbor_lognormal_sigma: float = 0.0,
    neighbor_pref: float = 0.0,
) -> Dataset:
    """Zipf-ish degree distribution so cache policies have hot vertices.

    ``neighbor_skew`` controls access concentration (u**skew neighbour
    choice): 2.0 (default) is mild; 6-8 approaches papers100M-like hot-set
    behaviour where a 10-20% cache captures most accesses.

    ``neighbor_pref`` is the fraction of edges whose hot-target choice is
    mapped through the out-degree ranking (preferential attachment) instead
    of a random permutation. 0.0 keeps access popularity independent of
    out-degree (a degree ranking then caches no better than a random one);
    ~0.5 puts a degree ranking between random and presample.

    ``neighbor_lognormal_sigma`` > 0 draws each edge's target with
    probability proportional to a per-node lognormal(sigma) weight, as
    per-node Poisson counts plus one shuffle.

    ``empty_feat_rows`` > 0 makes a small fake feature table of that many
    rows, indexed modulo (SAMGRAPH_EMPTY_FEAT analog), with random labels.
    """
    rng = np.random.default_rng(seed)
    # degree ~ bounded pareto, mean scaled to avg_degree
    raw = rng.pareto(power, size=num_node) + 1.0
    deg = np.minimum(raw / raw.mean() * avg_degree, num_node - 1).astype(np.int64)
    deg = np.maximum(deg, 1)
    indptr = np.zeros(num_node + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    num_edge = int(indptr[-1])
    # bias neighbour choice toward low ids, then permute ids so hot
    # vertices are scattered. The edge uniforms are drawn in either branch,
    # so the stream stays the reference's; the lognormal branch reads none
    # of them and skips their draws in place (one 64-bit draw each)
    if neighbor_lognormal_sigma > 0:
        rng.bit_generator.advance(num_edge)
        w = rng.lognormal(0.0, neighbor_lognormal_sigma, size=num_node)
        cnt = rng.poisson(w * (num_edge / w.sum()))
        nbr = np.repeat(
            np.arange(num_node, dtype=np.int64), cnt
        )
        rng.shuffle(nbr)
        if len(nbr) >= num_edge:
            nbr = nbr[:num_edge]
        else:  # Poisson total came up short: top up uniformly
            extra = rng.integers(0, num_node, num_edge - len(nbr))
            nbr = np.concatenate([nbr, extra])
    else:
        u = rng.random(num_edge)
        nbr = (u ** neighbor_skew * num_node).astype(np.int64)  # skew->small
        del u
    np.minimum(nbr, num_node - 1, out=nbr)
    perm = rng.permutation(num_node)
    if neighbor_pref > 0.0:
        order = np.argsort(-deg)  # rank r -> node with r-th highest out-degree
        use_pref = rng.random(num_edge) < neighbor_pref
        indices = np.where(use_pref, order[nbr], perm[nbr]).astype(np.int32)
    else:
        # ids fit int32: taking from an int32 perm writes the result
        # directly, with no int64 copy of every edge
        indices = perm.astype(np.int32)[nbr]

    if empty_feat_rows:
        feat = rng.standard_normal(
            (min(empty_feat_rows, num_node), feat_dim), dtype=np.float32
        )
        label = rng.integers(0, num_class, num_node).astype(np.int32)
    else:
        feat = rng.standard_normal((num_node, feat_dim), dtype=np.float32)
        # learnable labels: argmax of a random linear map of features plus
        # noise, so a GNN that sees a node's own features can converge
        w = rng.standard_normal((feat_dim, num_class)).astype(np.float32)
        logits = feat @ w + 2.0 * rng.standard_normal(
            (num_node, num_class)
        ).astype(np.float32)
        label = np.argmax(logits, axis=1).astype(np.int32)

    ids = rng.permutation(num_node).astype(np.int32)
    n_train = max(1, int(num_node * train_frac))
    n_test = max(1, int(num_node * 0.05))
    n_valid = max(1, int(num_node * 0.05))

    ds = Dataset(
        name=name,
        num_node=num_node,
        num_edge=num_edge,
        num_class=num_class,
        indptr=indptr,
        indices=indices,
        feat=feat,
        label=label,
        train_set=ids[:n_train].copy(),
        test_set=ids[n_train : n_train + n_test].copy(),
        valid_set=ids[n_train + n_test : n_train + n_test + n_valid].copy(),
        empty_feat=bool(empty_feat_rows) and feat.shape[0] < num_node,
    )
    ds.validate()
    return ds


def build_alias_tables(ds: Dataset, seed: int = 0) -> None:
    """Per-vertex alias tables over edge weights for weighted sampling
    (utility/data-process/toolkit/weight/create_alias_table.cc analog).

    Edge weights are uniform-random so weighted sampling is
    distinguishable from uniform. Tables are laid out per edge slot
    (Dataset::prob_table/alias_table, common.h:170-172): to draw a
    neighbour of v, pick slot j ~ U[0,deg), accept indices[off+j] with
    probability prob_table[off+j], else take indices[off + alias_table[off+j]].
    """
    rng = np.random.default_rng(seed)
    weights = rng.random(ds.num_edge).astype(np.float64) + 0.1
    prob = np.zeros(ds.num_edge, dtype=np.float32)
    alias = np.zeros(ds.num_edge, dtype=np.int32)
    prefix = np.zeros(ds.num_edge, dtype=np.float32)
    indptr = ds.indptr
    for v in range(ds.num_node):
        off, end = int(indptr[v]), int(indptr[v + 1])
        d = end - off
        if d == 0:
            continue
        w = weights[off:end]
        prefix[off:end] = np.cumsum(w)
        p = w / w.sum() * d  # scaled probs, mean 1
        small = [j for j in range(d) if p[j] < 1.0]
        large = [j for j in range(d) if p[j] >= 1.0]
        pp = p.copy()
        while small and large:
            s, l = small.pop(), large.pop()
            prob[off + s] = pp[s]
            alias[off + s] = l
            pp[l] = pp[l] - (1.0 - pp[s])
            (small if pp[l] < 1.0 else large).append(l)
        for j in small + large:
            prob[off + j] = 1.0
            alias[off + j] = j
    ds.prob_table = prob
    ds.alias_table = alias
    ds.prob_prefix_table = prefix


def write_dataset(ds: Dataset, root: str) -> str:
    """Write ``ds`` under ``root/<name>`` in the source system's binary
    layout (datagen/README.md:30-47); returns the directory."""
    d = os.path.join(root, ds.name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, constants.META_FILE), "w") as f:
        f.write(f"{constants.META_NUM_NODE} {ds.num_node}\n")
        f.write(f"{constants.META_NUM_EDGE} {ds.num_edge}\n")
        f.write(f"{constants.META_FEAT_DIM} {ds.feat_dim}\n")
        f.write(f"{constants.META_NUM_CLASS} {ds.num_class}\n")
        f.write(f"{constants.META_NUM_TRAIN_SET} {len(ds.train_set)}\n")
        f.write(f"{constants.META_NUM_TEST_SET} {len(ds.test_set)}\n")
        f.write(f"{constants.META_NUM_VALID_SET} {len(ds.valid_set)}\n")

    def w(fname, arr, dtype):
        np.ascontiguousarray(arr, dtype=dtype).tofile(os.path.join(d, fname))

    w(constants.INDPTR_FILE, ds.indptr, np.uint32)
    w(constants.INDICES_FILE, ds.indices.view(np.uint32), np.uint32)
    w(constants.FEAT_FILE, ds.feat, np.float32)
    w(constants.LABEL_FILE, ds.label.astype(np.uint64), np.uint64)
    w(constants.TRAIN_SET_FILE, ds.train_set.view(np.uint32), np.uint32)
    w(constants.TEST_SET_FILE, ds.test_set.view(np.uint32), np.uint32)
    w(constants.VALID_SET_FILE, ds.valid_set.view(np.uint32), np.uint32)
    if ds.prob_table is not None:
        w(constants.PROB_TABLE_FILE, ds.prob_table, np.float32)
        w(constants.ALIAS_TABLE_FILE, ds.alias_table.view(np.uint32), np.uint32)
        w(constants.PROB_PREFIX_TABLE_FILE, ds.prob_prefix_table, np.float32)
    return d
