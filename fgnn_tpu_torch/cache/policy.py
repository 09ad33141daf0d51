"""Cache ranking policies (port of ``fgnn_tpu/cache/policy.py``; NumPy).

Analogs of the source system's precomputed ``cache_by_*.bin`` rankers
(utility/data-process/toolkit/cache/cache_by_{degree,degree_hop,heuristic,
fake_optimal,random}.cc). A ranking is a permutation of node ids, hottest
first; the cache takes the top ``cache_percentage * num_node`` entries. The
presampling policies are in :mod:`fgnn_tpu_torch.cache.presample`. Every
ranking equals the reference's: the same stable sorts and the same NumPy
generator.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import CachePolicy
from ..data.schema import Dataset


def rank_by_degree(ds: Dataset) -> np.ndarray:
    """cache_by_degree.cc: sort by out-degree descending."""
    deg = ds.degrees()
    return np.argsort(-deg.astype(np.int64), kind="stable").astype(np.int32)


def rank_by_degree_hop(ds: Dataset) -> np.ndarray:
    """cache_by_degree_hop.cc: rank by expected two-hop reach, degree(v)
    plus the sum of degree(u) over v's neighbours u (one segment sum over
    the CSR)."""
    deg = ds.degrees().astype(np.float64)
    indptr = np.asarray(ds.indptr)
    indices = np.asarray(ds.indices)
    nbr_deg = deg[indices]
    # sum per CSR segment; cumsum-diff avoids np.add.at's slow scatter
    csum = np.concatenate([[0.0], np.cumsum(nbr_deg)])
    nbr_deg_sum = csum[indptr[1:]] - csum[indptr[:-1]]
    score = deg + nbr_deg_sum
    return np.argsort(-score, kind="stable").astype(np.int32)


def rank_by_heuristic(ds: Dataset) -> np.ndarray:
    """cache_by_heuristic.cc: training seeds are always touched, so they
    rank above every other node, then by degree."""
    deg = ds.degrees().astype(np.float64)
    score = deg.copy()
    score[ds.train_set] += deg.max() + 1
    return np.argsort(-score, kind="stable").astype(np.int32)


def rank_random(ds: Dataset, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.permutation(ds.num_node).astype(np.int32)


def rank_fake_optimal(access_freq: np.ndarray) -> np.ndarray:
    """cache_by_fake_optimal.cc: rank by the true access frequency of a
    profiling run."""
    return np.argsort(-access_freq.astype(np.int64), kind="stable").astype(np.int32)


def build_ranking(
    ds: Dataset,
    policy: CachePolicy,
    seed: int = 0,
    access_freq: Optional[np.ndarray] = None,
) -> np.ndarray:
    if policy == CachePolicy.DEGREE:
        return rank_by_degree(ds)
    if policy == CachePolicy.DEGREE_HOP:
        return rank_by_degree_hop(ds)
    if policy == CachePolicy.HEURISTIC:
        return rank_by_heuristic(ds)
    if policy == CachePolicy.RANDOM:
        return rank_random(ds, seed)
    if policy == CachePolicy.FAKE_OPTIMAL:
        if access_freq is None:
            raise ValueError("fake_optimal needs an access log (access_freq)")
        return rank_fake_optimal(access_freq)
    if policy in (CachePolicy.PRESAMPLE, CachePolicy.PRESAMPLE_STATIC):
        raise ValueError("use fgnn_tpu_torch.cache.presample for presample")
    raise ValueError(f"no ranking builder for {policy}")
