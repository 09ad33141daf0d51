"""NumPy cap calibration (port of ``fgnn_tpu/ops/reference_impl.py``).

:func:`calibrate_caps` runs a few NumPy sampling probes to measure per-hop
unique counts and last-hop degree-tier counts, which :func:`make_plan` turns
into static caps. It consumes the NumPy generator in the same order as the
reference, so both frameworks get the same plan from the same seed.
``replace=True`` samples with replacement, as KHOP1 does; every other
sampler, the weighted ones included, calibrates as a uniform sampler
without replacement, as in the reference.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def np_sample_hop_vec(
    rng: np.random.Generator,
    indptr: np.ndarray,
    indices: np.ndarray,
    seeds: np.ndarray,
    fanout: int,
    replace: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorised hop sampler, uniform with replacement or without it
    (Floyd).

    seeds: [n] valid node ids. Returns (nbr [n, fanout] int32 -1-padded,
    valid mask [n, fanout]).
    """
    n = len(seeds)
    off = indptr[seeds]
    deg = (indptr[seeds + 1] - off).astype(np.int64)
    u = rng.random((n, fanout))
    if replace:
        idx = np.minimum((u * deg[:, None]).astype(np.int64), deg[:, None] - 1)
        valid = np.broadcast_to((deg > 0)[:, None], idx.shape)
    else:
        idx = np.full((n, fanout), -1, dtype=np.int64)
        big = deg >= fanout
        for j in range(fanout):
            J = deg - fanout + j
            t = np.minimum((u[:, j] * (J + 1)).astype(np.int64), J)
            if j > 0:
                coll = (idx[:, :j] == t[:, None]).any(axis=1)
                t = np.where(coll, J, t)
            small = np.where(j < deg, j, -1)
            idx[:, j] = np.where(big, t, small)
        valid = idx >= 0
    flat = off[:, None] + np.maximum(idx, 0)
    nbr = indices[np.minimum(flat, len(indices) - 1)].astype(np.int32)
    return np.where(valid, nbr, -1), valid


def calibrate_caps(
    indptr: np.ndarray,
    indices: np.ndarray,
    train_set: np.ndarray,
    batch_size: int,
    fanouts_sampling_order: Sequence[int],
    num_probe: int = 8,
    seed: int = 0,
    replace: bool = False,
    tier_candidates: Optional[Sequence[int]] = None,
):
    """Per-hop ``(cumulative, new)`` unique-count caps from probe batches.

    Each cap is the max over probes plus the probe-to-probe range as
    headroom. With ``tier_candidates`` also returns ``{t: [per-probe count
    of last-hop frontier vertices with deg > t]}`` for the tier search.
    ``replace`` is the probes' sampling with replacement.
    """
    rng = np.random.default_rng(seed)
    num_probe = max(2, num_probe)
    obs: List[List[int]] = [[] for _ in fanouts_sampling_order]
    obs_new: List[List[int]] = [[] for _ in fanouts_sampling_order]
    tier_obs = {fB: [] for fB in (tier_candidates or ())}
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    last = len(fanouts_sampling_order) - 1
    for _ in range(num_probe):
        seeds = rng.choice(train_set, size=min(batch_size, len(train_set)),
                           replace=False)
        cur = np.unique(seeds)
        for l, f in enumerate(fanouts_sampling_order):
            if l == last and tier_obs:
                deg = indptr[cur + 1] - indptr[cur]
                for fB in tier_obs:
                    tier_obs[fB].append(int((deg > fB).sum()))
            nbr, valid = np_sample_hop_vec(rng, indptr, indices, cur, f,
                                           replace)
            uniq = np.union1d(cur, nbr[valid])
            obs[l].append(len(uniq))
            obs_new[l].append(len(uniq) - len(cur))
            cur = uniq
    caps = []
    for counts, news in zip(obs, obs_new):
        hi, lo = max(counts), min(counts)
        nhi, nlo = max(news), min(news)
        caps.append((hi + (hi - lo), nhi + (nhi - nlo)))
    if tier_candidates is not None:
        return caps, tier_obs
    return caps
