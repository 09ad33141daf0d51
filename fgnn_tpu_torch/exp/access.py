"""The offline node-access pass of the cache-policy experiments (fig5,
fig10, fig11, table2).

Each of the reference's runners repeats one loop (exp/fig5/run.py:64-75,
exp/fig10/run.py:66-78, exp/fig11/run.py:57-68, exp/table2/run.py:68-79):
sample the epoch's batches with the engine's sampler, every hop
deduplicated (the reference's ``sample_jit`` defaults to ``dedup=True``),
keep each batch's ``input_nodes >= 0``, count the accesses per node, and
score a ranking's top k over those same batches. Here the ids stay on the
engine's device: counts are one ``torch.bincount``, a ranking's cached set
one boolean mask, and only the totals come to the host. Hit rates and
similarities are counts, so they carry across devices.

Draws: ``rand(epoch, step)`` gives a step's draws, a generator or one
uniforms tensor per hop (``OneChipEngine.sample``). :func:`step_draws` is
the port's: a generator on the engine's device per step, keyed ``(base,
epoch * stride + step)`` as each reference keys ``fold_in(key(base), ...)``.
A runner's ``draws(eng, base, stride)`` hook replaces it; the tests pass the
reference's own uniforms that way.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..cache.presample import PRESAMPLE_SEED, presample_ranking
from ..parallel.factored import step_generator

RandFn = Callable[[int, int], object]
DrawsFn = Callable[[object, int, int], RandFn]


def step_draws(eng, base: int, stride: int) -> RandFn:
    """The port's draws of step ``step`` of ``epoch``: a generator on the
    engine's device keyed ``(base, epoch * stride + step)``."""
    return lambda epoch, step: step_generator(eng.device, base,
                                              epoch * stride + step)


def epoch_accesses(eng, epochs: Sequence[int],
                   rand: RandFn) -> List[List[torch.Tensor]]:
    """For each epoch, each batch's valid input nodes (int64, on the
    engine's device), sampled with every hop deduplicated."""
    out = []
    for epoch in epochs:
        seeds_all, nums_all = eng.shuffler.epoch_arrays(epoch)
        seeds_dev = torch.as_tensor(seeds_all, device=eng.device)
        batches = []
        for step in range(eng.shuffler.num_step):
            ids = eng.sample(seeds_dev[step], int(nums_all[step]),
                             rand(epoch, step), True).input_nodes
            batches.append(ids[ids >= 0].long())
        out.append(batches)
    return out


def presample(eng, draws: Optional[DrawsFn] = None) -> np.ndarray:
    """The runners' presample ranking: one epoch through the engine's
    sampler, every hop deduplicated, seed 0; with ``draws``, the draws of
    the reference's presample key ``(seed ^ 0x9E3779B9, epoch * num_step +
    step)``."""
    rand = draws and draws(eng, PRESAMPLE_SEED, eng.shuffler.num_step)
    return presample_ranking(lambda s, n, r: eng.sample(s, n, r, True),
                             eng.shuffler, eng.ds.num_node, eng.device,
                             presample_epoch=1, seed=0, rand=rand)


def access_counts(accesses: torch.Tensor, num_node: int) -> np.ndarray:
    """Accesses per node (the optimal ranking's input), on the host."""
    return torch.bincount(accesses, minlength=num_node).cpu().numpy()


def cached_mask(ranking: np.ndarray, k: int, device) -> torch.Tensor:
    """The nodes a cache of the ranking's top ``k`` holds."""
    mask = torch.zeros(len(ranking), dtype=torch.bool, device=device)
    mask[torch.as_tensor(np.asarray(ranking[:k]), device=device).long()] = True
    return mask


def hit_rate(ranking: np.ndarray, accesses: torch.Tensor, k: int) -> float:
    """The share of ``accesses`` (all the batches' ids, concatenated) that
    a cache of the ranking's top ``k`` serves."""
    hits = int(cached_mask(ranking, k, accesses.device)[accesses].sum())
    return hits / max(accesses.numel(), 1)


def touched(batches: Sequence[torch.Tensor], num_node: int) -> torch.Tensor:
    """The set of nodes an epoch's batches touch, as a boolean mask."""
    mask = torch.zeros(num_node, dtype=torch.bool,
                       device=batches[0].device if batches else "cpu")
    for ids in batches:
        mask[ids] = True
    return mask


def epoch_similarity(masks: Sequence[torch.Tensor]) -> float:
    """The mean Jaccard similarity (%) of consecutive epochs' touched sets
    (node_access:epoch_similarity, profiler.cc:657-791)."""
    sims = []
    for a, b in zip(masks, masks[1:]):
        inter = int((a & b).sum())
        union = int((a | b).sum())
        sims.append(100.0 * inter / max(union, 1))
    return float(np.mean(sims)) if sims else 0.0
