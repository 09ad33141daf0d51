"""Pre-sampling cache policy, the source paper's headline contribution
(port of ``fgnn_tpu/cache/presample.py``).

PreSampler::DoPreSample (cuda/pre_sampler.cc:57-132): before training, run
the configured sampler for ``presample_epoch`` epochs and count how often
each vertex appears in a batch's ``input_nodes``; rank the vertices by that
count, hottest first. The count stays on the device, one scatter-add per
batch; only the final counts come to the host, where a stable descending
sort ranks them (frequency descending, id ascending), as the reference
does.

PRESAMPLE_STATIC (DoGPUSampleAllNeighbour, cuda_loops.cc:500-575) counts
every CSR neighbour of the sampled frontier instead, on the host.

Draws: a generator on the sampler's device, seeded ``seed ^ 0x9E3779B9``
(static: ``seed ^ 0x51BA11``), the reference's key seeds. ``rand(epoch,
step)`` injects a step's per-hop uniforms instead, which is how the tests
feed the reference's own draws.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..parallel.shuffler import EpochShuffler
from ..utils import Timer, get_logger
from ..utils.profiler import Profiler

log = get_logger(__name__)

PRESAMPLE_SEED = 0x9E3779B9
PRESAMPLE_STATIC_SEED = 0x51BA11

# (seeds [seed_cap] int32, num_seeds, rand) -> batch with .input_nodes
SampleFn = Callable[[torch.Tensor, int, object], object]
RandFn = Callable[[int, int], Sequence[torch.Tensor]]


def _presample_batches(sample_fn: SampleFn, shuffler: EpochShuffler,
                       device, presample_epoch: int, seed: int,
                       rand: Optional[RandFn]):
    """Every presample batch's ``input_nodes``, on ``device``."""
    gen = torch.Generator(device).manual_seed(seed)
    for epoch in range(presample_epoch):
        seeds_all, nums_all = shuffler.epoch_arrays(epoch)
        seeds_dev = torch.as_tensor(seeds_all, device=device)
        for step in range(shuffler.num_step):
            draws = gen if rand is None else rand(epoch, step)
            yield sample_fn(seeds_dev[step], int(nums_all[step]),
                            draws).input_nodes


def _rank(freq: np.ndarray) -> np.ndarray:
    return np.argsort(-freq.astype(np.int64), kind="stable").astype(np.int32)


def presample_ranking(
    sample_fn: SampleFn,
    shuffler: EpochShuffler,
    num_node: int,
    device,
    presample_epoch: int = 1,
    seed: int = 0,
    rand: Optional[RandFn] = None,
) -> np.ndarray:
    """Run the presample epochs; return the ranking (hottest first).

    ``sample_fn`` must be the engine's own sampler with the training
    dedup mode (the reference's presample dedups every hop), so the counted
    distribution is the one training reads."""
    t = Timer()
    freq = torch.zeros(num_node + 1, dtype=torch.int32, device=device)
    for ids in _presample_batches(sample_fn, shuffler, device, presample_epoch,
                                  seed ^ PRESAMPLE_SEED, rand):
        idx = torch.where(ids >= 0, ids, num_node).long()   # padding -> spare
        freq.index_add_(0, idx, torch.ones_like(ids))
    freq_np = freq[:num_node].cpu().numpy()
    ranking = _rank(freq_np)
    Profiler.get().log_init("init_presample", t.passed())
    log.info("presample: %d epochs in %.2fs; top node freq=%d",
             presample_epoch, t.passed(), int(freq_np.max(initial=0)))
    return ranking


def presample_static_ranking(
    sample_fn: SampleFn,
    shuffler: EpochShuffler,
    indptr: np.ndarray,
    indices: np.ndarray,
    num_node: int,
    device,
    presample_epoch: int = 1,
    seed: int = 0,
    rand: Optional[RandFn] = None,
) -> np.ndarray:
    """PRESAMPLE_STATIC: count each sampled input node and every CSR
    neighbour of it, on the host (init time only)."""
    t = Timer()
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    freq = np.zeros(num_node, dtype=np.int64)
    for ids_dev in _presample_batches(sample_fn, shuffler, device,
                                      presample_epoch,
                                      seed ^ PRESAMPLE_STATIC_SEED, rand):
        ids = ids_dev.cpu().numpy()
        ids = ids[ids >= 0]
        np.add.at(freq, ids, 1)
        # expand to ALL neighbours of the frontier
        starts = indptr[ids]
        lens = (indptr[ids + 1] - starts).astype(np.int64)
        total = int(lens.sum())
        if total:
            base_off = np.repeat(np.cumsum(lens) - lens, lens)
            flat = (np.repeat(starts, lens)
                    + np.arange(total, dtype=np.int64) - base_off)
            np.add.at(freq, indices[flat], 1)
    ranking = _rank(freq)
    Profiler.get().log_init("init_presample", t.passed())
    log.info("presample-static: %d epochs in %.2fs", presample_epoch,
             t.passed())
    return ranking
