"""Train-set shufflers (port of ``fgnn_tpu/parallel/shuffler.py``).

The epoch permutation is seeded by epoch number from NumPy, exactly as in
the reference, so both frameworks walk the same batches in the same order.
Every worker of a multi-device engine derives the same global order and
takes its own steps of it: :class:`DistShuffler` a contiguous range
(arch5's samplers), :class:`AlignedDistShuffler` a stride with the epoch
padded to a whole number of local steps (arch6). Step ids stay global.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def _num_step(n: int, batch_size: int) -> int:
    return (n + batch_size - 1) // batch_size


class EpochShuffler:
    """Single-worker epoch shuffler (GPUShuffler analog)."""

    def __init__(self, train_set: np.ndarray, batch_size: int, seed_cap: int,
                 drop_last: bool = False, base_seed: int = 0):
        self.train_set = np.asarray(train_set, dtype=np.int32)
        self.batch_size = batch_size
        self.seed_cap = seed_cap
        self.base_seed = base_seed
        n = len(self.train_set)
        self.num_step = (n // batch_size if drop_last
                         else _num_step(n, batch_size))
        self.drop_last = drop_last

    def epoch_permutation(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.base_seed * 1_000_003 + epoch)
        return rng.permutation(self.train_set)

    def _batch(self, perm: np.ndarray, step: int) -> Tuple[np.ndarray, int]:
        """Global step ``step`` of the epoch: -1-padded seeds and the real
        count (0 for a step past the end)."""
        lo = step * self.batch_size
        hi = min(lo + self.batch_size, len(perm))
        out = np.full(self.seed_cap, -1, dtype=np.int32)
        if lo >= len(perm):
            return out, 0
        out[: hi - lo] = perm[lo:hi]
        return out, hi - lo

    def batches(self, epoch: int) -> Iterator[Tuple[np.ndarray, int, int]]:
        """Yield (padded_seeds [seed_cap], num_real, step)."""
        seeds, nums = self.epoch_arrays(epoch)
        for step in range(self.num_step):
            yield seeds[step], int(nums[step]), step

    def epoch_arrays(self, epoch: int) -> Tuple[np.ndarray, np.ndarray]:
        """Whole epoch at once: (seeds [num_step, seed_cap] -1-padded, nums
        [num_step])."""
        perm = self.epoch_permutation(epoch)
        seeds = np.full((self.num_step, self.seed_cap), -1, dtype=np.int32)
        nums = np.zeros((self.num_step,), dtype=np.int32)
        for step in range(self.num_step):
            seeds[step], nums[step] = self._batch(perm, step)
        return seeds, nums


class DistShuffler(EpochShuffler):
    """Partition the (identically-shuffled) epoch across sampler workers by
    contiguous step ranges; the last worker takes the remainder
    (dist_shuffler.cc:59-79). Global step ids are kept for batch draws."""

    def __init__(self, train_set: np.ndarray, batch_size: int, seed_cap: int,
                 worker_id: int, num_worker: int, base_seed: int = 0):
        super().__init__(train_set, batch_size, seed_cap, base_seed=base_seed)
        if not 0 <= worker_id < num_worker:
            raise ValueError(f"worker {worker_id} of {num_worker}")
        per = self.num_step // num_worker
        self.step_begin = per * worker_id
        self.step_end = (self.num_step if worker_id == num_worker - 1
                         else per * (worker_id + 1))
        self.worker_id = worker_id
        self.num_worker = num_worker

    @property
    def num_local_step(self) -> int:
        return self.step_end - self.step_begin

    def batches(self, epoch: int) -> Iterator[Tuple[np.ndarray, int, int]]:
        perm = self.epoch_permutation(epoch)
        for step in range(self.step_begin, self.step_end):
            yield (*self._batch(perm, step), step)


class AlignedDistShuffler(EpochShuffler):
    """arch6's shuffler: every worker runs the same number of local steps
    (dist_shuffler_aligned.h:40-64). Local step ``l`` of worker ``w`` is
    global step ``l * num_worker + w``; a step past the epoch's end is
    padding, -1 seeds with a count of 0."""

    def __init__(self, train_set: np.ndarray, batch_size: int, seed_cap: int,
                 worker_id: int, num_worker: int, base_seed: int = 0):
        super().__init__(train_set, batch_size, seed_cap, base_seed=base_seed)
        self.worker_id = worker_id
        self.num_worker = num_worker
        self.num_local_step = _num_step(self.num_step, num_worker)
        self.aligned_num_step = self.num_local_step * num_worker

    def batches(self, epoch: int) -> Iterator[Tuple[np.ndarray, int, int]]:
        perm = self.epoch_permutation(epoch)
        for local in range(self.num_local_step):
            step = local * self.num_worker + self.worker_id
            yield (*self._batch(perm, step), step)
