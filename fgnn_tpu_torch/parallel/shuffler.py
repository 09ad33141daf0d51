"""Train-set shuffler (port of ``fgnn_tpu/parallel/shuffler.py``).

The epoch permutation is seeded by epoch number from NumPy, exactly as in
the reference, so both frameworks walk the same batches in the same order.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


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
                         else (n + batch_size - 1) // batch_size)
        self.drop_last = drop_last

    def epoch_permutation(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.base_seed * 1_000_003 + epoch)
        return rng.permutation(self.train_set)

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
            lo = step * self.batch_size
            hi = min(lo + self.batch_size, len(perm))
            seeds[step, : hi - lo] = perm[lo:hi]
            nums[step] = hi - lo
        return seeds, nums
