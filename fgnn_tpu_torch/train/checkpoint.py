"""Checkpoint / resume (port of ``fgnn_tpu/train/checkpoint.py``).

The source system has no checkpoints; the reference saves (TrainState,
epoch) with orbax. The port writes one ``torch.save`` file per epoch into
one directory, to a temporary file first and then ``os.replace``, so a file
under its final name is always whole, and keeps the newest ``max_to_keep``.
The engine decides what the payload holds (``OneChipEngine._ckpt_state``);
it is loaded with ``weights_only=True``.
"""
from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import torch

from ..utils import get_logger

log = get_logger(__name__)

_NAME = re.compile(r"^epoch_(\d+)\.pt$")


class CheckpointManager:
    """One directory of ``epoch_<n>.pt`` files, the newest ``max_to_keep``
    kept."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    @property
    def available(self) -> bool:
        """Always true: ``torch.save`` needs nothing else (the reference's
        is false without orbax)."""
        return True

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch:08d}.pt")

    def epochs(self) -> List[int]:
        """The epochs saved, ascending."""
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                    os.listdir(self.directory))
                      if m)

    def save(self, epoch: int, state: dict) -> None:
        path = self._path(epoch)
        tmp = path + ".tmp"
        torch.save({"epoch": epoch, **state}, tmp)
        os.replace(tmp, path)
        for old in self.epochs()[:-self.max_to_keep]:
            os.remove(self._path(old))
        log.info("checkpoint: saved epoch %d -> %s", epoch, self.directory)

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def restore(self) -> Optional[Tuple[dict, int]]:
        """``(state, epoch)`` of the latest checkpoint, on the CPU, or None
        if there is none."""
        epoch = self.latest_epoch()
        if epoch is None:
            return None
        state = torch.load(self._path(epoch), map_location="cpu",
                           weights_only=True)
        log.info("checkpoint: restored epoch %d from %s", epoch,
                 self.directory)
        return state, epoch
