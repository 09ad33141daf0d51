"""Role assignment of devices (port of ``fgnn_tpu/parallel/mesh.py``).

The source system dedicates whole GPUs to sampling or training, one
process each (DistEngine::SampleInit/TrainInit, dist_engine.cc:231-465).
The reference splits a TPU slice into a sampler submesh and a trainer
submesh. The port keeps one process that drives every role device: a role
is a plain list of ``torch.device``, indexed by logical worker, with no mesh
object and no sharding. The first ``S`` devices sample and the next ``T``
train, the reference's numbering. A device may appear more than once: on
``[cuda:0, cuda:0]`` one card holds both roles, as the reference's golden
gate runs them on one chip.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Union

import torch

from ..config import RunArch, RunConfig

Device = Union[str, torch.device]


@dataclasses.dataclass
class RoleMesh:
    sampler_devices: List[torch.device]
    trainer_devices: List[torch.device]

    @property
    def num_sampler(self) -> int:
        return len(self.sampler_devices)

    @property
    def num_trainer(self) -> int:
        return len(self.trainer_devices)


def _take(n: int, devices: Sequence[Device], what: str) -> List[torch.device]:
    devices = [torch.device(d) for d in devices]
    if n > len(devices):
        raise ValueError(f"{what} needs {n} devices and {len(devices)} were "
                         f"given: {[str(d) for d in devices]}")
    return devices[:n]


def make_role_mesh(num_sampler: int, num_trainer: int,
                   devices: Sequence[Device]) -> RoleMesh:
    """The first ``num_sampler`` devices sample, the next ``num_trainer``
    train (the reference's device numbering convention). Raises
    ``ValueError`` with fewer than ``num_sampler + num_trainer`` devices."""
    if num_sampler < 1 or num_trainer < 1:
        raise ValueError(f"{num_sampler} samplers and {num_trainer} trainers: "
                         "each role needs at least one device")
    devs = _take(num_sampler + num_trainer, devices,
                 f"{num_sampler} samplers + {num_trainer} trainers")
    return RoleMesh(devs[:num_sampler], devs[num_sampler:])


def make_data_mesh(num_worker: int,
                   devices: Sequence[Device]) -> List[torch.device]:
    """arch6's single role: every device samples AND trains."""
    if num_worker < 1:
        raise ValueError(f"{num_worker} workers")
    return _take(num_worker, devices, f"{num_worker} workers")


def default_devices(device: Device, n: int) -> List[torch.device]:
    """``n`` role devices from one device name: the first ``n`` cards for
    ``cuda``, the CPU ``n`` times for ``cpu``. Raises ``ValueError`` when
    the machine has fewer than ``n`` cards; it never hands out fewer."""
    device = torch.device(device)
    if device.type == "cpu":
        return [device] * n
    count = torch.cuda.device_count() if device.type == "cuda" else 0
    if device.type != "cuda" or count < n:
        raise ValueError(
            f"{n} role devices were asked of {device} and the machine has "
            f"{count} CUDA devices; name them (for example "
            f"{','.join(['cuda:0'] * n)} to put every role on one card)")
    return [torch.device("cuda", i) for i in range(n)]


def role_devices(cfg: RunConfig,
                 ctx: Union[Device, Sequence[Device]]) -> List[torch.device]:
    """arch5's S + T (arch6's W) role devices: the first of a list, which
    must hold that many, or :func:`default_devices` of one device name."""
    n = (cfg.num_sample_worker + cfg.num_train_worker
         if cfg.arch == RunArch.ARCH5 else cfg.num_train_worker)
    if isinstance(ctx, (list, tuple)):
        return _take(n, ctx, cfg.arch.name.lower())
    return default_devices(ctx, n)
