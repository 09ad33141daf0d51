"""Run configuration (the port's copy of ``fgnn_tpu/config.py``).

A frozen dataclass passed explicitly, with enums that mirror the source
system's (common.h:38-92), so configurations translate one to one. Its
enums are the port's own: ``fgnn_tpu_torch.config.SampleType.KHOP2`` is not
``fgnn_tpu.config.SampleType.KHOP2``. :meth:`RunConfig.from_dict` takes
enum values, which is how a configuration crosses between the packages.
"""
from __future__ import annotations

import contextlib
import dataclasses
import enum
import os
from typing import Dict, Optional, Tuple

from . import constants


class SampleType(enum.Enum):
    """Mirror of SampleType (common.h:58-68)."""

    KHOP0 = "khop0"                  # reservoir: uniform w/o replacement
    KHOP1 = "khop1"                  # uniform with replacement
    KHOP2 = "khop2"                  # Fisher-Yates w/o replacement (default GCN)
    WEIGHTED_KHOP = "weighted_khop"  # alias-table weighted
    RANDOM_WALK = "random_walk"      # PinSAGE walks + top-k by visit count
    WEIGHTED_KHOP_PREFIX = "weighted_khop_prefix"
    WEIGHTED_KHOP_HASH_DEDUP = "weighted_khop_hash_dedup"

    @property
    def is_khop(self) -> bool:
        return self in (
            SampleType.KHOP0,
            SampleType.KHOP1,
            SampleType.KHOP2,
            SampleType.WEIGHTED_KHOP,
            SampleType.WEIGHTED_KHOP_PREFIX,
            SampleType.WEIGHTED_KHOP_HASH_DEDUP,
        )


class CachePolicy(enum.Enum):
    """Mirror of CachePolicy (common.h:70-80)."""

    DEGREE = "degree"
    HEURISTIC = "heuristic"
    PRESAMPLE = "pre_sample"
    DEGREE_HOP = "degree_hop"
    PRESAMPLE_STATIC = "presample_static"
    FAKE_OPTIMAL = "fake_optimal"
    DYNAMIC_CACHE = "dynamic_cache"
    RANDOM = "random"


class RunArch(enum.Enum):
    """Mirror of RunArch arch0-7 (common.h:47-56, __init__.py:97-132).

      ARCH0: host (CPU) sampling + device training, one process.
      ARCH1: sample + extract + train all on one device.
      ARCH2/3: sampler device + trainer device, host-mediated extraction.
      ARCH4: one device with the dynamic (previous-batch) feature cache.
      ARCH5: FGNN factored: dedicated sampler and trainer devices.
      ARCH6: SGNN: every device samples AND trains.
    """

    ARCH0 = 0
    ARCH1 = 1
    ARCH2 = 2
    ARCH3 = 3
    ARCH4 = 4
    ARCH5 = 5
    ARCH6 = 6
    ARCH7 = 7


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Frozen run configuration (run_config.h:24-99 analog)."""

    # dataset
    dataset: str = "products"
    dataset_root: str = constants.DEFAULT_DATASET_ROOT

    # architecture / roles
    arch: RunArch = RunArch.ARCH5
    num_sample_worker: int = 1
    num_train_worker: int = 1

    # sampling
    sample_type: SampleType = SampleType.KHOP2
    fanout: Tuple[int, ...] = (25, 10)   # deepest-first like the reference
    batch_size: int = 8000
    num_epoch: int = 10

    # random walk (PinSAGE) parameters (run_config.h:52-57)
    random_walk_length: int = 3
    random_walk_restart_prob: float = 0.5
    num_random_walk: int = 4
    num_neighbor: int = 5
    num_layer_rw: int = 3

    # cache
    cache_policy: CachePolicy = CachePolicy.PRESAMPLE
    cache_percentage: float = 0.0
    presample_epoch: int = 1

    # model / training
    model: str = "graphsage"
    num_hidden: int = 256
    lr: float = 0.003
    dropout: float = 0.5
    weight_decay: float = 0.0

    # pipeline
    pipeline: bool = True
    max_sampling_jobs: int = 10
    max_copying_jobs: int = 10

    # balance switcher (arch5 + switcher role)
    have_switcher: bool = False
    switch_cache_percentage: float = 0.0

    # async data-parallel training
    async_train: bool = False
    async_sync_every: int = 1

    # precision
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # checkpoint/resume
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0          # save every N epochs; 0 = off

    # misc / observability
    barriered_epoch: int = 0
    profile_level: int = 1
    sanity_check: bool = False
    empty_feat: int = 0          # log2 of fake feature-table size; 0 = off
    seed: int = 0

    @property
    def num_layer(self) -> int:
        if self.sample_type == SampleType.RANDOM_WALK:
            return self.num_layer_rw
        return len(self.fanout)

    @property
    def num_fanout(self) -> int:
        return len(self.fanout)

    @property
    def use_cache(self) -> bool:
        return self.cache_percentage > 0.0

    def validate(self) -> "RunConfig":
        """CHECK-style invariants (operation.cc:58-121 analog). Raises
        ``ValueError`` on the first that fails."""
        checks = [
            (self.batch_size > 0, "batch_size > 0"),
            (0.0 <= self.cache_percentage <= 1.0,
             "0 <= cache_percentage <= 1"),
            (self.num_epoch > 0, "num_epoch > 0"),
        ]
        if self.sample_type == SampleType.RANDOM_WALK:
            checks += [
                (self.num_random_walk > 0 and self.random_walk_length > 0,
                 "num_random_walk > 0 and random_walk_length > 0"),
                (self.num_neighbor > 0, "num_neighbor > 0"),
            ]
        else:
            checks.append((len(self.fanout) > 0
                           and all(f > 0 for f in self.fanout),
                           "a non-empty fanout of positive ints"))
        if self.arch in (RunArch.ARCH5, RunArch.ARCH6):
            checks.append((self.num_sample_worker >= 1
                           and self.num_train_worker >= 1,
                           "at least one sample and one train worker"))
        for ok, what in checks:
            if not ok:
                raise ValueError(f"invalid RunConfig: needs {what}")
        return self

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def from_dict(d: dict) -> "RunConfig":
        """Parse a loosely typed k/v config (samgraph_config analog,
        operation.cc:45-169). Enums may be given by value. Unknown keys
        raise."""
        kw = {}
        fields = {f.name: f for f in dataclasses.fields(RunConfig)}
        for k, v in d.items():
            if k not in fields:
                raise KeyError(f"unknown config key: {k}")
            if k == "arch":
                if isinstance(v, str) and v.lower().startswith("arch"):
                    v = v[4:]           # "arch5" -> 5 (builtin arch table names)
                v = RunArch(int(v)) if not isinstance(v, RunArch) else v
            elif k == "sample_type":
                v = SampleType(v) if not isinstance(v, SampleType) else v
            elif k == "cache_policy":
                v = CachePolicy(v) if not isinstance(v, CachePolicy) else v
            elif k == "fanout" and not isinstance(v, tuple):
                v = tuple(int(x) for x in v)
            kw[k] = v
        return RunConfig(**kw).validate()


def env_flag(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v not in ("", "0", "false", "False", "off")


def env_int(name: str, default: int = 0) -> int:
    v = os.environ.get(name)
    return default if v is None else int(v)


@contextlib.contextmanager
def env_set(values: Dict[str, str]):
    """``values`` set in ``os.environ`` for the block, the previous values
    (or their absence) back after it."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
