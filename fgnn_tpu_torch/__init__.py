"""fgnn_tpu_torch — the PyTorch / CUDA port of fgnn_tpu for NVIDIA Hopper.

Module names mirror ``fgnn_tpu`` so each piece has an obvious counterpart;
the JAX package stays the reference. Plain tensor code is PyTorch; the TPU's
Pallas kernels become hand-written Hopper kernels under ``csrc/``, built at
first use (``ops/cuda_lib.py``). The host-side modules (``config``,
``constants``, ``data``, ``utils``) are the port's own copies of the
reference's. This package imports neither jax, flax, optax nor fgnn_tpu.

Ported: one-device training (``engine.OneChipEngine``) of GraphSAGE, GCN,
GAT and PinSAGE with every sampler, the feature table on the device or in
host memory behind the static and dynamic feature caches; arch0
(``host_engine``); the profiler, sanity checks, checkpoints and the session
API; the multi-device engines (``parallel``), in one process or a process
per role; the apps, the experiment runners and the papers100M- and
uk-union-scale tools. ROADMAP.md lists what is left out on purpose.
"""

__version__ = "0.1.0"

from .config import CachePolicy, RunArch, RunConfig, SampleType
from .data import Dataset, load_dataset, make_synthetic_dataset, write_dataset

__all__ = [
    "CachePolicy",
    "Dataset",
    "RunArch",
    "RunConfig",
    "SampleType",
    "load_dataset",
    "make_synthetic_dataset",
    "write_dataset",
]
