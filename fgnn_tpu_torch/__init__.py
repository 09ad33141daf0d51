"""fgnn_tpu_torch — the PyTorch / CUDA port of fgnn_tpu for NVIDIA Hopper.

Module names mirror ``fgnn_tpu`` so each piece has an obvious counterpart;
the JAX package stays the reference. Plain tensor code is PyTorch; the TPU's
Pallas kernels become hand-written Hopper kernels under ``csrc/``, built at
first use (``ops/cuda_lib.py``). The host-side modules (``config``,
``constants``, ``data``, ``utils``) are the port's own copies of the
reference's. This package imports neither jax, flax, optax nor fgnn_tpu.

Ported: one-device training (``engine.OneChipEngine``) of GraphSAGE, GCN,
GAT and PinSAGE, with the feature table on the device or in host memory
behind the static (presample, degree, random, ...) and dynamic feature
caches. Not yet: the KHOP1 and weighted samplers, arch0, the session API,
checkpoints, sanity checks and the multi-device engines (ROADMAP.md).
"""

__version__ = "0.1.0"
