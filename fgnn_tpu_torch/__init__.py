"""fgnn_tpu_torch — the PyTorch / CUDA port of fgnn_tpu for NVIDIA Hopper.

Module names mirror ``fgnn_tpu`` so each piece has an obvious counterpart;
the JAX package stays the reference. Plain tensor code is PyTorch; the TPU's
Pallas kernels become hand-written Hopper kernels under ``csrc/``, built at
first use (``ops/cuda_lib.py``). Host-side configuration and datasets come
from the JAX-free ``fgnn_tpu.config`` / ``.constants`` / ``.data`` /
``.utils``. This package never imports jax, flax or optax.
"""

__version__ = "0.1.0"
