"""Build/install fgnn_tpu.

The native extension (fgnn_tpu/native) is optional: a C++/OpenMP host
runtime for the hot host-side paths (parallel feature gather from mmap,
frequency counting). Built via `python setup.py build_native` or the
Makefile in fgnn_tpu/native; pure-NumPy fallbacks keep everything working
without it.

fgnn_tpu_torch is the PyTorch / CUDA port for NVIDIA Hopper. It ships the
CUDA sources of its kernels (fgnn_tpu_torch/csrc/*.cu), which it compiles
with nvcc at first use.
"""
from setuptools import find_packages, setup

setup(
    name="fgnn_tpu",
    version="0.1.0",
    description=(
        "TPU-native factored sample-based GNN training framework "
        "(GNNLab/FGNN capabilities, JAX/XLA/Pallas)"
    ),
    packages=find_packages(exclude=("tests",)),
    package_data={"fgnn_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy"],
    extras_require={"torch": ["torch"]},
)
