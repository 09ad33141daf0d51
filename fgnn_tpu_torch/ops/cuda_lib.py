"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``fgnn_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash of
the source and the flags, and loaded with ``ctypes``. A library with a plain
C interface builds in seconds, where one that includes PyTorch's headers
takes minutes, so every kernel of the package goes this way.
:func:`build` compiles several sources at once, one ``nvcc`` each.

Nothing here runs at import time: the CPU tests import every module of the
package on machines that have no ``nvcc``.

Each kernel wrapper adds one to ``launches[name]`` where it launches its
kernel, and nowhere else, so a run can show that its main path went through
the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# kernel name -> launches since the last reset_launches()
launches: Dict[str, int] = {}
# kernel name -> seconds the nvcc build took in this process (0.0 if the
# library was already built); sources built together by build() share the
# wall time of that build
build_seconds: Dict[str, float] = {}

_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def count_launch(name: str) -> None:
    launches[name] = launches.get(name, 0) + 1


def log_launches() -> None:
    """One ``test_result:launches:<kernel>=<n>`` line a kernel, its launches
    since the last :func:`reset_launches` (the apps' result format)."""
    for name, n in sorted(launches.items()):
        print(f"test_result:launches:{name}={n}", flush=True)


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under $CUDA_HOME/bin): the "
            "CUDA kernels of fgnn_tpu_torch are built from csrc/ at first use"
        )
    return path


def library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names: Sequence[str]) -> None:
    """Compile every missing library of ``names`` and load all of them. The
    ``nvcc`` processes run together; a failure raises after all have ended."""
    todo = [n for n in names if n not in _libs]
    t0 = time.perf_counter()
    jobs = []
    try:
        for name in todo:
            so = library_path(name)
            if os.path.exists(so):
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC_DIR, f"{name}.cu")]
            jobs.append((name, so, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, so, tmp, cmd, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):"
                              f"\n{' '.join(cmd)}\n{log}")
            else:
                os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, _, tmp, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    seconds = time.perf_counter() - t0
    for name in todo:
        build_seconds[name] = seconds
        _libs[name] = ctypes.CDLL(library_path(name))
        launches.setdefault(name, 0)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _libs:
        build([name])
    return _libs[name]
