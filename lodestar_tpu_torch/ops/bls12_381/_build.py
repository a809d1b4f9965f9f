"""Build and load the hand-written CUDA kernels (``csrc/fp_kernels.cu``).

``nvcc`` compiles the source for ``sm_90a`` into a shared library with a
plain C interface, which ``ctypes`` loads.  The library's file name carries
a hash of the source, so the build runs at first use and again whenever the
source changes.  The output goes to ``lodestar_tpu_torch/_build/``, which
git ignores.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "fp_kernels.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# (launcher name, number of pointer arguments)
_LAUNCHERS = (
    ("lodestar_fp_mont_mul", 3),
    ("lodestar_fp_f2_mul", 6),
    ("lodestar_fp_f2_sqr", 4),
    ("lodestar_fp_add_mod", 3),
    ("lodestar_fp_sub_mod", 3),
)

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of lodestar_tpu_torch need the "
        "CUDA toolkit to build"
    )


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"fp_kernels_{digest}.so")


def build() -> Tuple[str, str]:
    """Compile the kernels unless the current source is already built.

    Returns the library's path and the compiler's messages (``-Xptxas -v``
    lists each kernel's registers and spills); the messages are empty when
    the library was already there."""
    path = library_path()
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)
    return path, proc.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(path)
        for name, n_ptr in _LAUNCHERS:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int64, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
