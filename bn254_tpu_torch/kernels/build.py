"""Build and load the package's CUDA kernels.

Each kernel is one `<name>.cu` file beside this module with a plain C
interface. At first use `nvcc` compiles it for Hopper (`sm_90a`) into a
shared library under `_build/`, named by a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is reused; the
library is loaded with `ctypes`. Nothing is built when the package is
imported, so `import bn254_tpu_torch` works on a machine without CUDA.

A failed build raises `KernelBuildError`: there is no fallback to the
plain torch version for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR / "_build"
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# the compiler's report (ptxas registers, spills) of each build this
# process ran
build_log: dict[str, str] = {}


def nvcc() -> str:
    """Path of the nvcc this package builds with."""
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME)")


def _compile(src: Path, out: Path) -> str:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed on {src.name} (rc={r.returncode}):\n"
                f"{r.stdout}\n{r.stderr}"
            )
        os.replace(tmp, out)  # atomic: concurrent builders agree
        return r.stdout + r.stderr
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel `name`, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        src = SRC_DIR / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        out = BUILD_DIR / f"{name}-{digest}.so"
        if not out.exists():
            build_log[name] = _compile(src, out)
        lib = ctypes.CDLL(str(out))
        _loaded[name] = lib
        return lib
