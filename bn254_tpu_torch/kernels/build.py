"""Build and load the package's CUDA kernels.

Each kernel library is one `<name>.cu` file beside this module with a
plain C interface; it may include headers beside it (`bn254_tower.cuh`).
At first use (or all at once, through `build`) `nvcc` compiles it for
Hopper (`sm_90a`) into a shared library under `_build/`, named by a hash
of the source, the headers it includes and the flags, so an edited source
or header is rebuilt and an unchanged one is reused; the library is loaded
with `ctypes`. Nothing is built when the package is imported, so
`import bn254_tpu_torch` works on a machine without CUDA.

A failed build raises `KernelBuildError`: there is no fallback to the
plain torch version for CUDA tensors. The native host core
(`host/native.py`) builds its C++ source with g++ through the same
`digest_path` and `compile_all`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
    """The compiler is missing or refused a source, or its library does
    not load."""


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


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def local_headers(src: Path) -> list[Path]:
    """The headers beside this module that `src` includes, directly or
    through another of them, in a fixed order (they go into the digest)."""
    seen: list[Path] = []
    todo = [src]
    while todo:
        for inc in _INCLUDE.findall(todo.pop().read_text()):
            h = SRC_DIR / inc
            if h.is_file() and h not in seen:
                seen.append(h)
                todo.append(h)
    return seen


def digest_path(src: Path, flags, deps=()) -> Path:
    """The library file of `src` compiled with `flags`, under BUILD_DIR,
    named by a digest of the source, the flags and the files of `deps`
    (the headers it includes)."""
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    for dep in deps:
        h.update(dep.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _output(name: str) -> Path:
    """The library file of kernel `name`."""
    src = SRC_DIR / f"{name}.cu"
    return digest_path(src, NVCC_FLAGS, local_headers(src))


def compile_all(jobs) -> dict[str, str]:
    """Run every job's compiler together. A job is (label, command, src,
    out): the compiler and its flags, `-o` a temporary file beside `out`,
    then the source; on success the file replaces `out` atomically, so
    concurrent builders agree. Returns each label's compiler output;
    raises KernelBuildError naming every source that failed."""
    running, errors, logs = [], [], {}
    try:
        for label, command, src, out in jobs:
            out.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
            os.close(fd)
            running.append((label, command, src, out, tmp, subprocess.Popen(
                [*command, "-o", tmp, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        for label, command, src, out, tmp, proc in running:
            stdout, stderr = proc.communicate()
            if proc.returncode == 0:
                os.replace(tmp, out)
                logs[label] = stdout + stderr
            else:
                errors.append(f"{os.path.basename(command[0])} failed on "
                              f"{src.name} (rc={proc.returncode}):\n"
                              f"{stdout}\n{stderr}")
    finally:
        for *_, tmp, proc in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    if errors:
        raise KernelBuildError("\n".join(errors))
    return logs


def build(names) -> None:
    """Compile each library of `names` that is not built yet: one nvcc per
    source, all started together. Raises KernelBuildError naming every
    source that failed."""
    todo = [(n, _output(n)) for n in dict.fromkeys(names)]
    todo = [(n, out) for n, out in todo if not out.exists()]
    if not todo:
        return
    command = [nvcc(), *NVCC_FLAGS]
    build_log.update(compile_all(
        [(n, command, SRC_DIR / f"{n}.cu", out) for n, out in todo]))


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel `name`, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = _loaded[name] = ctypes.CDLL(str(_output(name)))
        return lib
