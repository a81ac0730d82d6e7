"""Package hygiene of bn254_tpu_torch: no JAX, no bn254_tpu, lazy kernels,
and entry points that run on the CUDA card unless asked for the CPU."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

from bn254_tpu_torch import api
from bn254_tpu_torch.host import curve as HC
from bn254_tpu_torch.kernels import build

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "bn254_tpu_torch"

_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax\b|bn254_tpu(?![\w]))", re.MULTILINE)


def test_import_loads_no_jax_and_no_reference_package():
    """Import every module of the port in a fresh interpreter."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PKG.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'bn254_tpu' or m.startswith('bn254_tpu.')]\n"
        "print('BAD', bad)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout


def test_no_source_imports_jax_or_reference_package():
    files = list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(f) for f in files if _FORBIDDEN.search(f.read_text())]
    assert offenders == []
    assert _FORBIDDEN.search("from bn254_tpu.fields import limbs")
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert not _FORBIDDEN.search("from bn254_tpu_torch import api")


def test_entry_points_need_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sig = api.Signature(HC.G1_ONE)

    class Key:
        point = HC.G2_ONE

    with pytest.raises(RuntimeError, match="CUDA"):
        api.batch_verify([b"m"], [sig], [Key()])
    with pytest.raises(RuntimeError, match="CUDA"):
        api.batch_sign([b"m"], [5])
    assert api.resolve_device("cpu") == torch.device("cpu")


def test_failed_kernel_build_raises(monkeypatch, tmp_path):
    """A compiler that refuses the source raises; nothing is loaded."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc", lambda: "false")
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(build.KernelBuildError):
        build.library("montmul")
    assert list(tmp_path.iterdir()) == []
