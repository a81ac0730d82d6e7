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
    assert {"bn254_tpu_torch.dist.mesh", "bn254_tpu_torch.dist.collectives",
            "bn254_tpu_torch.dist.batch_verify"} <= set(mods)
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


def test_native_host_core_imports_neither_torch_nor_jax():
    """The host core's binding (and what it imports: the package's host
    objects, kernels/build.py) loads no torch and no jax."""
    code = ("import sys\n"
            "import bn254_tpu_torch.host.native\n"
            "print(sorted(m for m in ('torch', 'jax', 'bn254_tpu') "
            "if m in sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines()[-1] == "[]"


def test_no_source_imports_jax_or_reference_package():
    files = list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py",
                                       REPO / "examples/batch_verify_gpu.py"]
    assert PKG / "__main__.py" in files
    assert {PKG / "dist" / "mesh.py", PKG / "dist" / "collectives.py",
            PKG / "host" / "native.py"} <= set(files)
    offenders = [str(f) for f in files if _FORBIDDEN.search(f.read_text())]
    assert offenders == []
    assert _FORBIDDEN.search("from bn254_tpu.fields import limbs")
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert not _FORBIDDEN.search("from bn254_tpu_torch import api")


def test_exports_match_the_jax_package():
    import bn254_tpu

    import bn254_tpu_torch

    assert set(bn254_tpu_torch.__all__) == set(bn254_tpu.__all__)
    for name in bn254_tpu_torch.__all__:
        assert getattr(bn254_tpu_torch, name) is not None
    assert bn254_tpu_torch.__version__ == bn254_tpu.__version__
    assert api.Signature is bn254_tpu_torch.Signature


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


def fake_nvcc(tmp_path, fail_on=""):
    """A compiler script that writes an empty library to its -o argument,
    logs each source it is given, and refuses `fail_on`."""
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        "for a; do case $a in *.cu) src=$a;; esac; done\n"
        f'echo "$src" >> {tmp_path / "nvcc.log"}\n'
        + (f'case $src in *"{fail_on}") exit 1;; esac\n' if fail_on else "")
        + 'while [ $# -gt 0 ]; do [ "$1" = -o ] && : > "$2"; shift; done\n')
    script.chmod(0o755)
    return lambda: str(script)


def test_edited_header_rebuilds_the_library(monkeypatch, tmp_path):
    """The library digest covers the headers a source includes: an edit of
    bn254_tower.cuh alone builds fused.cu anew instead of loading it stale."""
    src_dir = tmp_path / "src"
    src_dir.mkdir()
    for f in ("fused.cu", "bn254_tower.cuh"):
        (src_dir / f).write_bytes((build.SRC_DIR / f).read_bytes())
    monkeypatch.setattr(build, "SRC_DIR", src_dir)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "nvcc", fake_nvcc(tmp_path))
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    assert build.local_headers(src_dir / "fused.cu") == [
        src_dir / "bn254_tower.cuh"]
    first = build.library("fused")
    build._loaded.clear()
    assert build.library("fused") == first  # unchanged: reused, not rebuilt
    with open(src_dir / "bn254_tower.cuh", "a") as fh:
        fh.write("// edited\n")
    build._loaded.clear()
    assert build.library("fused") != first
    assert len((tmp_path / "nvcc.log").read_text().split()) == 2


def test_build_starts_every_source_and_names_each_failure(monkeypatch,
                                                          tmp_path):
    """`build` runs one compiler per source; a refused source raises with
    its name, the other is built, and no temporary file is left."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "nvcc", fake_nvcc(tmp_path, "fused.cu"))
    with pytest.raises(build.KernelBuildError, match="fused.cu") as err:
        build.build(["montmul", "fused", "montmul"])
    assert "montmul" not in str(err.value)
    assert len((tmp_path / "nvcc.log").read_text().split()) == 2
    assert [f.name for f in (tmp_path / "out").iterdir()] == [
        build._output("montmul").name]


def test_failed_kernel_build_raises(monkeypatch, tmp_path):
    """A compiler that refuses the source raises; nothing is loaded."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc", lambda: "false")
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(build.KernelBuildError):
        build.library("montmul")
    assert list(tmp_path.iterdir()) == []
