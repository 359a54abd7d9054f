"""Import hygiene and packaging of the port: fiat_tpu_torch imports neither
JAX nor fiat_tpu, imports without building anything, and refuses to load
its kernels where there is no CUDA compiler."""

import re
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "fiat_tpu_torch"


def test_import_leaves_jax_and_fiat_tpu_out():
    code = ("import sys, fiat_tpu_torch, fiat_tpu_torch.ops.fused_zoo, "
            "fiat_tpu_torch.ops.tabulate, fiat_tpu_torch.ops.recurrence, "
            "fiat_tpu_torch.ops.macro_oneshot, fiat_tpu_torch.ops.moments, "
            "fiat_tpu_torch.ops.moment_kernel, fiat_tpu_torch.ops.f32_zoo, "
            "fiat_tpu_torch.core.macro, "
            "fiat_tpu_torch.core.quadrature_schemes\n"
            "from fiat_tpu_torch.core.quadrature_schemes import create_quadrature\n"
            "create_quadrature(fiat_tpu_torch.ufc_simplex(2), 6)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'fiat_tpu' or m.startswith('fiat_tpu.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sources_import_no_jax_or_fiat_tpu():
    pattern = re.compile(r"^\s*(from|import)\s+(jax|fiat_tpu)(\.|\s|$)", re.M)
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 15
    for path in files:
        text = path.read_text()
        assert not pattern.search(text), path
        assert "import jax" not in text, path


def test_load_kernels_raises_without_nvcc(monkeypatch):
    from fiat_tpu_torch.ops import kernels
    monkeypatch.setattr(kernels, "find_nvcc", lambda: None)
    kernels.load_kernels.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            kernels.load_kernels()
    finally:
        kernels.load_kernels.cache_clear()


def test_pyproject_ships_the_port():
    cfg = tomllib.loads((REPO / "pyproject.toml").read_text())
    packages = cfg["tool"]["setuptools"]["packages"]
    for sub in ("", ".core", ".elements", ".ops", ".utils"):
        assert "fiat_tpu_torch" + sub in packages
    data = cfg["tool"]["setuptools"]["package-data"]["fiat_tpu_torch"]
    assert "csrc/*.cu" in data and "csrc/*.cuh" in data
    assert sorted(p.name for p in (PKG / "csrc").glob("*.cu*")) == [
        "binning.cuh", "bucket_matmul.cu", "dubiner2.cuh", "macro_oneshot.cu", "moments.cu",
        "recurrence.cu", "zoo_f32.cu"]
    markers = cfg["tool"]["pytest"]["ini_options"]["markers"]
    assert any(m.startswith("cuda:") for m in markers)
