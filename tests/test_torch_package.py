"""Import hygiene and packaging of the port: fiat_tpu_torch imports neither
JAX nor fiat_tpu, imports without building anything, and refuses to load
its kernels where there is no CUDA compiler."""

import ast
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
            "fiat_tpu_torch.ops.bernstein, fiat_tpu_torch.core.elimquad, "
            "fiat_tpu_torch.core.macro, "
            "fiat_tpu_torch.core.quadrature_schemes, fiat_tpu_torch.core.pointwise_dual, "
            "fiat_tpu_torch.core.orthopoly, fiat_tpu_torch.elements.tensor_product, "
            "fiat_tpu_torch.elements.hdivcurl, fiat_tpu_torch.elements.mixed, "
            "fiat_tpu_torch.elements.enriched, fiat_tpu_torch.elements.quadrature_element, "
            "fiat_tpu_torch.elements.discontinuous_pc, fiat_tpu_torch.elements.hdiv_trace, "
            "fiat_tpu_torch.elements.bernstein, fiat_tpu_torch.elements.serendipity, "
            "fiat_tpu_torch.elements.sympy_vector, fiat_tpu_torch.elements.bdm_cube, "
            "fiat_tpu_torch.elements.trimmed_serendipity, fiat_tpu_torch.parallel, "
            "fiat_tpu_torch.parallel.sharding, fiat_tpu_torch.symbolic, fiat_tpu_torch.ufl, "
            "fiat_tpu_torch.factory, fiat_tpu_torch.ir, "
            "fiat_tpu_torch.symbolic.element_factory\n"

            "from fiat_tpu_torch.core.quadrature_schemes import create_quadrature\n"
            "create_quadrature(fiat_tpu_torch.ufc_simplex(2), 6)\n"
            "create_quadrature(fiat_tpu_torch.ufc_simplex(3), 9)\n"
            "create_quadrature(fiat_tpu_torch.UFCHexahedron(), 5)\n"
            "ft, I = fiat_tpu_torch, fiat_tpu_torch.ufc_simplex(1)\n"
            "q2 = ft.FlattenedDimensions(ft.TensorProductElement(ft.Lagrange(I, 2), "
            "ft.Lagrange(I, 2)))\n"
            "q2.tabulate(1, [[0.2, 0.3]])\n"
            "ft.create_element(ft.ufl.FiniteElement('RTCF', 'quadrilateral', 2))\n"
            "ft.TrimmedSerendipityEdge(ft.UFCHexahedron(), 2).tabulate(1, [[0.2, 0.3, 0.4]])\n"
            "from fiat_tpu_torch.core import elimquad\n"
            "elimquad.rule_size(8, 2), elimquad.rule_size(8, 3)\n"
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
    assert PKG / "parallel" / "sharding.py" in files
    for path in files:
        text = path.read_text()
        assert not pattern.search(text), path
        assert "import jax" not in text, path


def _code_strings(path):
    """The string constants of a module's code: docstrings, which name the
    fiat_tpu counterpart of a module, left out."""
    tree = ast.parse(path.read_text())
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


def test_sources_name_no_path_of_the_jax_package():
    """The port opens nothing of fiat_tpu by file path either: no string in
    its code (nor in chip_smoke.py) names a path under fiat_tpu/ or the
    package's directory, apart from file:line references to the TPU
    kernels ported (chip_smoke.py's "replaces")."""
    reference = re.compile(r"fiat_tpu/[\w/]+\.py:\d+")
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        for text in _code_strings(path):
            rest = reference.sub("", text)
            assert "fiat_tpu/" not in rest and rest.strip() != "fiat_tpu", (path, text)


def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    """device=None means the CUDA card; without one the entry points raise,
    naming device="cpu", and never carry on on the CPU."""
    import numpy as np
    import torch
    import fiat_tpu_torch as ft
    import fiat_tpu_torch.ir      # the root does not import ir, as fiat_tpu's does not
    from fiat_tpu_torch.ops import moments
    from fiat_tpu_torch.ops.f32_zoo import F32ZooTabulator
    from fiat_tpu_torch.ops.fused_zoo import FusedZooTabulator
    from fiat_tpu_torch.ops.tabulate import BatchedTabulator, ElementTabulator
    from fiat_tpu_torch.symbolic import UnknownPointSet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    zoo = [ft.Lagrange(ft.ufc_simplex(2), 2)]
    bt = BatchedTabulator(zoo, order=1, device="cpu")
    calls = [lambda: ft.device_tabulator(zoo, order=1),
             lambda: ft.device_tabulator(zoo, order=1, f64=False),
             lambda: BatchedTabulator(zoo, order=1),
             lambda: FusedZooTabulator(bt),
             lambda: FusedZooTabulator.from_arrays(**bt.state()),
             lambda: F32ZooTabulator(bt),
             lambda: moments.MomentEngine(bt),
             lambda: moments.MomentEngine.from_arrays(**bt.state()),
             lambda: ElementTabulator(zoo[0], order=1),
             lambda: UnknownPointSet(np.zeros((3, 2))),
             lambda: UnknownPointSet(torch.zeros((3, 2))),
             lambda: ft.ir.evaluate(torch.sin, np.zeros(3)),
             lambda: ft.ir.contract("ij,jk,kl->il", *[np.eye(3)] * 3),
             lambda: ft.ir.contract("ij,jk->ik", np.eye(3), np.eye(3))]
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    tab = ft.device_tabulator(zoo, order=1, device="cpu")
    pts = np.random.default_rng(2).random((9, 2)) / 2
    assert tab.block_tables(pts)[(0, 0)][0].device.type == "cpu"
    assert ElementTabulator(zoo[0], order=1, device="cpu")(pts)[(0, 1)].device.type == "cpu"
    assert UnknownPointSet(pts, device="cpu").points.device.type == "cpu"
    assert ft.ir.contract("ij,jk->ik", np.eye(3), np.eye(3), device="cpu").device.type == "cpu"
    # the moments functions build their engine on the tabulator's device
    assert moments.moment_rows(bt, pts, np.ones(9)).device.type == "cpu"


def test_symbolic_exports_every_public_name_of_fiat_tpus():
    """fiat_tpu_torch.symbolic exports every public name of fiat_tpu.symbolic
    (the zany families, MappedTabulation, PhysicalGeometry,
    DirectSerendipity and evaluate_sympy among them), each module of
    fiat_tpu's symbolic/ having its counterpart."""
    import fiat_tpu.symbolic as jsym
    import fiat_tpu_torch.symbolic as tsym

    def public(module):
        return {n for n in dir(module) if not n.startswith("_")}

    assert public(jsym) <= public(tsym), sorted(public(jsym) - public(tsym))
    ported = {p.stem for p in (PKG / "symbolic").glob("*.py")}
    jax_side = {p.stem for p in (REPO / "fiat_tpu" / "symbolic").glob("*.py")}
    assert jax_side - ported == set(), sorted(jax_side - ported)


def test_root_elements_and_ir_export_every_public_name_of_fiat_tpus():
    """The port's root and its elements package export every public name of
    fiat_tpu's (the registry, the factory's entry points, symbolic and
    ufl among them); ir exports fiat_tpu.ir's __all__ with as_jaxpr
    renamed as_graph (the graph is torch.fx's, not a jaxpr)."""
    import fiat_tpu
    import fiat_tpu.elements as jel
    import fiat_tpu.ir as jir
    import fiat_tpu_torch
    import fiat_tpu_torch.elements as tel
    import fiat_tpu_torch.ir as tir

    def public(module):
        return {n for n in dir(module) if not n.startswith("_")}

    for jax_side, ported in ((fiat_tpu, fiat_tpu_torch), (jel, tel)):
        assert public(jax_side) <= public(ported), sorted(public(jax_side) - public(ported))
    assert list(tel.supported_elements) == list(jel.supported_elements)
    assert {k: v.__name__ for k, v in tel.supported_elements.items()} == {
        k: v.__name__ for k, v in jel.supported_elements.items()}
    assert list(tel.extra_elements) == list(jel.extra_elements)
    assert fiat_tpu_torch.supported_elements is tel.supported_elements
    renamed = {"as_jaxpr": "as_graph"}
    assert set(tir.__all__) == {renamed.get(n, n) for n in jir.__all__}
    assert all(callable(getattr(tir, n)) for n in tir.__all__)
    assert public(jir) - {"jax", "jnp", "np"} - set(renamed) <= public(tir)


#: fiat_tpu modules left out of the port on purpose: the Pallas kernels
#: (ported as CUDA sources under csrc/), the TPU's float-pair and multiword
#: arithmetic, and the TPU runtime's probes
LEFT_OUT = {"ops/pallas_bernstein.py", "ops/pallas_multiword.py", "ops/pallas_recurrence.py",
            "ops/pallas_tabulate.py", "ops/doublefloat.py", "ops/multiword.py",
            "utils/runtime.py"}


def test_every_module_of_fiat_tpu_has_its_counterpart():
    jax_side = {str(p.relative_to(REPO / "fiat_tpu")) for p in (REPO / "fiat_tpu").rglob("*.py")}
    ported = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    assert jax_side - ported == LEFT_OUT, sorted(jax_side - ported)


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
    for sub in ("", ".core", ".elements", ".ir", ".ops", ".parallel", ".symbolic", ".ufl",
                ".utils"):
        assert "fiat_tpu_torch" + sub in packages
    data = cfg["tool"]["setuptools"]["package-data"]["fiat_tpu_torch"]
    assert "csrc/*.cu" in data and "csrc/*.cuh" in data
    assert sorted(p.name for p in (PKG / "csrc").glob("*.cu*")) == [
        "bernstein.cu", "binning.cuh", "bucket_matmul.cu", "bulk_copy.cuh", "dubiner1.cuh",
        "dubiner2.cuh", "dubiner3.cuh", "macro_oneshot.cu", "macro_oneshot.cuh",
        "macro_oneshot_1.cu", "macro_oneshot_f32.cu", "macro_oneshot_one.cu", "masked_matmul.cu",
        "moments.cu", "moments.cuh", "moments1.cu", "moments3.cu", "recurrence.cu",
        "recurrence.cuh", "recurrence_groups.cu", "recurrence_pair_groups.cu",
        "recurrence_pairs.cu", "zoo_f32.cu", "zoo_f32.cuh", "zoo_f32_1.cu", "zoo_f32_3.cu",
        "zoo_f32_3_64.cu", "zoo_f32_64.cu", "zoo_f32_wide.cu"]
    markers = cfg["tool"]["pytest"]["ini_options"]["markers"]
    assert any(m.startswith("cuda:") for m in markers)
