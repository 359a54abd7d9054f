"""The port's physically mapped ("zany") elements -- ``fiat_tpu_torch.symbolic``'s
``physically_mapped``, ``zany`` and the thirteen family modules -- against
``fiat_tpu.symbolic`` on the CPU, on tests/test_zany_mapping.py's 37 cases
(``chip_smoke.ZANY_SCALAR`` / ``ZANY_PIOLA``, held equal to that file's
lists) and its distorted cells:

* M from numpy geometry (the test's ``MyMapping``, one object fed to both
  packages) equal to fiat_tpu's bit for bit; M from CPU tensor geometry
  (the same callbacks' arrays as tensors) a float64 tensor within 1e-14 of
  max(1, max |M|) of it, and so is M from ``chip_smoke.SimplexGeometry``
  (the geometry phase 27 builds on the card from the cell's vertices) on
  numpy and tensor vertices;
* on the meta device M, the mapped tables and the dual transformation
  stay on the geometry's device: nothing converts a tensor to numpy;
* ``basis_evaluation(1, UnknownPointSet(cpu tensor))`` with tensor
  geometry against fiat_tpu's numpy-point mapped tables, 1e-12 of
  max(1, max |table|) per alpha;
* the port's own physical check (``chip_smoke.zany_physical_check``, the
  counterpart of ``check_zany_mapping``) at its 1e-9;
* float32 tables mapped by M from numpy or tensor geometry come out
  float64 and equal to fiat_tpu's (x64 promotion), 1e-14;
* ``dual_transformation`` against fiat_tpu's, bit for bit on numpy
  geometry and 1e-12 on tensor geometry;
* ``torch.func.vmap`` of ``basis_transformation`` over 4 cells against the
  4 per-cell Ms, 1e-14;
* test_zany_mapping.py's 15 mass-scaling cases on the port (tensor
  geometry), its own bar."""

import sys
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from fiat_tpu_torch import symbolic as tsym
from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.core.quadrature_schemes import create_quadrature as t_create_quadrature
from fiat_tpu_torch.symbolic import point_set as tps
from fiat_tpu_torch.symbolic.physically_mapped import MappedTabulation as TMappedTabulation
from fiat_tpu_torch.symbolic.physically_mapped import to_dense as t_to_dense

import jax.numpy as jnp
from fiat_tpu import symbolic as jsym
from fiat_tpu.symbolic import point_set as jps
from fiat_tpu.symbolic.physically_mapped import MappedTabulation as JMappedTabulation
from fiat_tpu.symbolic.physically_mapped import to_dense as j_to_dense

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))
import chip_smoke  # noqa: E402
import test_zany_mapping as tzm  # noqa: E402

CASES = chip_smoke.ZANY_SCALAR + chip_smoke.ZANY_PIOLA
IDS = [f"{n}-{d}-{a}-{k}" for n, d, a, k in CASES]
#: M from tensor geometry vs numpy geometry, of max(1, max |M|)
RTOL_M = 1e-14
#: the tensor path's mapped tables vs fiat_tpu's host tables, of max(1, max |table|)
RTOL_TABLES = 1e-12
#: dual_transformation on tensor geometry vs fiat_tpu's, of max(1, max |value|)
RTOL_DUAL = 1e-12


def _parametrized(fn):
    """The cases of a parametrised test of tests/test_zany_mapping.py."""
    mark, = [m for m in fn.pytestmark if m.name == "parametrize"]
    return [tuple(c) for c in mark.args[1]]


class TensorGeometry:
    """A numpy geometry's callbacks, each array a float64 tensor on
    ``device``."""

    def __init__(self, geometry, device="cpu"):
        self.geometry, self.device = geometry, device

    def __getattr__(self, name):
        fn = getattr(self.geometry, name)

        def call(*args, **kwargs):
            return torch.as_tensor(np.asarray(fn(*args, **kwargs), dtype=np.float64),
                                   device=self.device)
        return call


@lru_cache(maxsize=None)
def _case(i):
    """(port element, fiat_tpu element, the test's numpy geometry, port
    reference cell) of case i."""
    name, dim, args, kwargs = CASES[i]
    ref_cell, phys_cell = tzm._distorted_cells(dim)
    t_cell = tcl.ufc_simplex(dim)
    return (getattr(tsym, name)(t_cell, *args, **kwargs),
            getattr(jsym, name)(ref_cell, *args, **kwargs),
            tzm.MyMapping(ref_cell, phys_cell), t_cell)


def _rel(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def _verts(dim):
    return np.asarray(chip_smoke.distorted_vertices(dim), dtype=np.float64)


def test_cases_are_test_zany_mappings():
    assert list(chip_smoke.ZANY_SCALAR) == _parametrized(tzm.test_zany_scalar)
    assert list(chip_smoke.ZANY_PIOLA) == _parametrized(tzm.test_zany_piola)
    for dim in (2, 3):
        assert np.array_equal(_verts(dim), np.asarray(tzm._distorted_cells(dim)[1].vertices))


@pytest.mark.parametrize("dim", [2, 3])
def test_simplex_geometry_is_my_mapping(dim):
    """chip_smoke.SimplexGeometry on numpy and tensor vertices reads what
    MyMapping reads off the cell with moved vertices."""
    ref_cell, phys_cell = tzm._distorted_cells(dim)
    mine = tzm.MyMapping(ref_cell, phys_cell)
    t_cell = tcl.ufc_simplex(dim)
    pts = tps.PointSet(np.random.default_rng(dim).random((5, dim)) / 3)
    for verts in (_verts(dim), torch.as_tensor(_verts(dim))):
        geom = chip_smoke.SimplexGeometry(t_cell, verts)
        for name, args in [("jacobian_at", (None,)), ("detJ_at", (None,)), ("cell_size", ()),
                           ("reference_normals", ()), ("physical_normals", ()),
                           ("physical_tangents", ()), ("physical_edge_lengths", ()),
                           ("physical_vertices", ()), ("normalized_reference_edge_tangents", ()),
                           ("physical_points", (pts,))]:
            got, want = getattr(geom, name)(*args), getattr(mine, name)(*args)
            assert torch.is_tensor(got) == torch.is_tensor(verts), name
            assert np.shape(got) == np.shape(want), name
            assert _rel(got, want) <= 1e-15, name


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_transformation_matches_fiat_tpu(i):
    tel, jel, mapping, t_cell = _case(i)
    want = j_to_dense(jel.basis_transformation(mapping))
    got = t_to_dense(tel.basis_transformation(mapping))
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert np.array_equal(got, want)
    dim = t_cell.get_spatial_dimension()
    for geom, tensor in ((TensorGeometry(mapping), True),
                         (chip_smoke.SimplexGeometry(t_cell, torch.as_tensor(_verts(dim))), True),
                         (chip_smoke.SimplexGeometry(t_cell, _verts(dim)), False)):
        M = t_to_dense(tel.basis_transformation(geom))
        assert torch.is_tensor(M) == tensor
        if tensor:
            assert M.dtype == torch.float64 and M.device.type == "cpu"
        assert tuple(M.shape) == want.shape
        assert _rel(M, want) <= RTOL_M


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_geometry_stays_on_its_device(i):
    """Geometry on the meta device (no data, and numpy cannot take it): M,
    the mapped tables at numpy points and the dual transformation come
    back as meta tensors of the right shapes."""
    tel, _, _, t_cell = _case(i)
    dim = t_cell.get_spatial_dimension()
    geom = chip_smoke.SimplexGeometry(t_cell, torch.as_tensor(_verts(dim), device="meta"))
    ndof, nrows = tel.space_dimension(), tel._element.space_dimension()
    M = t_to_dense(tel.basis_transformation(geom))
    assert M.device.type == "meta" and tuple(M.shape) == (ndof, nrows)
    pts = np.random.default_rng(i).random((4, dim)) / 4
    tables = tel.basis_evaluation(1, tps.PointSet(pts), coordinate_mapping=geom)
    for alpha in tables:
        assert tables[alpha].device.type == "meta"
        assert tuple(tables[alpha].shape) == (ndof,) + tuple(tel.value_shape) + (4,)
    dual = tel.dual_transformation(np.ones((ndof, 3)), coordinate_mapping=geom)
    assert dual.device.type == "meta" and tuple(dual.shape) == (ndof, 3)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_tensor_tables_match_fiat_tpu(i):
    tel, jel, mapping, t_cell = _case(i)
    dim = t_cell.get_spatial_dimension()
    pts = np.random.default_rng(100 + i).random((24, dim)) / (dim + 0.5)
    want = jel.basis_evaluation(1, jps.PointSet(pts), coordinate_mapping=mapping)
    got = tel.basis_evaluation(1, tps.UnknownPointSet(pts, device="cpu"),
                               coordinate_mapping=TensorGeometry(mapping))
    assert set(got) == set(want)
    for alpha in want:
        table = got[alpha]
        assert torch.is_tensor(table) and table.dtype == torch.float64
        assert tuple(table.shape) == np.shape(want[alpha])
        assert _rel(table, np.asarray(want[alpha])) <= RTOL_TABLES, alpha


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_float32_tables_map_in_float64(i):
    """float32 tables mapped by M from numpy geometry come out float64, as
    fiat_tpu's (x64) do, equal to fiat_tpu's to 1e-14 of max(1, max |table|);
    M from tensor geometry gives the same."""
    tel, jel, mapping, t_cell = _case(i)
    nrows = tel._element.space_dimension()
    ref = np.random.default_rng(200 + i).standard_normal(
        (nrows,) + tuple(tel.value_shape) + (6,)).astype(np.float32)
    want = JMappedTabulation(jel.basis_transformation(mapping), {None: jnp.asarray(ref)},
                             indices=jel.restriction_indices)[None]
    assert want.dtype == jnp.float64
    for geom in (mapping, TensorGeometry(mapping)):
        got = TMappedTabulation(tel.basis_transformation(geom), {None: torch.as_tensor(ref)},
                                indices=tel.restriction_indices)[None]
        assert torch.is_tensor(got) and got.dtype == torch.float64
        assert tuple(got.shape) == want.shape
        assert _rel(got, np.asarray(want)) <= RTOL_M


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_physical_check(i):
    """The port's check_zany_mapping, M from tensor geometry on the cell's
    vertices applied by torch."""
    name, dim, args, kwargs = CASES[i]
    tel, _, _, t_cell = _case(i)
    M = t_to_dense(tel.basis_transformation(
        chip_smoke.SimplexGeometry(t_cell, torch.as_tensor(_verts(dim)))))
    assert chip_smoke.zany_physical_check(name, dim, args, kwargs, M, np) \
        <= chip_smoke.ZANY_PHYS_ATOL


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_dual_transformation_matches_fiat_tpu(i):
    tel, jel, mapping, _ = _case(i)
    Q = np.random.default_rng(200 + i).random((tel.space_dimension(), 7))
    want = np.asarray(jel.dual_transformation(Q, coordinate_mapping=mapping))
    assert np.array_equal(tel.dual_transformation(Q, coordinate_mapping=mapping), want)
    got = tel.dual_transformation(Q, coordinate_mapping=TensorGeometry(mapping))
    assert torch.is_tensor(got) and got.dtype == torch.float64
    assert _rel(got, want) <= RTOL_DUAL


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_vmap_over_cells(i):
    """One torch.func.vmap of basis_transformation over 4 cells (the
    distorted cell with its vertices moved by up to 0.05) against the 4
    per-cell Ms from numpy geometry."""
    tel, _, _, t_cell = _case(i)
    dim = t_cell.get_spatial_dimension()
    V = _verts(dim) + np.random.default_rng(300 + i).uniform(-0.05, 0.05, (4, dim + 1, dim))
    batched = torch.func.vmap(lambda v: t_to_dense(tel.basis_transformation(
        chip_smoke.SimplexGeometry(t_cell, v))))(torch.as_tensor(V))
    assert tuple(batched.shape) == (4, tel.space_dimension(), tel._element.space_dimension())
    for c in range(4):
        want = t_to_dense(tel.basis_transformation(chip_smoke.SimplexGeometry(t_cell, V[c])))
        assert _rel(batched[c], want) <= RTOL_M


MASS_CASES = _parametrized(tzm.test_mass_scaling)


@pytest.mark.parametrize("name,dim,args,kwargs", MASS_CASES,
                         ids=[f"{n}-{d}-{a}-{k}" for n, d, a, k in MASS_CASES])
def test_mass_scaling(name, dim, args, kwargs):
    """tests/test_zany_mapping.py's test_mass_scaling on the port, the
    scaled cells' geometry as CPU tensors: the physical mass matrix's
    condition number stays within 0.1 of its ratio 1 as the cell halves."""
    ref_cell = tcl.ufc_simplex(dim)
    element = getattr(tsym, name)(ref_cell, *args, **kwargs)
    ref_element = element._element
    Q = t_create_quadrature(ref_element.get_reference_complex(), 2 * ref_element.degree())
    qpts, qwts = Q.get_points(), Q.get_weights()
    phi_ref = ref_element.tabulate(0, qpts)[(0,) * dim]
    kappa = []
    for k in range(3):
        j_ref, phys = tzm._distorted_cells(dim)
        phys.vertices = tuple(map(tuple, 0.5 ** k * np.asarray(tcl.ufc_simplex(dim).vertices)))
        mapping = tzm.ScaledMapping(j_ref, phys)
        M = t_to_dense(element.basis_transformation(TensorGeometry(mapping)))
        assert torch.is_tensor(M)
        phis = np.tensordot(M.numpy(), phi_ref, (-1, 0))
        mass = (phis * (qwts * abs(np.linalg.det(mapping.A)))) @ phis.T
        kappa.append(np.linalg.cond(mass))
    ratios = np.asarray(kappa[1:]) / np.asarray(kappa[:-1])
    assert np.allclose(ratios, 1, atol=0.1), (name, kappa)
