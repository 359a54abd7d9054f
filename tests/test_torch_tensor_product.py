"""The tensor-product layer of the port against fiat_tpu on the CPU: the
product cells and hypercubes (topology, vertices, entity transforms, the
flattening maps, orientations, ``ufc_cell``), their quadrature rules and
facet rules, ``entity_support_dofs`` (the cases of
tests/test_facet_support_dofs.py), ``TensorProductElement`` /
``FlattenedDimensions`` / ``Hdiv`` / ``Hcurl`` / ``DPC`` (the cases of
tests/test_tp_parity_sweep.py), ``HDivTrace``, the non-nodal wrappers of
tests/test_nodality_sweep.py raising as fiat_tpu's do, and chip_smoke.py's
phase 21 zoo (``tp_zoo``) built by both packages.  Each element is
compared bit for bit: its order-1 tables, entity dofs, closure dofs,
entity permutations (or both refusing them) and its dual nodes' point
dictionaries.  The product check of phase 21 runs here on the kernels'
plain versions against fiat_tpu's ``TensorProductElement``; on the card
(marker ``cuda``, skipped without one) the product check and the
Bernstein check of phase 21 run at a small size.

Inputs are numpy arrays made from seeds and handed to both packages."""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import fiat_tpu_torch as ft
from fiat_tpu_torch import device_tabulator
from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.core import orientation as torn
from fiat_tpu_torch.core import quadrature as tq
from fiat_tpu_torch.core.finite_element import entity_support_dofs as t_support

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))
import chip_smoke  # noqa: E402

try:    # fiat_tpu and JAX, the CPU tests' oracle; the card's cases need neither
    import fiat_tpu
    from fiat_tpu import elements as jfe
    from fiat_tpu.core import cells as jcl
    from fiat_tpu.core import orientation as jorn
    from fiat_tpu.core import quadrature as jq
    from fiat_tpu.core.finite_element import entity_support_dofs as j_support
    import test_facet_support_dofs as support_cases
    # fiat_tpu's root exports its elements module's names but the trimmed
    # serendipity and BDM-cube ones: the namespace of chip_smoke.tp_zoo
    jf = SimpleNamespace(**{**vars(fiat_tpu), **vars(jfe)})
except ImportError:
    jf = None

RNG = np.random.default_rng(21)
#: the sympy families (trimmed serendipity, BDM on cubes) against fiat_tpu,
#: of max(1, max |table|) per alpha: the same expressions lambdified in the
#: same order, but sympy's global cache can hand back an equal expression
#: built earlier by the other package with another tree (Integer 2 for
#: Float 2.0), which rounds differently in the last bit (2.8e-17 seen on
#: SminusF 3 when the two zoos are tabulated in turns)
RTOL_SYMPY = 1e-14
SYMPY_FAMILIES = ("SminusF", "SminusE", "SminusDiv", "SminusCurl", "BDMCF", "BDMCE")


def _cells(m):
    """The cells both packages hold, by name."""
    c = m.cells if hasattr(m, "cells") else m
    I, T = c.ufc_simplex(1), c.ufc_simplex(2)
    return {"quadrilateral": c.UFCQuadrilateral(), "hexahedron": c.UFCHexahedron(),
            "I x I": c.TensorProductCell(I, I), "T x I": c.TensorProductCell(T, I),
            "I x I x I": c.TensorProductCell(I, I, I),
            "(I x I) x I": c.TensorProductCell(c.TensorProductCell(I, I), I)}


CELLS = ("quadrilateral", "hexahedron", "I x I", "T x I", "I x I x I", "(I x I) x I")


def _plain(x):
    """Topology and maps as plain Python values (numpy integers to int)."""
    if isinstance(x, dict):
        return {_plain(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, np.integer):
        return int(x)
    return x


def _refused(call):
    try:
        return False, call()
    except NotImplementedError:
        return True, None


def same_element(t, j, pts, order=1, entity=None, rtol=None):
    """Port element ``t`` and fiat_tpu's ``j`` bit for bit: tables of
    derivative order <= ``order`` at ``pts`` (on ``entity``; within
    ``rtol`` of max(1, max |table|) per alpha where given), entity dofs,
    closure dofs, entity permutations (or both refusing), space dimension,
    value shape and the dual nodes' point and derivative dictionaries."""
    args = (order, pts) if entity is None else (order, pts, entity)
    a, b = t.tabulate(*args), j.tabulate(*args)
    assert set(a) == set(b)
    for alpha in b:
        if isinstance(b[alpha], np.ndarray) or hasattr(b[alpha], "shape"):
            x, y = np.asarray(a[alpha]), np.asarray(b[alpha])
            if rtol is None:
                assert np.array_equal(x, y), alpha
            else:
                assert x.shape == y.shape
                assert np.abs(x - y).max() <= rtol * max(1.0, np.abs(y).max()), alpha
        else:
            assert type(a[alpha]).__name__ == type(b[alpha]).__name__, alpha
    assert t.space_dimension() == j.space_dimension()
    assert _plain(t.entity_dofs()) == _plain(j.entity_dofs())
    assert _plain(t.entity_closure_dofs()) == _plain(j.entity_closure_dofs())
    tp, jp = _refused(t.entity_permutations), _refused(j.entity_permutations)
    assert tp[0] == jp[0]
    assert _plain(tp[1]) == _plain(jp[1])
    tv, jv = _refused(t.value_shape), _refused(j.value_shape)
    assert tv == jv
    tn, jn = t.dual.nodes, j.dual.nodes
    assert len(tn) == len(jn)
    for x, y in zip(tn, jn):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.functional_type == y.functional_type
            assert x.pt_dict == y.pt_dict and x.deriv_dict == y.deriv_dict


def _points(cell, n=9):
    """Points inside a cell of either package: the unit box for
    hypercubes, the triangle's corner for a T x I factor."""
    sd = cell.get_spatial_dimension()
    pts = RNG.random((n, sd)) * 0.9
    if getattr(cell, "cells", None) and cell.cells[0].get_spatial_dimension() == 2:
        pts[:, :2] *= 0.45
    return pts


# -- cells -------------------------------------------------------------------------

@pytest.mark.parametrize("name", CELLS)
def test_cells_match(name):
    t, j = _cells(tcl)[name], _cells(jcl)[name]
    assert _plain(t.get_topology()) == _plain(j.get_topology())
    assert t.get_vertices() == j.get_vertices()
    assert t.get_shape() == j.get_shape()
    assert t.get_dimension() == j.get_dimension()
    assert t.get_spatial_dimension() == j.get_spatial_dimension()
    assert _plain(t.sub_entities) == _plain(j.sub_entities)
    assert _plain(t.connectivity) == _plain(j.connectivity)
    assert t.volume() == j.volume()
    if any(hasattr(c, "cells") for c in getattr(t, "cells", ())):
        return      # a nested product splits no coordinates by its dimension: both raise
    pts = _points(t, 11)
    assert np.array_equal(t.contains_point(pts), j.contains_point(pts))
    assert np.array_equal(t.distance_to_point_l1(pts - 0.3), j.distance_to_point_l1(pts - 0.3))
    for dim, ents in t.get_topology().items():
        assert t.symmetry_group_size(dim) == j.symmetry_group_size(dim)
        sub_t, sub_j = t.construct_subelement(dim), j.construct_subelement(dim)
        assert type(sub_t).__name__ == type(sub_j).__name__
        assert sub_t.get_vertices() == sub_j.get_vertices()
        x = RNG.random((5, sub_t.get_spatial_dimension()))
        for e in ents:
            assert np.array_equal(t.get_entity_transform(dim, e)(x),
                                  j.get_entity_transform(dim, e)(x))
    corners = np.asarray(t.get_vertices(), dtype=float)
    assert _plain(t.point_entity_ids(corners)) == _plain(j.point_entity_ids(corners))


@pytest.mark.parametrize("name", CELLS)
def test_flattening_and_orientation_maps(name):
    t, j = _cells(tcl)[name], _cells(jcl)[name]
    tp = getattr(t, "product", t)
    jp = getattr(j, "product", j)
    assert _plain(tcl.flatten_entities(tp.get_topology())) == _plain(
        jcl.flatten_entities(jp.get_topology()))
    assert _plain(tcl.compute_unflattening_map(tp.get_topology())) == _plain(
        jcl.compute_unflattening_map(jp.get_topology()))
    assert _plain(t.cell_orientation_reflection_map()) == _plain(
        j.cell_orientation_reflection_map())
    assert tcl.is_ufc(t) == jcl.is_ufc(j) and tcl.is_hypercube(t) == jcl.is_hypercube(j)
    assert type(tcl.flatten_reference_cube(t)).__name__ == type(
        jcl.flatten_reference_cube(j)).__name__
    assert np.array_equal(tp.extrinsic_orientation_permutation_map,
                          jp.extrinsic_orientation_permutation_map)
    for o in range(2 ** len(tp.cells) * 3):
        assert tp.extract_extrinsic_orientation(o) == jp.extract_extrinsic_orientation(o)
        for axis in range(len(tp.cells)):
            assert tp.extract_intrinsic_orientation(o, axis) == \
                jp.extract_intrinsic_orientation(o, axis)
    nested = any(hasattr(c, "cells") for c in tp.cells)     # no normals: both raise
    for dim in tp.get_topology():
        if not nested and tcl.tuple_sum(dim) == tcl.tuple_sum(tp.get_dimension()) - 1:
            for e in tp.get_topology()[dim]:
                assert np.array_equal(tp.compute_reference_normal(dim, e),
                                      jp.compute_reference_normal(dim, e))


def test_product_entity_permutations_and_flattened_permutations():
    """The composed orientation maps of a product of interval (and
    triangle) factors, and their flattening, against fiat_tpu's."""
    I, T = tcl.ufc_simplex(1), tcl.ufc_simplex(2)
    jI, jT = jcl.ufc_simplex(1), jcl.ufc_simplex(2)
    for cells, jcells, npts in (((I, I), (jI, jI), (3, 2)), ((I, I, I), (jI, jI, jI), (2, 3, 2)),
                                ((T, I), (jT, jI), (3, 2))):
        for dim in ((1, 1), (0, 1), (1, 0)) if len(cells) == 2 else ((1, 1, 1), (1, 0, 1)):
            maps = [torn.make_entity_permutations_simplex(d, n) for d, n in zip(dim, npts)]
            jmaps = [jorn.make_entity_permutations_simplex(d, n) for d, n in zip(dim, npts)]
            if len(set(cells)) not in (1, len(cells)):
                continue
            assert torn.make_entity_permutations_tensorproduct(cells, dim, maps) == \
                jorn.make_entity_permutations_tensorproduct(jcells, dim, jmaps)
    perms = {(1, 1): {0: {(0, 0, 0): [0, 1], (0, 1, 0): [1, 0]}},
             (0, 1): {0: {(0, 0): [0]}, 1: {(0, 1): []}}}
    assert tcl.flatten_permutations(perms) == jcl.flatten_permutations(perms)
    with pytest.raises(ValueError):
        tcl.max_complex([tcl.ufc_simplex(2), tcl.ufc_simplex(3)])
    assert tcl.max_complex([T]) is T


@pytest.mark.parametrize("name", ["quadrilateral", "hexahedron", "interval * interval",
                                  "triangle * interval", "interval * interval * interval",
                                  "vertex", "interval", "triangle", "tetrahedron"])
def test_ufc_cell_names(name):
    t, j = tcl.ufc_cell(name), jcl.ufc_cell(name)
    assert type(t).__name__ == type(j).__name__
    assert t.get_vertices() == j.get_vertices()
    assert _plain(t.get_topology()) == _plain(j.get_topology())
    assert tcl.tuple_sum(t.get_dimension()) == jcl.tuple_sum(j.get_dimension())


def test_ufc_cell_refuses_unknown_names():
    with pytest.raises(ValueError, match="Unknown UFC cell"):
        tcl.ufc_cell("pyramid")


def test_cell_order_on_products():
    I = tcl.ufc_simplex(1)
    P = tcl.TensorProductCell(I, I)
    assert P >= P and P <= P and not P > P and not P < P
    assert tcl.UFCQuadrilateral() >= P
    assert hash(P) == hash(tcl.TensorProductCell(I, I))


# -- quadrature ------------------------------------------------------------------

def _same_rule(t, j):
    assert np.array_equal(t.get_points(), j.get_points())
    assert np.array_equal(t.get_weights(), j.get_weights())


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("degree", [0, 3, 6, (2, 5)])
def test_create_quadrature_on_product_cells(name, degree):
    """One degree for every factor, or one a factor (the last ones 1)."""
    t, j = _cells(tcl)[name], _cells(jcl)[name]
    prod = getattr(t, "cells", None) or t.product.cells
    if isinstance(degree, tuple):
        degree = degree + (1,) * (len(prod) - 2)
    got, want = ft.create_quadrature(t, degree), jf.create_quadrature(j, degree)
    _same_rule(got, want)
    total = tcl.tuple_sum(t.get_dimension())
    assert got.get_points().shape == (len(got.get_weights()), t.get_spatial_dimension())
    assert abs(got.get_weights().sum() - t.volume()) <= 1e-14 * total


@pytest.mark.parametrize("name", ["quadrilateral", "hexahedron"])
@pytest.mark.parametrize("m", [1, 3, 5])
def test_make_quadrature_on_hypercubes(name, m):
    t, j = _cells(tcl)[name], _cells(jcl)[name]
    _same_rule(ft.make_quadrature(t, m), jf.make_quadrature(j, m))
    rule = tq.make_tensor_product_quadrature(*[tq.GaussJacobiQuadratureLineRule(
        tcl.ufc_simplex(1), k) for k in (m, m + 1)])
    jrule = jq.make_tensor_product_quadrature(*[jq.GaussJacobiQuadratureLineRule(
        jcl.ufc_simplex(1), k) for k in (m, m + 1)])
    _same_rule(rule, jrule)


@pytest.mark.parametrize("name", ["quadrilateral", "hexahedron", "I x I", "T x I"])
def test_facet_rules_on_product_cells(name):
    """create_quadrature on each facet entity (FacetQuadratureRule), and
    the rule of the facet cell itself."""
    t, j = _cells(tcl)[name], _cells(jcl)[name]
    for dim, ents in t.get_topology().items():
        if tcl.tuple_sum(dim) != t.get_spatial_dimension() - 1:
            continue
        for e in ents:
            got = ft.create_quadrature(t, 4, entity=(dim, e))
            want = jf.create_quadrature(j, 4, entity=(dim, e))
            _same_rule(got, want)
            assert np.array_equal(got.jacobian(), want.jacobian())
            assert got.jacobian_determinant() == want.jacobian_determinant()


def test_unported_scheme_still_raises_on_products():
    """The "gm" scheme on a product cell, once refused with the scheme, is
    the product of the factors' Grundmann-Moller rules, fiat_tpu's bit for
    bit; an unknown scheme still raises ValueError."""
    T = tcl.ufc_simplex(2)
    got = ft.create_quadrature(tcl.TensorProductCell(T, tcl.ufc_simplex(1)), 3, "gm")
    want = fiat_tpu.create_quadrature(jcl.TensorProductCell(jcl.ufc_simplex(2),
                                                            jcl.ufc_simplex(1)), 3, "gm")
    assert np.array_equal(got.get_points(), np.asarray(want.get_points()))
    assert np.array_equal(got.get_weights(), np.asarray(want.get_weights()))
    with pytest.raises(ValueError):
        ft.create_quadrature(tcl.TensorProductCell(T, tcl.ufc_simplex(1)), 3, "nonsense")


# -- entity_support_dofs ------------------------------------------------------------

def _support_cases(test):
    """The (base, extruded, expected...) cases of one of
    tests/test_facet_support_dofs.py's parametrized tests."""
    return [m.args[1] for m in test.pytestmark if m.name == "parametrize"][0]


def _cell_family(m, base, cell):
    return getattr(m.elements if hasattr(m, "elements") else m, base[0])(cell, base[1])


@pytest.mark.parametrize("case", range(5))
def test_entity_support_dofs_quad(case):
    base, extr, horiz, vert = _support_cases(support_cases.test_quad)[case]
    I, jI = tcl.UFCInterval(), jcl.UFCInterval()
    t = ft.TensorProductElement(_cell_family(ft, base, I), _cell_family(ft, extr, I))
    j = jf.TensorProductElement(_cell_family(jf, base, jI), _cell_family(jf, extr, jI))
    for dim, want in (((1, 0), horiz), ((0, 1), vert)):
        assert t_support(t, dim) == j_support(j, dim) == want


@pytest.mark.parametrize("case", range(4))
def test_entity_support_dofs_prism(case):
    base, extr, horiz, vert = _support_cases(support_cases.test_prism)[case]
    t = ft.TensorProductElement(_cell_family(ft, base, tcl.UFCTriangle()),
                                _cell_family(ft, extr, tcl.UFCInterval()))
    j = jf.TensorProductElement(_cell_family(jf, base, jcl.UFCTriangle()),
                                _cell_family(jf, extr, jcl.UFCInterval()))
    for dim, want in (((2, 0), horiz), ((1, 1), vert)):
        assert t_support(t, dim) == j_support(j, dim) == want


def _rtcf_like(m, space, cell, I):
    W0 = m.Hdiv(m.TensorProductElement(space(cell, 1), m.DiscontinuousLagrange(I, 0)))
    W1 = m.Hdiv(m.TensorProductElement(m.DiscontinuousLagrange(cell, 0), m.Lagrange(I, 1)))
    return m.EnrichedElement(W0, W1)


@pytest.mark.parametrize("space", ["Lagrange", "RaviartThomas", "BrezziDouglasMarini"])
def test_entity_support_dofs_enriched_hdiv(space):
    """The enriched Hdiv layouts of test_facet_support_dofs.py: RTCF on the
    quadrilateral, RT / BDM prisms, and on the flat quadrilateral."""
    if space == "Lagrange":
        cells, jcells = (tcl.UFCInterval(), tcl.UFCInterval()), (jcl.UFCInterval(),) * 2
    else:
        cells, jcells = (tcl.UFCTriangle(), tcl.UFCInterval()), (jcl.UFCTriangle(),
                                                                   jcl.UFCInterval())
    t = _rtcf_like(ft, getattr(ft, space), *cells)
    j = _rtcf_like(jf, getattr(jf, space), *jcells)
    sd = t.get_reference_element().get_spatial_dimension()
    for dim in t.entity_dofs():
        if tcl.tuple_sum(dim) == sd - 1:
            assert t_support(t, dim) == j_support(j, dim)
    same_element(t, j, _points(t.get_reference_element()))
    if space == "Lagrange":
        tf, jfl = ft.FlattenedDimensions(t), jf.FlattenedDimensions(j)
        assert t_support(tf, 1) == j_support(jfl, 1)
        same_element(tf, jfl, _points(tcl.UFCQuadrilateral()))


# -- tensor-product elements (tests/test_tp_parity_sweep.py) ------------------------------

FACTORIES = {"CG": "Lagrange", "DG": "DiscontinuousLagrange", "GLL": "GaussLobattoLegendre",
             "GL": "GaussLegendre"}
TP_CASES = [(fa, pa, fb, pb) for fa, pa in (("CG", 1), ("CG", 3), ("DG", 2), ("GLL", 4))
            for fb, pb in (("CG", 2), ("DG", 1), ("GL", 3))]


def _make(m, family, cell, degree):
    return getattr(m, FACTORIES[family])(cell, degree)


@pytest.mark.parametrize("fa,pa,fb,pb", TP_CASES,
                         ids=[f"{a}{p}x{b}{q}" for a, p, b, q in TP_CASES])
def test_interval_products_match(fa, pa, fb, pb):
    I, jI = tcl.ufc_simplex(1), jcl.ufc_simplex(1)
    t = ft.TensorProductElement(_make(ft, fa, I, pa), _make(ft, fb, I, pb))
    j = jf.TensorProductElement(_make(jf, fa, jI, pa), _make(jf, fb, jI, pb))
    pts = RNG.random((8, 2)) * 0.8
    same_element(t, j, pts)
    assert t.degree() == j.degree() and t.get_formdegree() == j.get_formdegree()
    assert t.mapping() == j.mapping() and t.is_nodal() == j.is_nodal()
    for dim, ents in t.get_reference_element().get_topology().items():
        for e in ents:
            sub = RNG.random((4, tcl.tuple_sum(dim)))
            same_element(t, j, sub, entity=(dim, e))


@pytest.mark.parametrize("family,degree", [("CG", 1), ("CG", 2), ("CG", 3), ("DG", 1),
                                           ("DG", 2), ("GLL", 3)])
@pytest.mark.parametrize("dim", [2, 3])
def test_flattened_hypercubes_match(family, degree, dim):
    def build(m, I):
        el = m.TensorProductElement(_make(m, family, I, degree), _make(m, family, I, degree))
        if dim == 3:
            el = m.TensorProductElement(el, _make(m, family, I, degree))
        return m.FlattenedDimensions(el)
    t, j = build(ft, tcl.ufc_simplex(1)), build(jf, jcl.ufc_simplex(1))
    same_element(t, j, RNG.random((8, dim)) * 0.8)
    cell = t.get_reference_element()
    for d in range(dim):
        for e in cell.get_topology()[d]:
            same_element(t, j, RNG.random((3, d)), order=0, entity=(d, e))
    assert t.degree() == j.degree() and t.value_shape() == j.value_shape()


@pytest.mark.parametrize("degree", [1, 2, 3])
@pytest.mark.parametrize("kind", ["hdiv", "hcurl"])
def test_hdiv_hcurl_wrappers_match(kind, degree):
    def build(m, I):
        k1 = degree - 1
        if kind == "hdiv":
            return m.Hdiv(m.TensorProductElement(m.DiscontinuousLagrange(I, k1),
                                                 m.Lagrange(I, degree)))
        return m.Hcurl(m.TensorProductElement(m.Lagrange(I, max(degree, 1)),
                                              m.DiscontinuousLagrange(I, k1)))
    t, j = build(ft, tcl.ufc_simplex(1)), build(jf, jcl.ufc_simplex(1))
    same_element(t, j, RNG.random((8, 2)) * 0.8)
    assert t.mapping() == j.mapping() and t.get_formdegree() == j.get_formdegree()


def test_hdiv_hcurl_refuse_as_fiat_tpu():
    I = tcl.ufc_simplex(1)
    with pytest.raises(NotImplementedError):
        ft.Hdiv(ft.Lagrange(I, 1))
    with pytest.raises(ValueError):     # a 0-form product is no (n-1)-form
        ft.Hdiv(ft.TensorProductElement(ft.Lagrange(I, 1), ft.Lagrange(I, 1)))
    with pytest.raises(ValueError):
        ft.Hcurl(ft.TensorProductElement(ft.DiscontinuousLagrange(I, 0),
                                         ft.DiscontinuousLagrange(I, 0)))


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
@pytest.mark.parametrize("dim", [2, 3])
def test_dpc_matches(degree, dim):
    t, j = ft.DPC(tcl.ufc_hypercube(dim), degree), jf.DPC(jcl.ufc_hypercube(dim), degree)
    same_element(t, j, RNG.random((8, dim)) * 0.8)
    assert np.array_equal(t.get_coeffs(), j.get_coeffs())


@pytest.mark.parametrize("degree", [2, 3, 4, 5])
def test_triangle_times_interval_matches(degree):
    t = ft.TensorProductElement(ft.Lagrange(tcl.ufc_simplex(2), degree - 1),
                                ft.Lagrange(tcl.ufc_simplex(1), degree))
    j = jf.TensorProductElement(jf.Lagrange(jcl.ufc_simplex(2), degree - 1),
                                jf.Lagrange(jcl.ufc_simplex(1), degree))
    same_element(t, j, _points(t.get_reference_element(), 8))


def test_vector_products_refuse_as_fiat_tpu():
    """A product of two Piola-mapped factors is refused by both packages."""
    def build(m, I):
        hdiv = m.Hdiv(m.TensorProductElement(m.DiscontinuousLagrange(I, 0), m.Lagrange(I, 1)))
        return m.TensorProductElement(m.Hcurl(m.TensorProductElement(
            m.Lagrange(I, 1), m.DiscontinuousLagrange(I, 0))), hdiv)
    for m, c in ((ft, tcl), (jf, jcl)):
        with pytest.raises(ValueError, match="affine"):
            build(m, c.ufc_simplex(1))
    I = tcl.ufc_simplex(1)
    hdiv = ft.Hdiv(ft.TensorProductElement(ft.DiscontinuousLagrange(I, 0), ft.Lagrange(I, 1)))
    with pytest.raises(ValueError, match="affine"):
        ft.TensorProductElement(ft.RaviartThomas(tcl.ufc_simplex(2), 1), hdiv)


# -- HDivTrace -----------------------------------------------------------------------

@pytest.mark.parametrize("sd,degree", [(2, 0), (2, 1), (2, 2), (3, 1), (3, 2)])
def test_hdiv_trace_on_simplices_matches(sd, degree):
    t, j = ft.HDivTrace(tcl.ufc_simplex(sd), degree), jf.HDivTrace(jcl.ufc_simplex(sd), degree)
    # entity-free: points binned to the facets they lie on
    cell = tcl.ufc_simplex(sd)
    on = np.concatenate([cell.get_entity_transform(sd - 1, f)(RNG.random((3, sd - 1)) / sd)
                         for f in cell.get_topology()[sd - 1]])
    same_element(t, j, on)
    # off the facets: NaN tables on both
    inside = np.full((2, sd), 0.2)
    a, b = t.tabulate(0, inside), j.tabulate(0, inside)
    assert np.isnan(a[(0,) * sd]).all() and np.isnan(b[(0,) * sd]).all()
    for f in cell.get_topology()[sd - 1]:
        same_element(t, j, RNG.random((4, sd - 1)), entity=(sd - 1, f))
    got = t.tabulate(0, inside, (sd, 0)) if sd > 1 else None
    if got is not None:
        assert set(got) == set(j.tabulate(0, inside, (sd, 0)))


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_hdiv_trace_on_the_product_matches(degree):
    I, jI = tcl.ufc_simplex(1), jcl.ufc_simplex(1)
    t = ft.HDivTrace(tcl.TensorProductCell(I, I), degree)
    j = jf.HDivTrace(jcl.TensorProductCell(jI, jI), degree)
    for dim in ((0, 1), (1, 0)):
        for e in t.entity_dofs()[dim]:
            same_element(t, j, RNG.random((6, 1)), entity=(dim, e))
    with pytest.raises(NotImplementedError, match="only supported on simplices"):
        t.tabulate(0, RNG.random((3, 2)))
    with pytest.raises(NotImplementedError, match="only supported on simplices"):
        j.tabulate(0, RNG.random((3, 2)))
    interior = t.tabulate(0, RNG.random((3, 2)), ((1, 1), 0))
    assert all(type(v).__name__ == "TraceError" for v in interior.values())


def test_hdiv_trace_variant_and_refusals():
    T, jT = tcl.ufc_simplex(2), jcl.ufc_simplex(2)
    t, j = ft.HDivTrace(T, 2, variant="integral"), jf.HDivTrace(jT, 2, variant="integral")
    for f in range(3):
        same_element(t, j, RNG.random((4, 1)), order=0, entity=(1, f))
    with pytest.raises(ValueError):
        ft.HDivTrace(tcl.ufc_simplex(0), 1)
    with pytest.raises(ValueError):
        ft.HDivTrace(T, (1, 2))


# -- non-nodal wrappers (tests/test_nodality_sweep.py:183-208) ---------------------------

def _non_nodal(m, c):
    I, T, S = c.ufc_simplex(1), c.ufc_simplex(2), c.ufc_simplex(3)
    TP = m.TensorProductElement
    return {
        "TP": lambda: TP(m.Lagrange(I, 1), m.Lagrange(I, 1)),
        "TP3": lambda: TP(TP(m.Lagrange(I, 2), m.Lagrange(I, 2)), m.Lagrange(I, 2)),
        "Flattened": lambda: m.FlattenedDimensions(TP(m.Lagrange(I, 2), m.Lagrange(I, 2))),
        "HDivTrace-T": lambda: m.HDivTrace(T, 2),
        "HDivTrace-S": lambda: m.HDivTrace(S, 1),
        "Hdiv-TP": lambda: m.Hdiv(TP(m.DiscontinuousLagrange(I, 1), m.Lagrange(I, 2))),
        "Hcurl-TP": lambda: m.Hcurl(TP(m.DiscontinuousLagrange(I, 1), m.Lagrange(I, 2))),
    }


@pytest.mark.parametrize("name", ["TP", "TP3", "Flattened", "HDivTrace-T", "HDivTrace-S",
                                  "Hdiv-TP", "Hcurl-TP"])
def test_non_nodal_wrappers_raise_as_fiat_tpu(name):
    t, j = _non_nodal(ft, tcl)[name](), _non_nodal(jf, jcl)[name]()
    for el in (t, j):
        with pytest.raises(NotImplementedError):
            el.get_nodal_basis()
    for method in ("get_coeffs", "dmats"):
        assert _refused(getattr(t, method))[0] == _refused(getattr(j, method))[0]
    assert t.is_nodal() == j.is_nodal()


# -- chip_smoke.py's phase 21 ------------------------------------------------------------

def test_tp_zoo_matches_fiat_tpu():
    """Phase 21's zoo (``chip_smoke.tp_zoo``) built by both packages, every
    element bit for bit on 40 points of its group (HDivTrace on each facet
    of I x I; QuadratureElement at order 0 at its own points)."""
    tzoo, jzoo = chip_smoke.tp_zoo(ft), chip_smoke.tp_zoo(jf)
    pts = chip_smoke.tp_points(40, 42, np)
    assert [len(v) for v in tzoo.values()] == [48, 23, 4, 3]
    for group in tzoo:
        for (label, t), (jlabel, j) in zip(tzoo[group], jzoo[group]):
            assert label == jlabel
            if label.startswith("QuadratureElement"):
                same_element(t, j, np.asarray(t._points), order=0)
            elif group == "trace":
                for dim in ((0, 1), (1, 0)):
                    for e in t.entity_dofs()[dim]:
                        same_element(t, j, pts[group], entity=(dim, e))
            else:
                sympy_built = label.split()[0] in SYMPY_FAMILIES
                same_element(t, j, pts[group], rtol=RTOL_SYMPY if sympy_built else None)
    host, _ = chip_smoke.tp_host_tables(tzoo, pts, np, check=40)
    assert len(host) == 78


def test_phase21_product_check_on_the_plain_kernels():
    """The product check of phase 21 on the CPU (K1's and K2's plain
    versions): the factors of every Q and DQ through the f64 engine at each
    column of the points, Kronecker products by ``kron_tables``, against
    fiat_tpu's TensorProductElement tables at 1e-14 of max(1, max
    |table|) per alpha."""
    tzoo, jzoo = chip_smoke.tp_zoo(ft), chip_smoke.tp_zoo(jf)
    pts = chip_smoke.tp_points(300, 42, np)
    for group, sd in (("quadrilateral", 2), ("hexahedron", 3)):
        for (label, el), (_, jel) in zip(tzoo[group], jzoo[group]):
            if label.split()[0] not in ("Q", "DQ"):
                continue
            factors = chip_smoke.tp_factors(el)
            assert len(factors) == sd
            tab = device_tabulator(factors, order=1, device="cpu")
            per = [tab.unpack(tab.block_tables(torch.as_tensor(
                np.ascontiguousarray(pts[group][:, i:i + 1]))))[i] for i in range(sd)]
            got = chip_smoke.kron_tables(per, 1, torch)
            want = jel.tabulate(1, pts[group])
            assert set(got) == set(want)
            for a, w in want.items():
                w = np.asarray(w)
                assert np.abs(got[a].numpy() - w).max() <= 1e-14 * max(1.0, np.abs(w).max())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_phase21_checks_on_card(cuda):
    """Phase 21's product check and Bernstein check at a small size on the
    card: the factor tables of Q 3 x 3 and DQ 2 on the hexahedron on K1 +
    K2 (one launch each a column), their Kronecker products against the
    host TensorProductElement tables, and K8 on the Bernstein element of
    sd 1-3 at degrees 2 and 7 against its order-0 table and its plain
    version."""
    from fiat_tpu_torch.ops.bernstein import BernsteinFeatures, _bary_map
    pts = chip_smoke.tp_points(20_001, 7, np)["hexahedron"]
    for el in (chip_smoke.tp_product(ft, 3, 3), chip_smoke.tp_product(ft, 2, 3, False)):
        factors = chip_smoke.tp_factors(el)
        tab = device_tabulator(factors, order=1, device=cuda)
        per = []
        for i in range(3):
            tab.recurrence.launches = tab.matmul.launches = 0
            C = torch.as_tensor(np.ascontiguousarray(pts[:, i:i + 1]), device=cuda)
            per.append(tab.unpack(tab.block_tables(C))[i])
            torch.cuda.synchronize()
            assert (tab.recurrence.launches, tab.matmul.launches) == (1, 1)
        got = chip_smoke.kron_tables(per, 1, torch)
        want = el.tabulate(1, pts[:500])
        for a, w in want.items():
            err = np.abs(got[a][:, :500].cpu().numpy() - w).max()
            assert err <= chip_smoke.TP_PRODUCT_RTOL * max(1.0, np.abs(w).max())
    for sd in (1, 2, 3):
        cell = ft.ufc_simplex(sd)
        x = chip_smoke.make_points(10_001, 3, np, sd=sd)
        P = torch.as_tensor(x, device=cuda)
        for d in (2, 7):
            feat = BernsteinFeatures(sd, d, _bary_map(cell), device=cuda)
            B = feat(P)
            torch.cuda.synchronize()
            assert feat.launches == 1
            want = ft.Bernstein(cell, d).tabulate(0, x[:500])[(0,) * sd]
            got = B[chip_smoke.bernstein_rows(sd, d)][:, :500].cpu().numpy()
            scale = np.abs(want).max()
            assert np.abs(got - want).max() <= chip_smoke.BERNSTEIN_RTOL * scale
            assert (B - feat.plain(P)).abs().max().item() <= chip_smoke.BERNSTEIN_RTOL * scale
