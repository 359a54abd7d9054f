"""The composite elements, the pointwise dual, Bernstein and the
orthogonal-polynomial utilities of the port against fiat_tpu on the CPU:
``MixedElement``, ``EnrichedElement`` (RTCF / RTCE on I x I, simplicial
sums), ``QuadratureElement`` (with its refusals), ``compute_pointwise_dual``,
``Bernstein`` on the three simplices to degree 8 at every derivative order
up to the degree (and its order-0 table against K8's plain version,
``BernsteinFeatures.plain``, under the row permutation of chip_smoke.py's
phase 21), and ``core.orthopoly`` with the cases of tests/test_orthopoly.py.

Elements are compared bit for bit (``same_element``: tables, entity dofs,
closure dofs, permutations, dual point dictionaries); inputs are numpy
arrays made from seeds and handed to both packages."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import fiat_tpu_torch as ft
from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.core import orthopoly as topq
from fiat_tpu_torch.core.pointwise_dual import compute_pointwise_dual as t_pointwise_dual
from fiat_tpu_torch.ops.bernstein import BernsteinFeatures, _bary_map

import fiat_tpu.elements as jfe
from fiat_tpu.core import cells as jcl
from fiat_tpu.core import orthopoly as jopq
from fiat_tpu.core.pointwise_dual import compute_pointwise_dual as j_pointwise_dual

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))
import chip_smoke  # noqa: E402
from test_torch_tensor_product import jf, same_element  # noqa: E402

RNG = np.random.default_rng(5)
#: K8's plain version against the Bernstein element's order-0 table, of
#: max |table|: the same products in another order (fiat_tpu's element and
#: the port's host table differ by at most 1.1e-16 there)
RTOL_BERNSTEIN = 1e-14


def _simplex_points(sd, n=12):
    pts = RNG.random((n, sd))
    return pts / (pts.sum(axis=1)[:, None] + 1e-9) * RNG.random((n, 1))


# -- MixedElement ------------------------------------------------------------------

MIXED = {
    "P2 x RT2": lambda m, T: [m.Lagrange(T, 2), m.RaviartThomas(T, 2)],
    "DG1 x P3": lambda m, T: [m.DiscontinuousLagrange(T, 1), m.Lagrange(T, 3)],
    "N1 x P1 x DG0": lambda m, T: [m.Nedelec(T, 1), m.Lagrange(T, 1),
                                   m.DiscontinuousLagrange(T, 0)],
    "Regge1 x P1": lambda m, T: [m.Regge(T, 1), m.Lagrange(T, 1)],
}


@pytest.mark.parametrize("sd", [2, 3])
@pytest.mark.parametrize("name", sorted(MIXED))
def test_mixed_element_matches(name, sd):
    t = ft.MixedElement(MIXED[name](ft, tcl.ufc_simplex(sd)))
    j = jfe.MixedElement(MIXED[name](jfe, jcl.ufc_simplex(sd)))
    pts = _simplex_points(sd)
    same_element(t, j, pts)
    assert t.value_shape() == j.value_shape() and t.mapping() == j.mapping()
    assert t.num_sub_elements() == j.num_sub_elements() and t.is_nodal() == j.is_nodal()
    for dim, ents in t.get_reference_element().get_topology().items():
        for e in ents:
            same_element(t, j, RNG.random((3, dim)) / max(dim, 1), order=0, entity=(dim, e))
    # each block is its member's table
    tab, rows, cols = t.tabulate(1, pts), 0, 0
    for sub in t.elements():
        n, c = sub.space_dimension(), max(int(np.prod(sub.value_shape())), 1)
        for a, v in sub.tabulate(1, pts).items():
            assert np.array_equal(tab[a][rows:rows + n, cols:cols + c], v.reshape(n, c, -1))
            assert not tab[a][rows:rows + n, :cols].any() and not tab[a][rows:rows + n,
                                                                         cols + c:].any()
        rows, cols = rows + n, cols + c
    with pytest.raises(NotImplementedError):
        t.get_nodal_basis()


def test_mixed_element_refuses_two_cells():
    with pytest.raises(ValueError):
        ft.MixedElement([ft.Lagrange(tcl.ufc_simplex(2), 1), ft.Lagrange(tcl.ufc_simplex(3), 1)])


# -- EnrichedElement -----------------------------------------------------------------

@pytest.mark.parametrize("degree", [1, 2, 3, 4])
@pytest.mark.parametrize("curl", [False, True])
def test_rtcf_rtce_match(curl, degree):
    """RTCF / RTCE as phase 21 builds them (chip_smoke.quad_piola), on I x I
    and flattened onto the quadrilateral, and entity by entity."""
    t, j = chip_smoke.quad_piola(ft, degree, curl), chip_smoke.quad_piola(jf, degree, curl)
    pts = RNG.random((10, 2))
    same_element(t, j, pts)
    assert t.mapping() == j.mapping() and t.get_formdegree() == j.get_formdegree()
    assert t.degree() == j.degree() and t.get_order() == j.get_order()
    for dim, ents in t.get_reference_element().get_topology().items():
        for e in ents:
            same_element(t, j, RNG.random((3, sum(dim))), order=0, entity=(dim, e))
    same_element(ft.FlattenedDimensions(t), jf.FlattenedDimensions(j), pts)


@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("curl", [False, True])
def test_ncf_nce_match(curl, degree):
    """NCF / NCE on (I x I) x I as phase 21 builds them
    (chip_smoke.hex_piola), and flattened onto the hexahedron."""
    t, j = chip_smoke.hex_piola(ft, degree, curl), chip_smoke.hex_piola(jf, degree, curl)
    pts = RNG.random((8, 3))
    same_element(t, j, pts)
    same_element(ft.FlattenedDimensions(t), jf.FlattenedDimensions(j), pts)
    assert t.space_dimension() == {(False, 1): 6, (False, 2): 36, (True, 1): 12,
                                   (True, 2): 54}[(curl, degree)]


SUMS = {
    "P1 + bubble": lambda m, T: [m.Lagrange(T, 1), m.Bubble(T, T.get_spatial_dimension() + 1)],
    "RT1 + interior RT2": lambda m, T: [m.RaviartThomas(T, 1), m.RestrictedElement(
        m.RaviartThomas(T, 2), restriction_domain="interior")],
    "CR + P0": lambda m, T: [m.CrouzeixRaviart(T, 1), m.DiscontinuousLagrange(T, 0)],
}


@pytest.mark.parametrize("sd", [2, 3])
@pytest.mark.parametrize("name", sorted(SUMS))
def test_simplicial_enriched_sums_match(name, sd):
    t = ft.EnrichedElement(*SUMS[name](ft, tcl.ufc_simplex(sd)))
    j = jfe.EnrichedElement(*SUMS[name](jfe, jcl.ufc_simplex(sd)))
    same_element(t, j, _simplex_points(sd))
    for method in ("get_nodal_basis", "get_coeffs", "dmats"):
        with pytest.raises(NotImplementedError):
            getattr(t, method)()


def test_enriched_refuses_mismatches():
    T, I = tcl.ufc_simplex(2), tcl.ufc_simplex(1)
    with pytest.raises(ValueError, match="reference element"):
        ft.EnrichedElement(ft.Lagrange(T, 1), ft.Lagrange(I, 1))
    with pytest.raises(ValueError, match="mapping"):
        ft.EnrichedElement(ft.RaviartThomas(T, 1), ft.Nedelec(T, 1))
    with pytest.raises(ValueError, match="value shape"):
        ft.EnrichedElement(ft.Lagrange(T, 1), ft.MixedElement([ft.Lagrange(T, 1)] * 2))


# -- QuadratureElement -------------------------------------------------------------

@pytest.mark.parametrize("sd,degree", [(1, 3), (2, 4), (3, 2)])
def test_quadrature_element_matches(sd, degree):
    T, jT = tcl.ufc_simplex(sd), jcl.ufc_simplex(sd)
    pts = ft.create_quadrature(T, degree).get_points()
    t, j = ft.QuadratureElement(T, pts), jfe.QuadratureElement(jT, pts)
    same_element(t, j, pts, order=0)
    assert np.array_equal(t.tabulate(0, pts)[(0,) * sd], np.eye(len(pts)))
    assert t.value_shape() == () and t.is_nodal() and t.get_order() is None


def test_quadrature_element_refusals_match():
    """Derivatives and subentities raise ValueError, other points
    AssertionError, in both packages."""
    for m, c in ((ft, tcl), (jfe, jcl)):
        T = c.ufc_simplex(2)
        pts = ft.create_quadrature(tcl.ufc_simplex(2), 3).get_points()
        el = m.QuadratureElement(T, pts)
        with pytest.raises(ValueError, match="Derivatives"):
            el.tabulate(1, pts)
        with pytest.raises(ValueError, match="subentities"):
            el.tabulate(0, pts, (1, 0))
        with pytest.raises(AssertionError, match="Mismatch"):
            el.tabulate(0, pts + 1e-9)
        with pytest.raises(AssertionError, match="Mismatch"):
            el.tabulate(0, pts[:-1])
        assert set(el.tabulate(0, pts, (2, 0))) == {(0, 0)}


# -- the pointwise dual -----------------------------------------------------------------

@pytest.mark.parametrize("make", ["Lagrange 3 on T", "RaviartThomas 2 on T", "Lagrange 2 on S",
                                  "Serendipity 3 on Q"])
def test_compute_pointwise_dual_matches(make):
    family, degree, _, cell = make.split()
    cells = {"T": 2, "S": 3}
    if cell == "Q":
        t_el = ft.Serendipity(tcl.UFCQuadrilateral(), int(degree))
        j_el = jfe.Serendipity(jcl.UFCQuadrilateral(), int(degree))
        from fiat_tpu_torch.elements.serendipity import unisolvent_pts
        pts = np.asarray(unisolvent_pts(tcl.UFCQuadrilateral(), int(degree)))
    else:
        sd = cells[cell]
        t_el = getattr(ft, family)(tcl.ufc_simplex(sd), int(degree))
        j_el = getattr(jfe, family)(jcl.ufc_simplex(sd), int(degree))
        if family == "Lagrange":
            pts = np.asarray(tcl.make_lattice(tcl.ufc_simplex(sd).get_vertices(), int(degree),
                                              variant="gll"))
        else:   # 4 points, two components each: the 8 functions of RT 2
            pts = _simplex_points(2, t_el.space_dimension() // 2)
    td, jd = t_pointwise_dual(t_el, pts), j_pointwise_dual(j_el, pts)
    assert len(td.nodes) == len(jd.nodes) == t_el.space_dimension()
    for x, y in zip(td.nodes, jd.nodes):
        assert x.pt_dict == y.pt_dict
        assert np.array_equal(x.weights, y.weights) and np.array_equal(x.comps, y.comps)
    assert td.get_entity_ids() == jd.get_entity_ids()
    # the dual is dual to the basis: ell_i(phi_j) = delta_ij
    ncomp, n = max(int(np.prod(t_el.value_shape())), 1), t_el.space_dimension()
    G = np.empty((n, n))
    for i, node in enumerate(td.nodes):
        V = t_el.tabulate(0, node.points)[(0,) * pts.shape[1]].reshape(n, ncomp, -1)
        G[i] = (V[:, node.comps, node.pt_ids] * node.weights).sum(axis=1)
    assert np.abs(G - np.eye(n)).max() <= 1e-10


# -- Bernstein ----------------------------------------------------------------------------

@pytest.mark.parametrize("degree", range(0, 9))
@pytest.mark.parametrize("sd", [1, 2, 3])
def test_bernstein_matches(sd, degree):
    t, j = ft.Bernstein(tcl.ufc_simplex(sd), degree), jfe.Bernstein(jcl.ufc_simplex(sd), degree)
    pts = _simplex_points(sd, 10)
    same_element(t, j, pts, order=degree)
    assert t.degree() == j.degree() and t.value_shape() == ()
    for f in tcl.ufc_simplex(sd).get_topology()[sd - 1]:
        same_element(t, j, RNG.random((4, sd - 1)) / sd, order=1, entity=(sd - 1, f))


@pytest.mark.parametrize("sd,top", sorted(chip_smoke.BERNSTEIN_TOP.items()))
def test_bernstein_table_is_k8s_plain_table(sd, top):
    """The Bernstein element's order-0 table against K8's plain version on
    the CPU, rows permuted by exponent tuple (chip_smoke.bernstein_rows), at
    every degree phase 21 runs."""
    cell = tcl.ufc_simplex(sd)
    x = chip_smoke.make_points(300, 11, np, sd=sd)
    for d in range(1, top + 1):
        feat = BernsteinFeatures(sd, d, _bary_map(cell), device="cpu")
        got = feat.plain(torch.as_tensor(x))[chip_smoke.bernstein_rows(sd, d)].numpy()
        want = ft.Bernstein(cell, d).tabulate(0, x)[(0,) * sd]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= RTOL_BERNSTEIN * np.abs(want).max(), d


# -- orthopoly (tests/test_orthopoly.py) -------------------------------------------------------

def test_orthopoly_rules_match():
    for N, a, b in ((6, 0, 0), (5, 1.0, 0.0), (12, 0, 0), (7, 0.5, 2.0)):
        ta, tb = topq.rec_jacobi(N, a, b)
        ja, jb = jopq.rec_jacobi(N, a, b)
        assert np.array_equal(ta, ja) and np.array_equal(tb, jb)
        for x, y in zip(topq.gauss(ta, tb), jopq.gauss(ja, jb)):
            assert np.array_equal(x, y)
        for x, y in zip(topq.lobatto(ta, tb, -1.0, 1.0), jopq.lobatto(ja, jb, -1.0, 1.0)):
            assert np.array_equal(x, y)
        for x, y in zip(topq.rec_jacobi01(N, a, b), jopq.rec_jacobi01(N, a, b)):
            assert np.array_equal(x, y)
    x = np.linspace(-0.9, 0.9, 7)
    for nopt in (1, 2):
        assert np.array_equal(topq.jacobi(4, 0, 0, x, NOPT=nopt), jopq.jacobi(4, 0, 0, x, NOPT=nopt))
    assert np.array_equal(topq.jacobiD(4, 0, 0, x), jopq.jacobiD(4, 0, 0, x))
    a, b = topq.rec_jacobi(4, 0, 0)
    assert np.array_equal(topq.polyval(a, b, x), jopq.polyval(a, b, x))


def test_gauss_legendre_exactness():
    x, w = topq.gauss(*topq.rec_jacobi(6, 0, 0))
    for p in range(12):
        assert abs(np.sum(w * x ** p) - (1 - (-1) ** (p + 1)) / (p + 1)) < 1e-13


def test_lobatto_endpoints_and_exactness():
    x, w = topq.lobatto(*topq.rec_jacobi(6, 0, 0), -1.0, 1.0)
    assert abs(x[0] + 1) < 1e-13 and abs(x[-1] - 1) < 1e-13
    for p in range(9):
        assert abs(np.sum(w * x ** p) - (1 - (-1) ** (p + 1)) / (p + 1)) < 1e-12


def test_jacobi_orthonormal_and_derivative():
    xg, wg = topq.gauss(*topq.rec_jacobi(12, 0, 0))
    P = topq.jacobi(4, 0, 0, xg, NOPT=2)
    assert np.allclose((P * wg[:, None]).T @ P, np.eye(5), atol=1e-12)
    x, h = np.linspace(-0.9, 0.9, 7), 1e-6
    fd = (topq.jacobi(4, 0, 0, x + h) - topq.jacobi(4, 0, 0, x - h)) / (2 * h)
    assert np.allclose(topq.jacobiD(4, 0, 0, x), fd, atol=1e-7)


@pytest.mark.parametrize("a", [0, 1, 0.5])
def test_log_weight_quadrature_matches(a):
    ta, tb = topq.rec_jaclog(5, a)
    ja, jb = jopq.rec_jaclog(5, a)
    assert np.array_equal(ta, ja) and np.array_equal(tb, jb)
    x, w = topq.gauss(ta, tb)
    for p in range(8):
        assert abs(np.sum(w * x ** p) - 1.0 / (p + a + 1) ** 2) < 1e-12
    assert np.array_equal(topq.mm_log(6, a), jopq.mm_log(6, a))


def test_mod_chebyshev_matches():
    N = 5
    alpham, betam = topq.rec_jacobi01(2 * N, 0, 0)
    mom = np.zeros(2 * N)
    mom[0] = 1.0
    ta, tb = topq.mod_chebyshev(N, mom, alpham, betam)
    ja, jb = jopq.mod_chebyshev(N, mom, alpham, betam)
    assert np.array_equal(ta, ja) and np.array_equal(tb, jb)
    assert np.allclose(ta, alpham[:N], atol=1e-13)
    assert np.allclose(tb[1:], betam[1:N], atol=1e-13)
