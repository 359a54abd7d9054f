"""Triangular C2 elements: Bramble-Zlamal (degree-9 polynomials) and
AlfeldC2 (quintic C2 spline on a double Alfeld split).  Counterpart of
``fiat_tpu/elements/c2_elements.py``, on the declarative dual builder."""

from ..core import cells as cl
from ..core import finite_element, polyset
from ..core.dual_builder import DualBuilder
from ..core.functionals import IntegralMoment, IntegralMomentOfDerivative
from ..core.jacobi import eval_jacobi_batch, eval_jacobi_deriv_batch
from ..core.macro import AlfeldSplit, CkPolynomialSet
from ..core.variants import parse_quadrature_scheme


def c2_duals(ref_complex, degree, vorder=None, reduced=False,
             quad_scheme=None):
    """Vertex vorder-jets + graded Jacobi edge moments (value/dn/dnn) +
    interior moments (C4 at vertices for polynomials, C2 for macro)."""
    if vorder is None:
        vorder = 2 if ref_complex.is_macrocell() else 4
    if degree < 2 * vorder + 1:
        raise ValueError(f"C2 elements need degree >= {2 * vorder + 1}")
    if reduced:
        raise NotImplementedError
    ref_el = ref_complex.get_parent() or ref_complex
    if ref_el.get_shape() != cl.TRIANGLE:
        raise ValueError("C2 elements only defined on triangles")

    b = DualBuilder(ref_el)
    b.vertex_jets(vorder)

    k = degree - 2 * vorder
    line = cl.ufc_simplex(1)
    Q_ref = parse_quadrature_scheme(line, degree - 2 + k, quad_scheme)
    s = line.compute_barycentric_coordinates(Q_ref.get_points())
    s = s[:, [1]] - s[:, [0]]
    jac = eval_jacobi_batch(vorder, vorder, k, s)
    djac = 2 * eval_jacobi_deriv_batch(vorder, vorder, k, s, order=1)
    ddjac = 4 * eval_jacobi_deriv_batch(vorder, vorder, k, s, order=2)
    for e in b.entities(1):
        Q = b.map_rule(1, e, Q_ref)
        n = ref_el.compute_normal(e)
        b.tag(1, e, [IntegralMoment(ref_el, Q, phi) for phi in ddjac[2:]]
                    + [IntegralMomentOfDerivative(ref_el, Q, phi, n)
                       for phi in djac[1:]]
                    + [IntegralMomentOfDerivative(ref_el, Q, phi, n, n)
                       for phi in jac])

    q = degree - 3 * (vorder // 2 + 1)
    if q >= 0:
        Q = parse_quadrature_scheme(ref_complex, degree + q, quad_scheme)
        tests = polyset.ONPolynomialSet(ref_el, q, scale=1)
        phis = tests.tabulate(Q.get_points())[(0,) * b.sd]
        b.tag(b.sd, 0, (IntegralMoment(ref_el, Q, phi / ref_el.volume())
                        for phi in phis))
    return b.dual_set()


class BrambleZlamalC2(finite_element.CiarletElement):
    """The Bramble-Zlamal C2 element (degree-9 polynomials)."""

    def __init__(self, ref_el, degree=9, reduced=False, quad_scheme=None):
        dual = c2_duals(ref_el, degree, reduced=reduced,
                        quad_scheme=quad_scheme)
        super().__init__(polyset.ONPolynomialSet(ref_el, degree), dual,
                         degree, formdegree=0)


def AlfeldC2Space(ref_el, degree):
    """The C2 spline space on the double Alfeld split (Lai & Schumaker
    Section 7.5 for the quintic case)."""
    ref_complex = AlfeldSplit(AlfeldSplit(ref_el))
    smoothness = {
        1: {**dict.fromkeys(ref_complex.get_interior_facets(1), 2),
            **dict.fromkeys(range(3, 6), degree - 2)},
        0: {**dict.fromkeys(ref_complex.get_interior_facets(0), degree - 1),
            3: degree - 2},
    }
    return CkPolynomialSet(ref_complex, degree, order=smoothness,
                           variant="bubble")


class AlfeldC2(finite_element.CiarletElement):
    """The Alfeld C2 macroelement on a double barycentric split."""

    def __init__(self, ref_el, degree=5, reduced=False, quad_scheme=None):
        poly_set = AlfeldC2Space(ref_el, degree)
        dual = c2_duals(poly_set.get_reference_element(), degree,
                        reduced=reduced, quad_scheme=quad_scheme)
        super().__init__(poly_set, dual, degree, formdegree=0)
