"""Argyris: quintic (or higher, integral variant) C1 triangle.  Vertex
2-jets plus edge normal-derivative/value moments.  Counterpart of
``fiat_tpu/elements/argyris.py``, on the declarative dual builder."""

from ..core import cells as cl
from ..core import finite_element, polyset
from ..core.dual_builder import DualBuilder
from ..core.functionals import (IntegralMoment, IntegralMomentOfDerivative,
                                PointEvaluation, PointNormalDerivative)
from ..core.jacobi import eval_jacobi_batch, eval_jacobi_deriv_batch
from ..core.variants import check_format_variant, parse_quadrature_scheme


def jacobi_edge_duals(b, degree, qdegree, scheme):
    """Per edge: normal-derivative moments against P_{2,2} Jacobi
    polynomials, plus value moments against their derivatives (skipping
    the constant)."""
    k = degree - 5
    line = cl.ufc_simplex(1)
    Q_ref = parse_quadrature_scheme(line, qdegree + k - 1, scheme)
    s = line.compute_barycentric_coordinates(Q_ref.get_points())
    s = s[:, [1]] - s[:, [0]]
    jac = eval_jacobi_batch(2, 2, k, s)
    djac = 2 * eval_jacobi_deriv_batch(2, 2, k, s)
    for e in b.entities(1):
        Q = b.map_rule(1, e, Q_ref)
        normal = b.ref_el.compute_normal(e)
        b.tag(1, e, [IntegralMomentOfDerivative(b.ref_el, Q, phi, normal)
                     for phi in jac]
                    + [IntegralMoment(b.ref_el, Q, dphi)
                       for dphi in djac[1:]])


class Argyris(finite_element.CiarletElement):
    """The Argyris element (variant 'point' | 'integral' | 'integral(q)')."""

    def __init__(self, ref_el, degree=5, variant=None, quad_scheme=None):
        if ref_el.get_shape() != cl.TRIANGLE:
            raise ValueError("Argyris only defined on triangles")
        splitting, variant, qdegree = check_format_variant(variant, degree)
        if splitting is not None:
            raise NotImplementedError("Argyris is not implemented as a macroelement.")

        b = DualBuilder(ref_el)
        b.vertex_jets(2)
        if variant == "integral":
            jacobi_edge_duals(b, degree, qdegree, quad_scheme)
            if degree >= 6:
                b.interior_moments(degree - 6, qdegree + degree - 6,
                                   scheme=quad_scheme, scale=1)
        elif variant == "point":
            for e in b.entities(1):
                b.tag(1, e, [PointNormalDerivative(ref_el, e, p)
                             for p in b.lattice(1, e, degree - 3)]
                            + [PointEvaluation(ref_el, p)
                               for p in b.lattice(1, e, degree - 4)])
            if degree > 5:
                b.point_evals(2, 0, degree - 3)
        else:
            raise ValueError("Invalid variant for Argyris")

        poly_set = polyset.ONPolynomialSet(ref_el, degree, variant="bubble")
        super().__init__(poly_set, b.dual_set(), degree)
