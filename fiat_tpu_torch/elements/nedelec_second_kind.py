"""Second-kind Nedelec H(curl): full (P_k)^d with edge tangent evaluations
and facet/cell RT moments.  Counterpart of
``fiat_tpu/elements/nedelec_second_kind.py``, on the declarative dual
builder; a split variant builds the element on the split complex
(``MacroPolynomialSet``)."""

import numpy as np

from ..core.dual_builder import DualBuilder
from ..core.finite_element import CiarletElement
from ..core.functionals import (FrobeniusIntegralMoment,
                                PointEdgeTangentEvaluation)
from ..core.macro import MacroPolynomialSet
from ..core.polyset import ONPolynomialSet
from ..core.variants import check_format_variant, parse_quadrature_scheme
from .raviart_thomas import RaviartThomas


def n2_rt_moment_duals(b, dim, degree, variant, qdegree, scheme):
    """Moments against a Piola-mapped RT basis on every entity of one
    dimension (a vector P on edges, where RT degenerates)."""
    rt_degree = degree - dim + 1
    if rt_degree < 1:
        return
    facet = b.ref_el.construct_subelement(dim)
    Q_ref = parse_quadrature_scheme(facet, qdegree + rt_degree, scheme)
    if dim == 1:
        basis = ONPolynomialSet(facet, rt_degree, (dim,))
    else:
        basis = RaviartThomas(facet, rt_degree, variant).get_nodal_basis()
    tab = np.transpose(basis.tabulate(Q_ref.get_points())[(0,) * dim],
                       (0, 2, 1))
    for e in b.entities(dim):
        Q = b.map_rule(dim, e, Q_ref, avg=False)
        piola = Q.jacobian() / Q.jacobian_determinant()
        mapped = np.transpose(tab @ piola.T, (0, 2, 1))
        b.tag(dim, e, (FrobeniusIntegralMoment(b.ref_el, Q, phi)
                       for phi in mapped))


class NedelecSecondKind(CiarletElement):
    """Second-kind Nedelec element (covariant Piola)."""

    def __init__(self, ref_el, degree, variant=None, quad_scheme=None):
        splitting, variant, qdegree = check_format_variant(variant, degree)
        if splitting is not None:
            ref_el = splitting(ref_el)
        if degree < 1:
            raise ValueError("Second-kind Nedelecs start at 1!")
        sd = ref_el.get_spatial_dimension()
        if sd not in (2, 3):
            raise ValueError(
                "Second-kind Nedelecs only implemented in 2/3D.")
        if ref_el.is_macrocell():
            poly_set = MacroPolynomialSet(ref_el, type(self)(ref_el.get_parent(), degree))
        else:
            poly_set = ONPolynomialSet(ref_el, degree, (sd,))

        b = DualBuilder(ref_el)
        if qdegree is None:
            qdegree = degree
        if variant == "integral":
            n2_rt_moment_duals(b, 1, degree, variant, qdegree, quad_scheme)
        else:
            for e in b.entities(1):
                b.tag(1, e, (PointEdgeTangentEvaluation(ref_el, e, p)
                             for p in b.lattice(1, e, degree + 2)))
        for dim in range(2, sd + 1):
            n2_rt_moment_duals(b, dim, degree, variant, qdegree,
                               quad_scheme)
        super().__init__(poly_set, b.dual_set(), degree, 1, mapping="covariant piola")
