"""Crouzeix-Raviart: nonconforming P_k (odd degree) with facet
barycentre/moment dofs.  Counterpart of
``fiat_tpu/elements/crouzeix_raviart.py``, on the declarative dual builder;
a split variant builds the element on the split complex
(``MacroPolynomialSet``)."""

import numpy as np

from ..core import finite_element, functionals, polyset
from ..core.dual_builder import DualBuilder
from ..core.macro import MacroPolynomialSet
from ..core.variants import check_format_variant, parse_quadrature_scheme


def cr_moment_duals(b, degree, qdegree, scheme):
    """Facet moments of P_{k-1}, lower-entity moments of P_{k-1-dim},
    vertex averages when vertices are facets (1D)."""
    sd = b.sd
    for dim in sorted(b.top):
        if dim == 0 and dim != sd - 1:
            continue
        facet = b.ref_el.construct_subelement(dim)
        if dim == 0:
            Q_ref = parse_quadrature_scheme(facet, degree + qdegree - 1,
                                            scheme)
            phis = np.ones((1, len(Q_ref.pts)))
        else:
            k = degree - 1 if dim == sd - 1 else degree - 1 - dim
            if k < 0:
                continue
            Q_ref, phis = b.facet_basis(dim, k, k + qdegree, scheme)
        for e in b.entities(dim):
            b.tag(dim, e, (functionals.IntegralMoment(
                b.ref_el, b.map_rule(dim, e, Q_ref), phi) for phi in phis))


def cr_point_duals(b, degree):
    """Gauss points inside facets, GLL lattices on lower entities."""
    sd = b.sd
    for dim in sorted(b.top):
        if dim == 0 and dim != sd - 1:
            continue
        for e in b.entities(dim):
            if dim == sd - 1 and dim != 0:
                pts = b.lattice(dim, e, degree - 1, variant="gl", interior=0)
            else:
                pts = b.lattice(dim, e, degree, variant="gll")
            b.tag(dim, e, (functionals.PointEvaluation(b.ref_el, x)
                           for x in pts))


class CrouzeixRaviart(finite_element.CiarletElement):
    """Nonconforming P_k with facet moment/point dofs (odd degree)."""

    def __init__(self, ref_el, degree, variant=None, quad_scheme=None):
        if degree % 2 != 1:
            raise ValueError("Crouzeix-Raviart only defined for odd degree")
        splitting, variant, qdegree = check_format_variant(variant, degree)
        if splitting is not None:
            ref_el = splitting(ref_el)
        if degree > 1 and ref_el.get_spatial_dimension() != 2:
            raise NotImplementedError(
                "High-order Crouzeix-Raviart is only implemented on "
                "triangles.")
        if ref_el.is_macrocell():
            poly_set = MacroPolynomialSet(ref_el, type(self)(ref_el.get_parent(), degree))
        else:
            poly_set = polyset.ONPolynomialSet(ref_el, degree)
        b = DualBuilder(ref_el)
        if variant == "integral":
            cr_moment_duals(b, degree, qdegree, quad_scheme)
        else:
            cr_point_duals(b, degree)
        super().__init__(poly_set, b.dual_set(), degree)
