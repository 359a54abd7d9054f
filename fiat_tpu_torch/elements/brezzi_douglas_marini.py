"""Brezzi-Douglas-Marini H(div): full (P_k)^d with scaled-normal facet
moments and interior Nedelec moments.  Counterpart of
``fiat_tpu/elements/brezzi_douglas_marini.py``, on the declarative dual
builder; a split variant builds the element on the split complex
(``MacroPolynomialSet``)."""

import numpy as np

from ..core import finite_element, functionals, polyset
from ..core.dual_builder import DualBuilder
from ..core.macro import MacroPolynomialSet
from ..core.variants import check_format_variant, parse_quadrature_scheme
from .nedelec import Nedelec


def bdm_facet_duals(b, degree, variant, qdegree, scheme):
    sd = b.sd
    if variant == "integral":
        Q_ref, phis = b.facet_basis(sd - 1, degree, qdegree + degree,
                                    scheme)
        for f in b.entities(sd - 1):
            n = b.ref_el.compute_scaled_normal(f)
            weighted = n[None, :, None] * phis[:, None, :]
            b.tag(sd - 1, f, (functionals.FrobeniusIntegralMoment(
                b.ref_el, b.map_rule(sd - 1, f, Q_ref), phi)
                for phi in weighted))
    else:
        for f in b.entities(sd - 1):
            b.tag(sd - 1, f, (functionals.PointScaledNormalEvaluation(
                b.ref_el, f, p)
                for p in b.lattice(sd - 1, f, sd + degree)))


def bdm_interior_duals(b, degree, variant, qdegree, scheme):
    """Moments against a pulled-back Nedelec_{k-1} basis."""
    sd = b.sd
    cell = b.ref_el.construct_subelement(sd)
    Q_ref = parse_quadrature_scheme(cell, qdegree + degree - 1, scheme)
    ned = Nedelec(cell, degree - 1, variant)
    tab = ned.tabulate(0, Q_ref.get_points())[(0,) * sd]
    for c in b.entities(sd):
        Q = b.map_rule(sd, c, Q_ref, avg=False)
        Jinv = np.linalg.inv(Q.jacobian())
        pulled = np.tensordot(Jinv.T, tab, (1, 1)).transpose((1, 0, 2))
        b.tag(sd, c, (functionals.FrobeniusIntegralMoment(b.ref_el, Q, phi)
                      for phi in pulled))


class BrezziDouglasMarini(finite_element.CiarletElement):
    """The BDM element (contravariant Piola)."""

    def __init__(self, ref_el, degree, variant=None, quad_scheme=None):
        splitting, variant, qdegree = check_format_variant(variant, degree)
        if splitting is not None:
            ref_el = splitting(ref_el)
        if degree < 1:
            raise ValueError("BDM_k elements are only valid for k >= 1")
        sd = ref_el.get_spatial_dimension()
        if ref_el.is_macrocell():
            poly_set = MacroPolynomialSet(ref_el, type(self)(ref_el.get_parent(), degree))
        else:
            poly_set = polyset.ONPolynomialSet(ref_el, degree, (sd,))

        b = DualBuilder(ref_el)
        bdm_facet_duals(b, degree, variant, qdegree, quad_scheme)
        if degree > 1:
            bdm_interior_duals(b, degree, variant,
                               degree if qdegree is None else qdegree,
                               quad_scheme)
        super().__init__(poly_set, b.dual_set(), degree, sd - 1,
                         mapping="contravariant piola")
