"""Generalized Regge: symmetric tensors with tangential-tangential
continuity.  Counterpart of ``fiat_tpu/elements/regge.py``, on the
declarative dual builder; a split variant builds the element on the split
complex (``MacroPolynomialSet``)."""

from ..core import finite_element, polyset
from ..core.dual_builder import DualBuilder
from ..core.macro import MacroPolynomialSet
from ..core.functionals import (PointwiseInnerProductEvaluation,
                                TensorBidirectionalIntegralMoment)
from ..core.variants import check_format_variant


def tt_duals(b, degree, variant, qdegree, scheme):
    """Tangential-tangential dofs on every subentity: inner products
    against each face-edge tangent pair, pointwise or moment-wise."""
    for dim in sorted(b.top):
        if variant == "point":
            for e in b.entities(dim):
                ts = b.ref_el.compute_face_edge_tangents(dim, e)
                b.tag(dim, e, (PointwiseInnerProductEvaluation(
                    b.ref_el, t, t, p)
                    for p in b.lattice(dim, e, degree + 2) for t in ts))
        else:
            k = degree - dim + 1
            if dim == 0 or k < 0:
                continue
            Q_ref, phis = b.facet_basis(dim, k, qdegree + k, scheme)
            for e in b.entities(dim):
                ts = b.ref_el.compute_face_edge_tangents(dim, e)
                Q = b.map_rule(dim, e, Q_ref)
                b.tag(dim, e, (TensorBidirectionalIntegralMoment(
                    b.ref_el, t, t, Q, phi) for phi in phis for t in ts))


class Regge(finite_element.CiarletElement):
    """REG(k): symmetric tensor polynomials with t-t continuity."""

    def __init__(self, ref_el, degree=0, variant=None, quad_scheme=None):
        if degree < 0:
            raise ValueError("Regge only defined for degree >= 0")
        splitting, variant, qdegree = check_format_variant(variant, degree)
        if splitting is not None:
            ref_el = splitting(ref_el)
        if ref_el.is_macrocell():
            poly_set = MacroPolynomialSet(ref_el, type(self)(ref_el.get_parent(), degree))
        else:
            poly_set = polyset.ONSymTensorPolynomialSet(ref_el, degree)
        b = DualBuilder(ref_el)
        tt_duals(b, degree, variant, qdegree, quad_scheme)
        super().__init__(poly_set, b.dual_set(), degree, (1, 1),
                         mapping="double covariant piola")
