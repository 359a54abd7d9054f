"""Hu-Zhang elasticity: symmetric tensors of degree >= 3 on triangles
with vertex values, edge nn/nt dofs, and interior moments.  Counterpart
of ``fiat_tpu/elements/hu_zhang.py``, on the declarative dual builder."""

from ..core import cells as cl
from ..core import finite_element, polyset
from ..core.dual_builder import DualBuilder
from ..core.functionals import (ComponentPointEvaluation,
                                PointwiseInnerProductEvaluation,
                                TensorBidirectionalIntegralMoment)
from ..core.variants import check_format_variant


def _sym_components(sd):
    return [(i, j) for i in range(sd) for j in range(i, sd)]


def hz_duals(b, degree, variant, scheme):
    sd = b.sd
    shp = (sd, sd)
    for v in b.entities(0):
        pt, = b.lattice(0, v, degree)
        b.tag(0, v, (ComponentPointEvaluation(b.ref_el, c, shp, pt)
                     for c in _sym_components(sd)))

    if variant == "integral":
        Q_ref, phis = b.facet_basis(sd - 1, degree - 2, 2 * degree - 2,
                                    scheme)
    for e in b.entities(1):
        n = b.ref_el.compute_scaled_normal(e)
        t = b.ref_el.compute_edge_tangent(e)
        if variant == "point":
            b.tag(1, e, (PointwiseInnerProductEvaluation(b.ref_el, n, s, p)
                         for p in b.lattice(1, e, degree) for s in (n, t)))
        else:
            Q = b.map_rule(1, e, Q_ref)
            b.tag(1, e, (TensorBidirectionalIntegralMoment(
                b.ref_el, n, s, Q, phi) for phi in phis for s in (n, t)))

    if variant == "point":
        for c in b.entities(sd):
            b.tag(sd, c, (ComponentPointEvaluation(b.ref_el, comp, shp, p)
                          for p in b.lattice(sd, c, degree + 1)
                          for comp in _sym_components(sd)))
    else:
        Q_ref, phis = b.facet_basis(sd, degree - 2, 2 * degree - 2,
                                    scheme, scale=1)
        for c in b.entities(sd):
            faces = b.ref_el.get_connectivity()[(sd, sd - 1)][c]
            n = [b.ref_el.compute_scaled_normal(f) for f in faces]
            Q = b.map_rule(sd, c, Q_ref)
            b.tag(sd, c, (TensorBidirectionalIntegralMoment(
                b.ref_el, n[i + 1], n[j + 1], Q, phi)
                for phi in phis for (i, j) in _sym_components(sd)))


class HuZhang(finite_element.CiarletElement):
    """The Hu-Zhang element."""

    def __init__(self, ref_el, degree=3, variant=None, quad_scheme=None):
        if degree < 3:
            raise ValueError("HuZhang only defined for degree >= 3")
        if ref_el.shape != cl.TRIANGLE:
            raise ValueError("HuZhang only defined on triangles")
        splitting, variant, qdegree = check_format_variant(variant, degree)
        if splitting is not None:
            raise NotImplementedError(
                "HuZhang is not implemented as a macroelement.")
        b = DualBuilder(ref_el)
        hz_duals(b, degree, variant, quad_scheme)
        super().__init__(polyset.ONSymTensorPolynomialSet(ref_el, degree),
                         b.dual_set(), degree,
                         ref_el.get_spatial_dimension() - 1,
                         mapping="double contravariant piola")
