"""Hellan-Herrmann-Johnson: symmetric tensors with normal-normal
continuity.  Counterpart of
``fiat_tpu/elements/hellan_herrmann_johnson.py``, on the declarative dual
builder; a split variant builds the element on the split complex
(``MacroPolynomialSet``)."""

from ..core import finite_element, polyset
from ..core.dual_builder import DualBuilder
from ..core.macro import MacroPolynomialSet
from ..core.functionals import (ComponentPointEvaluation,
                                PointwiseInnerProductEvaluation,
                                TensorBidirectionalIntegralMoment)
from ..core.variants import check_format_variant


def nn_point_duals(b, degree, normals, cell_faces):
    """Pointwise n-n facet dofs; interior dofs are Cartesian components
    in 2D and face-pair inner products in 3D."""
    sd = b.sd
    for f in b.entities(sd - 1):
        b.tag(sd - 1, f, (PointwiseInnerProductEvaluation(
            b.ref_el, normals[f], normals[f], p)
            for p in b.lattice(sd - 1, f, degree + sd)))
    for c in b.entities(sd):
        pts = b.lattice(sd, c, degree + sd)
        if sd == 2:
            b.tag(sd, c, (ComponentPointEvaluation(
                b.ref_el, (i, j), (sd, sd), p)
                for i in range(sd) for j in range(i, sd) for p in pts))
        else:
            faces = cell_faces[c]
            extra = b.lattice(sd, c, degree + sd + 1)
            b.tag(sd, c, [PointwiseInnerProductEvaluation(
                b.ref_el, normals[f], normals[f], p)
                for p in pts for f in faces]
                + [PointwiseInnerProductEvaluation(
                    b.ref_el, normals[faces[i + 1]], normals[faces[i + 2]], p)
                   for p in extra for i in range((sd - 1) * (sd - 2))])


def nn_moment_duals(b, degree, qdegree, scheme, normals, cell_faces):
    """Moment-based n-n dofs: facet moments of P_degree, plus interior
    moments that keep n-n parts to degree-1 and add the mixed face-pair
    parts in 3D."""
    sd = b.sd
    Q_ref, phis = b.facet_basis(sd - 1, degree, qdegree + degree, scheme)
    for f in b.entities(sd - 1):
        Q = b.map_rule(sd - 1, f, Q_ref)
        b.tag(sd - 1, f, (TensorBidirectionalIntegralMoment(
            b.ref_el, normals[f], normals[f], Q, phi) for phi in phis))

    Q_ref, phis = b.facet_basis(sd, degree, qdegree + degree, scheme)
    cell = b.ref_el.construct_subelement(sd)
    npkm1 = polyset.ONPolynomialSet(cell, degree).expansion_set \
        .get_num_members(degree - 1)
    for c in b.entities(sd):
        faces = cell_faces[c]
        Q = b.map_rule(sd, c, Q_ref)
        b.tag(sd, c, [TensorBidirectionalIntegralMoment(
            b.ref_el, normals[f], normals[f], Q, phi)
            for phi in phis[:npkm1] for f in faces]
            + [TensorBidirectionalIntegralMoment(
                b.ref_el, normals[faces[i + 1]], normals[faces[i + 2]],
                Q, phi)
               for phi in phis for i in range((sd - 1) * (sd - 2))])


class HellanHerrmannJohnson(finite_element.CiarletElement):
    """HHJ(k): symmetric tensor polynomials with n-n continuity."""

    def __init__(self, ref_el, degree=0, variant=None, quad_scheme=None):
        if degree < 0:
            raise ValueError("HHJ only defined for degree >= 0")
        splitting, variant, qdegree = check_format_variant(variant, degree)
        if splitting is not None:
            ref_el = splitting(ref_el)
        if ref_el.is_macrocell():
            poly_set = MacroPolynomialSet(ref_el, type(self)(ref_el.get_parent(), degree))
        else:
            poly_set = polyset.ONSymTensorPolynomialSet(ref_el, degree)
        sd = ref_el.get_spatial_dimension()
        b = DualBuilder(ref_el)
        normals = [ref_el.compute_scaled_normal(f)
                   for f in b.entities(sd - 1)]
        cell_faces = ref_el.get_connectivity()[(sd, sd - 1)]
        if variant == "point":
            nn_point_duals(b, degree, normals, cell_faces)
        else:
            nn_moment_duals(b, degree, qdegree, quad_scheme, normals,
                            cell_faces)
        super().__init__(poly_set, b.dual_set(), degree, (sd - 1, sd - 1),
                         mapping="double contravariant piola")
