"""Gopalakrishnan-Lederer-Schoberl: traceless tensors with continuous
normal-tangential components (MCS Stokes).  Counterpart of
``fiat_tpu/elements/gopalakrishnan_lederer_schoberl.py``, on the
declarative dual builder; a split variant builds the element on the split
complex (``MacroPolynomialSet``)."""

from ..core import expansions, finite_element, polyset
from ..core.dual_builder import DualBuilder
from ..core.macro import MacroPolynomialSet
from ..core.functionals import TensorBidirectionalIntegralMoment
from ..core.variants import check_format_variant
from .restricted import RestrictedElement


def nt_moment_duals(b, degree, scheme):
    """Facet and interior moments of the normal-tangential components,
    one block per facet seen by the entity."""
    sd = b.sd
    facet_of = b.ref_el.get_connectivity()
    for dim in (sd - 1, sd):
        q = degree + sd - 1 - dim
        if q < 0:
            continue
        Q_ref, phis = b.facet_basis(dim, q, degree + q, scheme, scale=1)
        for e in b.entities(dim):
            Q = b.map_rule(dim, e, Q_ref)
            funcs = []
            for f in facet_of[(dim, sd - 1)][e]:
                n = b.ref_el.compute_scaled_normal(f)
                funcs += [TensorBidirectionalIntegralMoment(
                    b.ref_el, t, n, Q, phi)
                    for phi in phis
                    for t in b.ref_el.compute_tangents(sd - 1, f)]
            b.tag(dim, e, funcs)


class GopalakrishnanLedererSchoberlSecondKind(finite_element.CiarletElement):
    """GLS^2(k): traceless polynomials with continuous nt components."""

    def __init__(self, ref_el, degree, variant=None, quad_scheme=None):
        splitting, variant, _ = check_format_variant(variant, degree)
        assert variant == "integral"
        if splitting is not None:
            ref_el = splitting(ref_el)
        if ref_el.is_macrocell():
            poly_set = MacroPolynomialSet(ref_el, type(self)(ref_el.get_parent(), degree))
        else:
            poly_set = polyset.TracelessTensorPolynomialSet(ref_el, degree)
        b = DualBuilder(ref_el)
        nt_moment_duals(b, degree, quad_scheme)
        sd = ref_el.get_spatial_dimension()
        super().__init__(poly_set, b.dual_set(), degree, (1, sd - 1),
                         mapping="covariant contravariant piola")


def GopalakrishnanLedererSchoberlFirstKind(ref_el, degree, variant=None,
                                           quad_scheme=None):
    """GLS^1(k): nt-continuity reduced to degree k-1 (a restriction)."""
    full = GopalakrishnanLedererSchoberlSecondKind(
        ref_el, degree, variant=variant, quad_scheme=quad_scheme)
    dofs = full.entity_dofs()
    sd = ref_el.get_spatial_dimension()
    keep_facet = (sd - 1) * expansions.polynomial_dimension(
        ref_el.construct_subelement(sd - 1), degree - 1)
    keep = [i for f in sorted(dofs[sd - 1])
            for i in dofs[sd - 1][f][:keep_facet]]
    keep += [i for c in sorted(dofs[sd]) for i in dofs[sd][c]]
    return RestrictedElement(full, indices=keep)
