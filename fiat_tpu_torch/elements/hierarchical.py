"""Hierarchical Legendre / IntegratedLegendre elements: modal bases with
L2-dual moment DoFs, on the declarative dual builder.  Counterpart of
``fiat_tpu/elements/hierarchical.py``."""

import numpy as np

from ..core import finite_element
from ..core.cells import symmetric_simplex
from ..core.dual_builder import DualBuilder
from ..core.functionals import IntegralMoment
from ..core.polyset import ONPolynomialSet, make_bubbles
from ..core.variants import check_format_variant, parse_quadrature_scheme
from .p0 import P0


def make_dual_bubbles(ref_el, degree, codim=0, interpolant_deg=None,
                      quad_scheme=None, scale="orthonormal"):
    """Tabulate the L2-duals of the hierarchical C0 basis at quadrature
    points: solve the bubble mass matrix against the bubble tabulation."""
    if ref_el.get_spatial_dimension() == 0:
        degree, quad_scheme = 0, None
    qdeg = degree + (degree if interpolant_deg is None else interpolant_deg)
    Q = parse_quadrature_scheme(ref_el, qdeg, quad_scheme)
    B = make_bubbles(ref_el, degree, codim=codim, scale=scale)
    P = B.expansion_set.tabulate(degree, Q.get_points())
    duals = np.linalg.solve((P * Q.get_weights()) @ P.T, P)
    return Q, B.get_coeffs() @ duals


def _split_cell(ref_el, variant, degree):
    splitting, variant, interpolant_deg = check_format_variant(variant, degree)
    if splitting is not None:
        ref_el = splitting(ref_el)
    return ref_el, interpolant_deg


class Legendre(finite_element.CiarletElement):
    """Discontinuous modal Legendre element: interior moments against the
    L2-Piola-scaled orthonormal basis."""

    def __new__(cls, ref_el, degree, variant=None, quad_scheme=None):
        if degree == 0:
            splitting, _, interpolant_deg = check_format_variant(variant, degree)
            if splitting is None and interpolant_deg == 0:
                return P0(ref_el)
        return super().__new__(cls)

    def __init__(self, ref_el, degree, variant=None, quad_scheme=None):
        ref_el, interpolant_deg = _split_cell(ref_el, variant, degree)
        b = DualBuilder(ref_el)
        b.interior_moments(degree, degree + interpolant_deg,
                           scheme=quad_scheme, scale="L2 piola")
        super().__init__(ONPolynomialSet(ref_el, degree), b.dual_set(),
                         degree, formdegree=ref_el.get_spatial_dimension())


class IntegratedLegendre(finite_element.CiarletElement):
    """Continuous hierarchical element with integrated Legendre basis:
    per-entity moments against L2-duals of the C0 bubbles, built on
    symmetric reference facets."""

    def __init__(self, ref_el, degree, variant=None, quad_scheme=None):
        if degree < 1:
            raise ValueError("IntegratedLegendre elements only valid for k >= 1")
        ref_el, interpolant_deg = _split_cell(ref_el, variant, degree)
        b = DualBuilder(ref_el)
        for dim in sorted(b.top):
            if degree <= dim:
                continue
            Q_ref, phis = make_dual_bubbles(
                symmetric_simplex(dim), degree,
                interpolant_deg=interpolant_deg, quad_scheme=quad_scheme)
            for e in b.entities(dim):
                Q = b.map_rule(dim, e, Q_ref)
                b.tag(dim, e, (IntegralMoment(ref_el, Q, phi)
                               for phi in phis))
        super().__init__(ONPolynomialSet(ref_el, degree, variant="bubble"),
                         b.dual_set(), degree, formdegree=0)
