"""Discontinuous Taylor basis for DG: cell average plus a barycentric
derivative jet.  Counterpart of
``fiat_tpu/elements/discontinuous_taylor.py``, on the declarative dual
builder."""

import numpy as np

from ..core import finite_element, polyset, quadrature
from ..core.dual_builder import DualBuilder
from ..core.functionals import IntegralMoment
from .p0 import P0


class HigherOrderDiscontinuousTaylor(finite_element.CiarletElement):
    """Taylor basis for DG."""

    def __init__(self, ref_el, degree):
        b = DualBuilder(ref_el)
        Q = quadrature.make_quadrature(ref_el, degree + 1)
        b.tag(b.sd, 0, [IntegralMoment(ref_el, Q, np.ones(len(Q.wts)))])
        b.midpoint_jet(1, degree)
        super().__init__(polyset.ONPolynomialSet(ref_el, degree),
                         b.dual_set(), degree, b.sd)


def DiscontinuousTaylor(ref_el, degree):
    return P0(ref_el) if degree == 0 \
        else HigherOrderDiscontinuousTaylor(ref_el, degree)
