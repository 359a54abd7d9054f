"""Morley nonconforming plate element: codim-2 integral averages +
facet-average normal derivatives.  Counterpart of
``fiat_tpu/elements/morley.py``, on the declarative dual builder."""

import math

import numpy as np

from ..core import cells as cl
from ..core import finite_element, functionals, polyset
from ..core.dual_builder import DualBuilder
from ..core.quadrature_schemes import create_quadrature


class Morley(finite_element.CiarletElement):
    """The Morley nonconforming plate element."""

    def __init__(self, ref_el, degree=2):
        if ref_el.get_shape() not in {cl.TRIANGLE, cl.TETRAHEDRON}:
            raise ValueError(
                "Morley only defined on simplices of dimension >= 2")
        if degree != 2:
            raise ValueError("Morley only defined for degree == 2")
        sd = ref_el.get_spatial_dimension()
        b = DualBuilder(ref_el)

        Q_ref = create_quadrature(ref_el.construct_subelement(sd - 2),
                                  degree)
        ones = np.ones(Q_ref.get_weights().shape)
        for e in b.entities(sd - 2):
            b.tag(sd - 2, e, [functionals.IntegralMoment(
                ref_el, b.map_rule(sd - 2, e, Q_ref), ones)])

        Q_ref = create_quadrature(ref_el.construct_subelement(sd - 1),
                                  degree - 1)
        density = np.ones(Q_ref.get_weights().shape) \
            / math.factorial(sd - 1)
        for f in b.entities(sd - 1):
            b.tag(sd - 1, f, [functionals.IntegralMomentOfNormalDerivative(
                ref_el, f, Q_ref, density)])

        super().__init__(polyset.ONPolynomialSet(ref_el, degree),
                         b.dual_set(), degree)
