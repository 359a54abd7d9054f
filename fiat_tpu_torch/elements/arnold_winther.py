"""Arnold-Winther elasticity elements: symmetric-tensor spaces with
normal-normal / normal-tangential Legendre edge moments, conforming at
degree 3 and nonconforming at degree 2, each carrying trailing
constraint functionals.  Counterpart of
``fiat_tpu/elements/arnold_winther.py``: dual builder programs over two
shared generators (the Legendre edge pairs and the upper-triangle
n_i n_j cell moments).
"""

import numpy as np

from ..core import cells as cl
from ..core import finite_element, polyset
from ..core.dual_builder import DualBuilder
from ..core.functionals import (ComponentPointEvaluation,
                                IntegralLegendreNormalNormalMoment,
                                IntegralLegendreNormalTangentialMoment,
                                IntegralMomentOfTensorDivergence,
                                TensorBidirectionalIntegralMoment)
from ..core.quadrature_schemes import create_quadrature


def _edge_pairs(ref_el, entity, orders, qdegree):
    """Interleaved (nn, nt) Legendre moments of the given orders."""
    for k in orders:
        yield IntegralLegendreNormalNormalMoment(ref_el, entity, k, qdegree)
        yield IntegralLegendreNormalTangentialMoment(ref_el, entity, k,
                                                     qdegree)


def _cell_tensor_moments(ref_el, Q, weights):
    """n_i n_j : sigma moments over the cell, upper triangle of the
    scaled facet normals, one triple per weight function."""
    sd = ref_el.get_spatial_dimension()
    n = [ref_el.compute_scaled_normal(f)
         for f in sorted(ref_el.get_topology()[sd - 1])]
    return (TensorBidirectionalIntegralMoment(ref_el, n[i + 1], n[j + 1],
                                              Q, phi)
            for phi in weights for i in range(sd) for j in range(i, sd))


class ArnoldWintherNC(finite_element.CiarletElement):
    """The nonconforming Arnold-Winther element."""

    def __init__(self, ref_el, degree=2):
        if ref_el.shape != cl.TRIANGLE:
            raise ValueError("ArnoldWintherNC only defined on triangles")
        if degree != 2:
            raise ValueError("Nonconforming Arnold-Winther is degree 2 "
                             "only.")
        sd = ref_el.get_spatial_dimension()
        qdegree = degree + 2

        b = DualBuilder(ref_el)
        for e in b.entities(1):
            b.tag(1, e, _edge_pairs(ref_el, e, range(2), qdegree))
        Q = create_quadrature(ref_el, degree)
        flat = [np.full(Q.get_weights().shape, 1 / ref_el.volume())]
        b.tag(sd, 0, _cell_tensor_moments(ref_el, Q, flat))
        # constraint functionals come last: order-2 nn moment per edge
        for e in b.entities(1):
            b.tag(1, e, [IntegralLegendreNormalNormalMoment(
                ref_el, e, 2, qdegree)])

        super().__init__(polyset.ONSymTensorPolynomialSet(ref_el, degree),
                         b.dual_set(), degree, sd - 1,
                         mapping="double contravariant piola")


class ArnoldWinther(finite_element.CiarletElement):
    """The conforming Arnold-Winther element."""

    def __init__(self, ref_el, degree=3):
        if ref_el.shape != cl.TRIANGLE:
            raise ValueError("ArnoldWinther only defined on triangles")
        if degree != 3:
            raise ValueError("Arnold-Winther is degree 3 only.")
        sd = ref_el.get_spatial_dimension()
        shp = (sd, sd)

        b = DualBuilder(ref_el)
        for v in b.entities(0):
            pt, = b.lattice(0, v, degree)
            b.tag(0, v, (ComponentPointEvaluation(ref_el, (i, j), shp, pt)
                         for i in range(sd) for j in range(i, sd)))
        orders = range(degree - 1)
        qdegree = 2 * degree - 2
        for e in b.entities(1):
            b.tag(1, e, _edge_pairs(ref_el, e, orders, qdegree))

        # as fiat_tpu (after FIAT), the LAST edge's dofs are credited to the
        # cell interior too
        b.also_tag(sd, 0, b.ids_of(1, max(b.entities(1))))

        Q = create_quadrature(ref_el, 2 * (degree - 1))
        P = polyset.ONPolynomialSet(ref_el, degree - 3, scale="L2 piola")
        phis = P.tabulate(Q.get_points())[(0,) * sd]
        b.tag(sd, 0, _cell_tensor_moments(ref_el, Q, phis))

        # constraint functionals: divergence moments against the top
        # degree-(k-1) vector modes (P_{k-1} minus P_{k-2}, per component)
        V = polyset.ONPolynomialSet(ref_el, degree - 1, shape=(sd,))
        lo = V.expansion_set.get_num_members(degree - 2)
        hi = V.expansion_set.get_num_members(degree - 1)
        top = V.take([i + j * hi for j in range(sd) for i in range(lo, hi)])
        b.tag(sd, 0, (IntegralMomentOfTensorDivergence(ref_el, Q, phi)
                      for phi in top.tabulate(Q.get_points())[(0,) * sd]))

        super().__init__(polyset.ONSymTensorPolynomialSet(ref_el, degree),
                         b.dual_set(), degree, sd - 1,
                         mapping="double contravariant piola")
