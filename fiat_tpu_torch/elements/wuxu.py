"""Wu-Xu H3-nonconforming elements: P3 + bubble*P1 (+ bubble^2*P1 for
the robust variant) with vertex 1-jets and edge normal-derivative
averages.  Counterpart of ``fiat_tpu/elements/wuxu.py``, on the
declarative dual builder."""

import numpy as np

from ..core import expansions, finite_element, polyset
from ..core.dual_builder import DualBuilder
from ..core.functionals import IntegralMomentOfDerivative
from ..core.quadrature_schemes import create_quadrature
from .bubble import Bubble
from .lagrange import Lagrange


def WuXuH3NCSpace(ref_el, robust=False):
    """P3 + b_T P1 (+ b_T^2 P1 for the robust variant), as weighted
    moments of the embedding ON basis."""
    sd = ref_el.get_spatial_dimension()
    assert sd == 2
    k = 7 if robust else 4
    pk = polyset.ONPolynomialSet(ref_el, k)
    dims = [expansions.polynomial_dimension(ref_el, d) for d in (1, 3, k)]
    dimp1, dimp3, dimpk = dims

    Q = create_quadrature(ref_el, 2 * k)
    qpts, qwts = Q.get_points(), Q.get_weights()
    hat = Bubble(ref_el, 3).tabulate(0, qpts)[(0,) * sd][0]
    linears = Lagrange(ref_el, 1).tabulate(0, qpts)[(0,) * sd]
    pk_tab = pk.tabulate(qpts)[(0,) * sd]

    layers = [hat * linears * qwts]
    if robust:
        layers.append(hat * layers[0])
    coeffs = np.zeros((2 * dimp1, dimpk))
    coeffs[:dimp1 * len(layers)] = np.vstack(layers) @ pk_tab.T

    bubbles = polyset.PolynomialSet(ref_el, 3, k, pk.get_expansion_set(),
                                    coeffs)
    return polyset.polynomial_set_union_normalized(
        pk.take(list(range(dimp3))), bubbles)


def wuxu_duals(ref_el, degree, orders):
    """Vertex 1-jets + averages of the given edge normal-derivative
    orders."""
    assert ref_el.get_spatial_dimension() == 2
    b = DualBuilder(ref_el)
    b.vertex_jets(1)
    Q_ref = create_quadrature(ref_el.construct_subelement(1),
                              degree - min(orders))
    ones = np.ones(Q_ref.get_weights().shape)
    for e in b.entities(1):
        n = ref_el.compute_normal(e)
        Q = b.map_rule(1, e, Q_ref)
        b.tag(1, e, (IntegralMomentOfDerivative(ref_el, Q, ones, *[n] * k)
                     for k in orders))
    return b.dual_set()


class WuXuRobustH3NC(finite_element.CiarletElement):
    """The robust Wu-Xu element: first AND second normal averages."""

    def __init__(self, ref_el, degree=7):
        poly_set = WuXuH3NCSpace(ref_el, robust=True)
        assert degree == poly_set.degree
        super().__init__(poly_set, wuxu_duals(ref_el, degree, (1, 2)),
                         degree)


class WuXuH3NC(finite_element.CiarletElement):
    """The Wu-Xu element: second normal averages only."""

    def __init__(self, ref_el, degree=4):
        poly_set = WuXuH3NCSpace(ref_el)
        assert degree == poly_set.degree
        super().__init__(poly_set, wuxu_duals(ref_el, degree, (2,)), degree)
