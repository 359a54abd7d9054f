"""1D Histopolation element.

Counterpart of ``fiat_tpu/elements/histopolation.py``: a discontinuous
element whose DoFs are integral moments against window functions w_j with
int w_j v = (1/h_j) int_{[x_j, x_{j+1}]} v for all v in P_k (subinterval
averages on the GLL subgrid).  The windows are the L2-Riesz representers
of the subinterval averages in P_k: a mass solve against exactly
integrated averages of an orthonormal basis.  Host-side numpy f64.
"""

import numpy as np

from ..core import cells as cl
from ..core import finite_element, functionals, polyset, quadrature
from ..core.barycentric import LagrangePolynomialSet, get_lagrange_points
from ..core.dualset import DualSet
from ..core.orientation import make_entity_permutations_simplex
from .spectral import GaussLobattoLegendre


class HistopolationDualSet(DualSet):
    """Moments against the P_k-Riesz representers of the subinterval
    averages v -> (1/h_j) int_{[x_j, x_{j+1}]} v."""

    def __init__(self, ref_el, degree):
        rule = quadrature.GaussLegendreQuadratureLineRule(ref_el, degree + 1)
        self.rule = rule
        qpts, qwts = rule.get_points(), rule.get_weights()

        # the GLL(degree+1) subgrid defining the subintervals
        x = np.reshape(get_lagrange_points(
            GaussLobattoLegendre(ref_el, degree + 1).dual_basis()), (-1,))

        # averages of a P_k basis over each subinterval, integrated by the
        # same GL rule pushed affinely onto [x_j, x_{j+1}] (exact on P_k);
        # the 1/h_j normalisation cancels the subinterval length
        P = polyset.ONPolynomialSet(ref_el, degree)
        (v0,), (v1,) = ref_el.get_vertices()
        t = (np.reshape(qpts, (-1,)) - v0) / (v1 - v0)
        sub = x[:-1, None] + np.diff(x)[:, None] * t[None, :]
        avg = P.tabulate(sub.reshape(-1, 1))[(0,)]
        avg = avg.reshape(len(P), len(sub), -1) @ (qwts / (v1 - v0))

        # Riesz representation in P_k: solve the mass system, then evaluate
        # the windows at the moment rule's points
        phi = P.tabulate(qpts)[(0,)]
        M = (phi * qwts) @ phi.T
        F = np.linalg.solve(M, avg).T @ phi
        nodes = [functionals.IntegralMoment(ref_el, rule, f) for f in F]

        entity_ids = {0: {0: [], 1: []},
                      1: {0: list(range(degree + 1))}}
        entity_permutations = {
            0: {0: {0: []}, 1: {0: []}},
            1: {0: make_entity_permutations_simplex(1, degree + 1)}}
        super().__init__(nodes, ref_el, entity_ids, entity_permutations)


class Histopolation(finite_element.CiarletElement):
    """1D discontinuous element with subinterval-average DoFs."""

    def __init__(self, ref_el, degree):
        if ref_el.shape != cl.LINE:
            raise ValueError("Histopolation elements are only defined in 1D.")
        dual = HistopolationDualSet(ref_el, degree)
        poly_set = LagrangePolynomialSet(ref_el, dual.rule.pts)
        super().__init__(poly_set, dual, degree, ref_el.get_spatial_dimension())
