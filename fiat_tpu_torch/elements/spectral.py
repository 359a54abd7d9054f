"""Spectral point-variant elements: (discontinuous) Lagrange at
Gauss-Lobatto-Legendre, Gauss-Legendre and Gauss-Radau nodes.
Counterpart of ``fiat_tpu/elements/spectral.py``."""

from ..core import cells as cl
from ..core import finite_element, functionals, polyset
from ..core.dual_builder import DualBuilder
from ..core.quadrature import RadauQuadratureLineRule
from .discontinuous_lagrange import DiscontinuousLagrange
from .lagrange import Lagrange


class GaussLobattoLegendre(Lagrange):
    """Continuous element at recursive Gauss-Lobatto-Legendre points."""

    def __init__(self, ref_el, degree):
        super().__init__(ref_el, degree, variant="gll", sort_entities=True)


class GaussLegendre(DiscontinuousLagrange):
    """Discontinuous element at recursive Gauss-Legendre points."""

    def __init__(self, ref_el, degree):
        super().__init__(ref_el, degree, variant="gl")


def gauss_radau_dual(ref_el, degree, right=True):
    """DG-connectivity point-evaluation dual at the (degree+1)-point
    Gauss-Radau nodes: every dof lives on the cell interior even though
    one node sits at an endpoint."""
    b = DualBuilder(ref_el)
    b.tag(1, 0, (functionals.PointEvaluation(ref_el, x)
                 for x in RadauQuadratureLineRule(ref_el, degree + 1,
                                                  right).pts))
    return b.dual_set()


class GaussRadau(finite_element.CiarletElement):
    """1D discontinuous element at Gauss-Radau points."""

    def __init__(self, ref_el, degree, right=True):
        if ref_el.shape != cl.LINE:
            raise ValueError("Gauss-Radau elements are only defined in 1D.")
        super().__init__(polyset.ONPolynomialSet(ref_el, degree),
                         gauss_radau_dual(ref_el, degree, right),
                         degree, formdegree=1)
