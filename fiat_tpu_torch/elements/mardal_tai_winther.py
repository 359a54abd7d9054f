"""Mardal-Tai-Winther: BDM(order) + curl of bubble vector fields, with
facet normal/tangential moments.  Counterpart of
``fiat_tpu/elements/mardal_tai_winther.py``, on the declarative dual
builder."""

import numpy as np

from ..core import expansions, finite_element, polyset
from ..core.dual_builder import DualBuilder
from ..core.functionals import FrobeniusIntegralMoment
from ..core.quadrature_schemes import create_quadrature
from ..core.variants import parse_quadrature_scheme
from .nedelec import Nedelec


def curl(tabulation):
    """Curl (skew gradient) of a vector field, or rot of a scalar in 2D,
    from a first-order tabulation dict."""
    grad_u = {alpha.index(1): tabulation[alpha]
              for alpha in tabulation if sum(alpha) == 1}
    if grad_u[0].shape[1:-1] == ():
        curl_u = [grad_u[1], -grad_u[0]]
    else:
        d = len(grad_u)
        pairs = ((i, j) for i in reversed(range(d))
                 for j in reversed(range(i + 1, d)))
        curl_u = [((-1) ** k) * (grad_u[j][:, i, :] - grad_u[i][:, j, :])
                  for k, (i, j) in enumerate(pairs)]
    return np.transpose(curl_u, (1, 0, 2))


def MardalTaiWintherSpace(ref_el, order=1):
    """BDM(order) + curl(B [P1]^d), projected onto degree sd+1."""
    sd = ref_el.get_spatial_dimension()
    k = sd + 1
    assert order < k
    Pk = polyset.ONPolynomialSet(ref_el, k, shape=(sd,),
                                 scale="orthonormal")
    nlow = expansions.polynomial_dimension(ref_el, order)
    nfull = expansions.polynomial_dimension(ref_el, k)
    BDM = Pk.take([i + nfull * j for i in range(nlow) for j in range(sd)])

    bubbles = polyset.make_bubbles(
        ref_el, k + 1, shape=() if sd == 2 else ((sd * (sd - 1)) // 2,))

    Q = create_quadrature(ref_el, 2 * k)
    qpts, qwts = Q.get_points(), Q.get_weights()
    rot = curl(bubbles.tabulate(qpts, 1))
    base = Pk.tabulate(qpts)[(0,) * sd]
    C = np.tensordot(rot, base * qwts,
                     axes=(range(1, rot.ndim), range(1, base.ndim)))
    coeffs = np.tensordot(C, Pk.get_coeffs(), axes=(1, 0))
    curl_part = polyset.PolynomialSet(ref_el, k, k,
                                      Pk.get_expansion_set(), coeffs)
    return polyset.polynomial_set_union_normalized(BDM, curl_part)


def mtw_facet_duals(b, order, scheme):
    """Per facet: u.n against P_order plus u x n against the lowest-order
    RT facet basis (Piola-mapped)."""
    sd = b.sd
    degree = sd + 1
    Q_ref, tests = b.facet_basis(sd - 1, order, degree + order, scheme)
    if sd == 2:
        rt = tests[:1, None, :]
    else:
        rt = np.zeros((3, sd - 1, tests.shape[-1]))
        rt[0, 0], rt[1, 1] = tests[0], tests[0]
        rt[2, 0], rt[2, 1] = tests[1], tests[2]

    for f in b.entities(sd - 1):
        n = b.ref_el.compute_scaled_normal(f)
        Q = b.map_rule(sd - 1, f, Q_ref)
        tangential = np.tensordot(Q.jacobian(), rt.transpose(1, 0, 2),
                                  (1, 0)).transpose(1, 0, 2)
        if sd == 3:
            tangential = np.cross(n[None, :, None], tangential, axis=1)
        b.tag(sd - 1, f, [FrobeniusIntegralMoment(
            b.ref_el, Q, np.outer(n, phi)) for phi in tests]
            + [FrobeniusIntegralMoment(b.ref_el, Q, phi)
               for phi in tangential])


def mtw_interior_duals(b, order, scheme):
    """Moments against Nedelec(order-1) for order > 1."""
    degree = b.sd + 1
    Q = parse_quadrature_scheme(b.ref_el, degree + order - 1, scheme)
    phis = Nedelec(b.ref_el, order - 1).tabulate(
        0, Q.get_points())[(0,) * b.sd]
    b.tag(b.sd, 0, (FrobeniusIntegralMoment(b.ref_el, Q, phi)
                    for phi in phis))


class MardalTaiWinther(finite_element.CiarletElement):
    """The Mardal-Tai-Winther Stokes/Darcy element."""

    def __init__(self, ref_el, order=1, quad_scheme=None):
        sd = ref_el.get_spatial_dimension()
        if sd not in (2, 3):
            raise ValueError("MTW only defined in dimension 2 and 3.")
        if not ref_el.is_simplex():
            raise ValueError("MTW only defined on simplices.")
        if order >= sd:
            raise ValueError("MTW only defined for 1 <= order < dim.")
        b = DualBuilder(ref_el)
        mtw_facet_duals(b, order, quad_scheme)
        if order > 1:
            mtw_interior_duals(b, order, quad_scheme)
        super().__init__(MardalTaiWintherSpace(ref_el, order), b.dual_set(),
                         order, sd - 1, mapping="contravariant piola")
