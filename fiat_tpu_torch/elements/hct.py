"""Hsieh-Clough-Tocher: C1 cubic (or higher) macroelement on the Alfeld
split; vertex 1-jets + edge normal-derivative moments.  Counterpart of
``fiat_tpu/elements/hct.py``, on the declarative dual builder."""

from ..core import cells as cl
from ..core import finite_element, polyset
from ..core.dual_builder import DualBuilder
from ..core.functionals import (IntegralMoment, IntegralMomentOfDerivative,
                                IntegralMomentOfNormalDerivative)
from ..core.jacobi import (eval_jacobi, eval_jacobi_batch,
                           eval_jacobi_deriv_batch)
from ..core.macro import AlfeldSplit, CkPolynomialSet
from ..core.variants import parse_quadrature_scheme


def hct_duals(ref_complex, degree, reduced=False, quad_scheme=None):
    if reduced and degree != 3:
        raise ValueError("Reduced HCT only defined for degree = 3")
    if degree < 3:
        raise ValueError("HCT only defined for degree >= 3")
    ref_el = ref_complex.get_parent()
    if ref_el.get_shape() != cl.TRIANGLE:
        raise ValueError("HCT only defined on triangles")

    b = DualBuilder(ref_el)
    b.vertex_jets(1)

    k = 2 if reduced else degree - 3
    line = cl.ufc_simplex(1)
    Q_ref = parse_quadrature_scheme(line, degree - 1 + k, quad_scheme)
    s = line.compute_barycentric_coordinates(Q_ref.get_points())
    s = s[:, [1]] - s[:, [0]]
    if reduced:
        probe = eval_jacobi(0, 0, k, s[:, 0])
        for e in b.entities(1):
            b.tag(1, e, [IntegralMomentOfNormalDerivative(
                ref_el, e, Q_ref, probe)])
        return b.dual_set()

    jac = eval_jacobi_batch(1, 1, k, s)
    djac = 2 * eval_jacobi_deriv_batch(1, 1, k, s)
    for e in b.entities(1):
        Q = b.map_rule(1, e, Q_ref)
        n = ref_el.compute_normal(e)
        b.tag(1, e, [IntegralMomentOfDerivative(ref_el, Q, phi, n)
                     for phi in jac]
                    + [IntegralMoment(ref_el, Q, dphi)
                       for dphi in djac[1:]])

    if degree >= 4:
        q = degree - 4
        Q = parse_quadrature_scheme(ref_complex, degree + q, quad_scheme)
        tests = polyset.ONPolynomialSet(ref_el, q, scale=1)
        phis = tests.tabulate(Q.get_points())[(0,) * b.sd]
        b.tag(b.sd, 0, (IntegralMoment(ref_el, Q, phi / ref_el.volume())
                        for phi in phis))
    return b.dual_set()


class HsiehCloughTocher(finite_element.CiarletElement):
    """The HCT macroelement on the Alfeld split (reduced variant drops
    the edge normal moments to linear)."""

    def __init__(self, ref_el, degree=3, reduced=False, quad_scheme=None):
        ref_complex = AlfeldSplit(ref_el)
        dual = hct_duals(ref_complex, degree, reduced=reduced,
                         quad_scheme=quad_scheme)
        poly_set = CkPolynomialSet(ref_complex, degree, order=1,
                                   vorder=degree - 1, variant="bubble")
        super().__init__(poly_set, dual, degree, formdegree=0)
