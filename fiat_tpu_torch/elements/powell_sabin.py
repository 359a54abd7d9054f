"""Quadratic Powell-Sabin C1 macroelements: PS6 on the 6-way split
(vertex 1-jets), PS12 on the 12-way split (plus edge normal-derivative
averages).  Counterpart of ``fiat_tpu/elements/powell_sabin.py``, on the
declarative dual builder."""

from ..core import cells as cl
from ..core import finite_element
from ..core.dual_builder import DualBuilder
from ..core.functionals import IntegralMomentOfNormalDerivative
from ..core.jacobi import eval_jacobi_batch
from ..core.macro import (AlfeldSplit, CkPolynomialSet, PowellSabin12Split,
                          PowellSabinSplit)
from ..core.quadrature_schemes import create_quadrature


def _ps_builder(ref_complex, degree, name):
    if degree != 2:
        raise ValueError(f"{name} only defined for degree = 2")
    ref_el = ref_complex.get_parent()
    if ref_el.get_shape() != cl.TRIANGLE:
        raise ValueError(f"{name} only defined on triangles")
    b = DualBuilder(ref_el)
    b.vertex_jets(1)
    return b


class QuadraticPowellSabin6(finite_element.CiarletElement):
    """C1 quadratic on the 6-way Powell-Sabin split."""

    def __init__(self, ref_el, degree=2):
        ref_complex = PowellSabinSplit(ref_el)
        b = _ps_builder(ref_complex, degree, "PS6")
        super().__init__(CkPolynomialSet(ref_complex, degree, order=1),
                         b.dual_set(), degree)


class QuadraticPowellSabin12(finite_element.CiarletElement):
    """C1 quadratic on the 12-way Powell-Sabin split."""

    def __init__(self, ref_el, degree=2):
        ref_complex = PowellSabin12Split(ref_el)
        b = _ps_builder(ref_complex, degree, "PS12")
        # normal-derivative averages on the split edge (Alfeld line)
        split_line = AlfeldSplit(cl.ufc_simplex(1))
        Q = create_quadrature(split_line, degree - 1)
        tests = eval_jacobi_batch(1, 1, 0, 2.0 * Q.get_points() - 1)
        parent = ref_complex.get_parent()
        for e in b.entities(1):
            b.tag(1, e, (IntegralMomentOfNormalDerivative(
                parent, e, Q, phi) for phi in tests))
        super().__init__(CkPolynomialSet(ref_complex, degree, order=1),
                         b.dual_set(), degree)
