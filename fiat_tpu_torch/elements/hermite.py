"""Cubic Hermite: vertex value+gradient jets plus face-barycentre values.
Counterpart of ``fiat_tpu/elements/hermite.py``, on the declarative dual
builder."""

from ..core import finite_element, functionals, polyset
from ..core.dual_builder import DualBuilder


class CubicHermite(finite_element.CiarletElement):
    """The cubic Hermite element."""

    def __init__(self, ref_el, deg=3):
        assert deg == 3
        b = DualBuilder(ref_el)
        b.vertex_jets(1)
        if b.sd > 1:
            for f in b.entities(2):
                pt = b.lattice(2, f, 3)[0]
                b.tag(2, f, [functionals.PointEvaluation(ref_el, pt)])
        super().__init__(polyset.ONPolynomialSet(ref_el, 3), b.dual_set(),
                         3)
