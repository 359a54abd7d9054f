"""Discontinuous Raviart-Thomas: the RT space with all DoFs attached to
the cell.  Counterpart of
``fiat_tpu/elements/discontinuous_raviart_thomas.py``, on the declarative
dual builder."""

from ..core import finite_element, functionals
from ..core.dual_builder import DualBuilder
from .raviart_thomas import RTSpace


class DiscontinuousRaviartThomas(finite_element.CiarletElement):
    """The discontinuous Raviart-Thomas element."""

    def __init__(self, ref_el, degree):
        sd = ref_el.get_spatial_dimension()
        b = DualBuilder(ref_el)
        rows = [functionals.PointScaledNormalEvaluation(ref_el, f, p)
                for f in b.entities(sd - 1)
                for p in b.lattice(sd - 1, f, sd + degree - 1)]
        if degree > 1:
            rows += [functionals.ComponentPointEvaluation(
                ref_el, d, (sd,), p)
                for d in range(sd) for p in b.lattice(sd, 0, sd + degree - 1)]
        b.tag(sd, 0, rows)
        super().__init__(RTSpace(ref_el, degree), b.dual_set(), degree,
                         mapping="contravariant piola")
