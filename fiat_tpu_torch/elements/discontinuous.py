"""DiscontinuousElement: the same basis with every DoF re-attached to
the cell interior.  Counterpart of ``fiat_tpu/elements/discontinuous.py``."""

from ..core.dual_builder import DualBuilder
from ..core.finite_element import CiarletElement, FiniteElement


class DiscontinuousElement(CiarletElement):
    """A copy of an element with every DoF associated to the cell."""

    def __init__(self, element):
        self._element = element
        ref_el = element.get_reference_element()
        mapping, = set(element.mapping())

        b = DualBuilder(ref_el)
        b.tag(max(sorted(ref_el.get_topology())), 0, element.dual_basis())
        FiniteElement.__init__(
            self, ref_el, b.dual_set(), element.get_order(),
            formdegree=ref_el.get_spatial_dimension(), mapping=mapping,
            ref_complex=element.get_reference_complex())


# everything else about the element is untouched: forward the whole
# CiarletElement surface to the wrapped element
def _forward(name):
    def method(self, *args, **kwargs):
        return getattr(self._element, name)(*args, **kwargs)
    method.__name__ = name
    method.__doc__ = f"Delegates {name} to the wrapped element."
    return method


for _name in ("degree", "get_nodal_basis", "get_coeffs",
              "num_sub_elements", "tabulate", "value_shape", "dmats",
              "get_num_members"):
    setattr(DiscontinuousElement, _name, _forward(_name))
