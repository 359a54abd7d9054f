"""Restricted elements in the symbolic layer (counterpart of
``fiat_tpu/symbolic/restricted.py``; FInAT's ``finat/restricted.py``
singledispatches ``restrict`` over element types).  This one restricts
via the numerical layer and re-bridges (covering the Ciarlet cases);
tensor elements restrict their base element."""

from .fiat_bridge import FiatElement
from .tensorfiniteelement import TensorFiniteElement
from .. import elements as fe_numeric


def RestrictedElement(element, restriction_domain, *, indices=None):
    """Restrict ``element`` to the DoFs supported on
    ``restriction_domain`` ('interior', 'vertex', 'edge', 'face',
    'facet', 'ridge')."""
    assert restriction_domain or indices
    if isinstance(element, TensorFiniteElement):
        return TensorFiniteElement(
            RestrictedElement(element.base_element, restriction_domain,
                              indices=indices),
            element._shape, element._transpose)
    fiat_equiv = element.fiat_equivalent
    restricted = fe_numeric.RestrictedElement(
        fiat_equiv, indices=indices, restriction_domain=restriction_domain)
    return FiatElement(restricted)
