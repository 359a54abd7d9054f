"""Nodal enriched element in the symbolic layer (counterpart of
``fiat_tpu/symbolic/nodal_enriched.py``, role of FInAT's
``finat/nodal_enriched.py``)."""

from .. import elements as fe_numeric
from .fiat_bridge import FiatElement


class NodalEnrichedElement(FiatElement):
    """An enriched element re-nodalised against the merged dual basis."""

    def __init__(self, elements):
        nodal_enriched = fe_numeric.NodalEnrichedElement(
            *(elem.fiat_equivalent for elem in elements))
        super().__init__(nodal_enriched)
