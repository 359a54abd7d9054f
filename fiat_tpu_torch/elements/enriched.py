"""Enriched element: the non-nodal direct sum of compatible elements.

Counterpart of ``fiat_tpu/elements/enriched.py``; tabulation stacks the
members' tables along the basis axis."""

import numpy as np

from ..core.dualset import DualSet
from ..core.finite_element import FiniteElement
from .mixed import concatenate_entity_dofs

__all__ = ["EnrichedElement"]


def _shared(label, values):
    distinct = set(values)
    if len(distinct) > 1:
        raise ValueError(f"Elements must share a {label}")
    value, = distinct
    return value


class EnrichedElement(FiniteElement):
    """Direct sum of the DoFs of compatible elements (same cell, mapping,
    value shape); primal/dual orthogonality is NOT restored (see
    NodalEnrichedElement for that)."""

    def __init__(self, *elements):
        ref_el = _shared("reference element",
                         (e.get_reference_element() for e in elements))
        mapping = _shared("mapping",
                          (m for e in elements for m in e.mapping()))
        _shared("value shape", (e.value_shape() for e in elements))

        fds = [e.get_formdegree() for e in elements]
        formdegree = None if None in fds else max(fds)
        dual = DualSet([n for e in elements for n in e.dual_basis()],
                       ref_el, concatenate_entity_dofs(ref_el, elements))
        super().__init__(ref_el, dual,
                         max(e.get_order() for e in elements),
                         formdegree, mapping)
        self._elements = elements
        self.polydegree = max(member.degree() for member in elements)

    def elements(self):
        return self._elements

    def degree(self):
        return self.polydegree

    def value_shape(self):
        return self._elements[0].value_shape()

    def tabulate(self, order, points, entity=None):
        """Stack the member tabulations along the basis axis."""
        pieces = [e.tabulate(order, points, entity)
                  for e in self._elements]
        return {alpha: np.concatenate([p[alpha] for p in pieces], axis=0)
                for alpha in pieces[0]}

    def get_nodal_basis(self):
        raise NotImplementedError("get_nodal_basis not implemented")

    def get_coeffs(self):
        raise NotImplementedError("get_coeffs not implemented")

    def dmats(self):
        raise NotImplementedError("dmats not implemented")

    def get_num_members(self, arg):
        raise NotImplementedError("get_num_members not implemented")
