"""Restriction of an element to a subset of its DoFs.

Counterpart of ``fiat_tpu/elements/restricted.py``: the primal set is
sliced with ``take``, the dual keeps the selected nodes renumbered through
a position map, and ``restriction_domain`` strings resolve through the
parent dual's index query.
"""

from ..core.dualset import DualSet
from ..core.finite_element import CiarletElement


class RestrictedDualSet(DualSet):
    """The given DualSet narrowed to a sorted DoF subset."""

    def __init__(self, dual, indices):
        indices = sorted(indices)
        pos = {dof: i for i, dof in enumerate(indices)}
        entity_ids = {d: {e: [pos[dof] for dof in dofs if dof in pos]
                          for e, dofs in ents.items()}
                      for d, ents in dual.get_entity_ids().items()}
        self._dual = dual
        super().__init__([dual.get_nodes()[i] for i in indices],
                         dual.get_reference_element(), entity_ids)

    def get_indices(self, restriction_domain, take_closure=True):
        # domain queries answer like the parent dual type
        return type(self._dual).get_indices(self, restriction_domain,
                                            take_closure=take_closure)


def _resolve_indices(element, indices, restriction_domain, take_closure):
    if isinstance(indices, str):
        raise RuntimeError("'indices' was a string; forgot a keyword?")
    if indices is None or len(indices) == 0:
        if not restriction_domain:
            raise RuntimeError(
                "Either indices or restriction_domain must be given")
        indices = element.dual.get_indices(restriction_domain,
                                           take_closure=take_closure)
    if len(indices) == 0:
        raise ValueError("No point in creating an empty RestrictedElement.")
    return indices


class RestrictedElement(CiarletElement):
    """Keep the DoFs in ``indices`` (or those supported on
    ``restriction_domain``: 'interior', 'vertex', 'edge', 'face',
    'facet')."""

    def __init__(self, element, indices=None, restriction_domain=None,
                 take_closure=True):
        indices = _resolve_indices(element, indices, restriction_domain,
                                   take_closure)
        self._element = element
        self._indices = indices

        mappings = {element.mapping()[dof] for dof in indices}
        assert len(mappings) == 1
        super().__init__(element.get_nodal_basis().take(indices),
                         RestrictedDualSet(element.get_dual_set(), indices),
                         element.degree(), element.get_formdegree(),
                         mappings.pop())
