"""Mixed elements in the symbolic layer (counterpart of
``fiat_tpu/symbolic/mixed.py``, role of FInAT's ``finat/mixed.py``):
EnrichedElement of MixedSubElements that scatter each part's flattened
value into a long zero-padded vector (``torch.nn.functional.pad`` on
tensor tables)."""

import numpy as np
import torch

from .base import FiniteElementBase
from .enriched import EnrichedElement
from .point_set import _is_traced


def MixedElement(elements):
    """FEniCS-style mixed element: enrichment of offset sub-elements."""
    sizes = [int(np.prod(element.value_shape, dtype=int))
             for element in elements]
    offsets = [int(o) for o in np.cumsum([0] + sizes)]
    total_size = offsets.pop()
    return EnrichedElement([MixedSubElement(element, total_size, offset)
                            for offset, element in zip(offsets, elements)])


class MixedSubElement(FiniteElementBase):
    """Flatten the value shape and embed it at an offset in a larger
    zero vector."""

    def __init__(self, element, size, offset):
        assert 0 <= offset <= size
        assert offset + np.prod(element.value_shape, dtype=int) <= size
        super().__init__()
        self.element = element
        self.size = size
        self.offset = offset

    @property
    def cell(self):
        return self.element.cell

    @property
    def complex(self):
        return self.element.complex

    @property
    def degree(self):
        return self.element.degree

    @property
    def formdegree(self):
        return self.element.formdegree

    def entity_dofs(self):
        return self.element.entity_dofs()

    def entity_closure_dofs(self):
        return self.element.entity_closure_dofs()

    def entity_support_dofs(self):
        return self.element.entity_support_dofs()

    def space_dimension(self):
        return self.element.space_dimension()

    @property
    def index_shape(self):
        return self.element.index_shape

    @property
    def value_shape(self):
        return (self.size,)

    def _transform_evaluation(self, core_eval):
        n_idx = len(self.element.index_shape)
        n_val = len(self.element.value_shape)
        result = {}
        for alpha, table in core_eval.items():
            idx_shape = tuple(table.shape[:n_idx])
            val_size = int(np.prod(table.shape[n_idx:n_idx + n_val], dtype=int))
            pts_shape = tuple(table.shape[n_idx + n_val:])
            flat = table.reshape(idx_shape + (val_size,) + pts_shape)
            pad_before = (0,) * len(idx_shape) + (self.offset,) + (0,) * len(pts_shape)
            pad_after = ((0,) * len(idx_shape)
                         + (self.size - self.offset - val_size,)
                         + (0,) * len(pts_shape))
            if _is_traced(table):
                # torch's pad lists (before, after) from the last axis back
                spec = [w for pair in zip(pad_before[::-1], pad_after[::-1]) for w in pair]
                result[alpha] = torch.nn.functional.pad(flat, spec)
            else:
                result[alpha] = np.pad(flat, tuple(zip(pad_before, pad_after)))
        return result

    def basis_evaluation(self, order, ps, entity=None, coordinate_mapping=None):
        return self._transform_evaluation(self.element.basis_evaluation(
            order, ps, entity, coordinate_mapping=coordinate_mapping))

    def point_evaluation(self, order, refcoords, entity=None,
                         coordinate_mapping=None):
        return self._transform_evaluation(self.element.point_evaluation(
            order, refcoords, entity))

    @property
    def mapping(self):
        return self.element.mapping


def split_mixed_evaluation(mixed, tables):
    """The mixed-space ``unconcatenate``: split a MixedElement evaluation
    {alpha: (dofs..., total_value, pts...)} back into per-subelement
    evaluations with their own value shapes and dof blocks (inverse of the
    MixedSubElement zero-padded embedding; gem/unconcatenate.py's role).
    """
    parts = []
    dof_off = 0
    for sub in mixed.elements:
        if not isinstance(sub, MixedSubElement):
            raise TypeError("split_mixed_evaluation expects a MixedElement")
        core = sub.element
        n_idx = int(np.prod(core.index_shape, dtype=int))
        n_val = int(np.prod(core.value_shape, dtype=int))
        block = {}
        for alpha, table in tables.items():
            sl = table[dof_off:dof_off + n_idx,
                       sub.offset:sub.offset + n_val]
            block[alpha] = sl.reshape(core.index_shape + core.value_shape
                                      + table.shape[2:])
        parts.append(block)
        dof_off += n_idx
    return parts
