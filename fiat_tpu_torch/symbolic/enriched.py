"""Enriched element in the symbolic layer (counterpart of
``fiat_tpu/symbolic/enriched.py``, role of FInAT's ``finat/enriched.py``):
the union element tabulates each part and concatenates along the
flattened basis axis (``torch.cat`` on tensor tables); reference queries
reduce over the parts (unique / max / sum) through one aggregation table."""

import numpy as np
import torch

from .. import elements as fe_numeric
from ..core.cells import max_complex
from .base import FiniteElementBase
from .point_set import _is_traced


def _concatenate(arrays):
    """Concatenate on the first axis: numpy unless any operand is a tensor
    (the others join it on its device, in its dtype)."""
    tensors = [a for a in arrays if _is_traced(a)]
    if not tensors:
        return np.concatenate(arrays, axis=0)
    like = tensors[0]
    return torch.cat([torch.as_tensor(a, dtype=like.dtype, device=like.device)
                      for a in arrays], dim=0)


def _the(values):
    """The single common value of an iterable (parts must agree)."""
    distinct, = set(values)
    return distinct


def _deep_max(*degrees):
    """Elementwise max over possibly-nested degree tuples (TP elements
    carry per-factor degrees)."""
    if all(isinstance(d, tuple) for d in degrees):
        return tuple(_deep_max(*slot) for slot in zip(*degrees))
    return max(degrees)


class EnrichedElement(FiniteElementBase):
    """Union of the basis functions of several elements."""

    def __new__(cls, elements, is_nodal_enriched=None):
        parts = []
        for e in elements:
            parts.extend(e.elements if isinstance(e, EnrichedElement) else [e])
        if len(parts) == 1:
            return parts[0]
        self = super().__new__(cls)
        self.elements = tuple(parts)
        if is_nodal_enriched is None:
            is_nodal_enriched = all(
                _disjoint_components(a, b)
                for k, a in enumerate(self.elements)
                for b in self.elements[k + 1:])
        self.is_nodal_enriched = is_nodal_enriched
        return self

    @property
    def cell(self):
        return _the(e.cell for e in self.elements)

    @property
    def complex(self):
        return max_complex(set(e.complex for e in self.elements))

    @property
    def degree(self):
        return _deep_max(*(e.degree for e in self.elements))

    @property
    def formdegree(self):
        ks = set(e.formdegree for e in self.elements)
        return None if None in ks else max(ks)

    def entity_dofs(self):
        return self._merge_dofs(lambda e: e.entity_dofs())

    def entity_support_dofs(self):
        return self._merge_dofs(lambda e: e.entity_support_dofs())

    @property
    def entity_permutations(self):
        merged = {}
        for element in self.elements:
            for dim, by_ent in element.entity_permutations.items():
                for ent, by_orient in by_ent.items():
                    for orient, perm in by_orient.items():
                        tail = (merged.setdefault(dim, {})
                                .setdefault(ent, {}).setdefault(orient, []))
                        base = len(tail)
                        tail.extend(base + q for q in perm)
        return merged

    def _merge_dofs(self, get):
        """Union the parts' entity dof maps, shifting each part's dof
        numbers past the previous parts' spaces."""
        merged = {dim: {ent: [] for ent in ents}
                  for dim, ents in self.cell.get_topology().items()}
        offset = 0
        for element in self.elements:
            for dim, by_ent in get(element).items():
                for ent, dofs in by_ent.items():
                    merged[dim][ent].extend(offset + d for d in dofs)
            offset += element.space_dimension()
        return merged

    def space_dimension(self):
        return sum(e.space_dimension() for e in self.elements)

    @property
    def index_shape(self):
        return (self.space_dimension(),)

    @property
    def value_shape(self):
        return _the(e.value_shape for e in self.elements)

    @property
    def mapping(self):
        kinds = set(e.mapping for e in self.elements)
        return kinds.pop() if len(kinds) == 1 else None

    @property
    def is_mixed(self):
        from .mixed import MixedSubElement
        return all(isinstance(e, MixedSubElement) for e in self.elements)

    @property
    def fiat_equivalent(self):
        if self.is_mixed:
            return fe_numeric.MixedElement(
                [e.element.fiat_equivalent for e in self.elements],
                ref_el=self.cell)
        return fe_numeric.EnrichedElement(
            *(e.fiat_equivalent for e in self.elements))

    def _stack(self, per_part):
        """Concatenate per-part tabulations along the flattened basis axis,
        per derivative key (all parts report the same keys)."""
        keys = _the(frozenset(d) for d in per_part)

        def cat(tables):
            flat = [t.reshape((-1,) + t.shape[len(e.index_shape):])
                    for e, t in zip(self.elements, tables)]
            return _concatenate(flat)

        return {key: cat([d[key] for d in per_part]) for key in keys}

    def basis_evaluation(self, order, ps, entity=None, coordinate_mapping=None):
        return self._stack([
            e.basis_evaluation(order, ps, entity,
                               coordinate_mapping=coordinate_mapping)
            for e in self.elements])

    def point_evaluation(self, order, refcoords, entity=None,
                         coordinate_mapping=None):
        return self._stack([
            e.point_evaluation(order, refcoords, entity, coordinate_mapping)
            for e in self.elements])

    def dual_evaluation(self, argument, coordinate_mapping=None):
        if not self.is_nodal_enriched:
            raise NotImplementedError(
                f"Dual evaluation not defined for {type(self).__name__}")
        per_part = [e.dual_evaluation(argument,
                                      coordinate_mapping=coordinate_mapping)
                    for e in self.elements]
        return _concatenate([s.reshape(-1) for s in per_part])


def _disjoint_components(A, B):
    """Whether two H(div)/H(curl) wrapper elements write disjoint value
    components (then dual evaluation decouples part by part)."""
    from .hdivcurl import HCurlElement, HDivElement
    wrappers = (HCurlElement, HDivElement)
    if not (isinstance(A, wrappers) and isinstance(B, wrappers)):
        return False
    slots = [{i for i, sel in enumerate(e.rows) if sel is not None}
             for e in (A, B)]
    return not (slots[0] & slots[1])
