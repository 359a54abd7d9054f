"""Flattened hypercube presentation of TP elements (counterpart of
``fiat_tpu/symbolic/cube.py``, role of FInAT's ``finat/cube.py``): entity dimensions of a tensor-product
element collapse to quadrilateral/hexahedron numbering, evaluations
forward through the unflattening map, and everything else delegates to
the wrapped product element via a generated pass-through table."""

from functools import cached_property

from .. import elements as fe_numeric
from ..core.cells import (UFCHexahedron, UFCQuadrilateral,
                          compute_unflattening_map, flatten_entities,
                          flatten_permutations)
from .base import FiniteElementBase

_CUBES = {2: UFCQuadrilateral, 3: UFCHexahedron}


class FlattenedDimensions(FiniteElementBase):
    """Wrap a tensor-product element, flattening its entity dimensions to
    quadrilateral/hexahedron numbering."""

    def __init__(self, element):
        super().__init__()
        self.product = element
        self._unflatten = compute_unflattening_map(
            element.cell.get_topology())

    @cached_property
    def cell(self):
        dim = self.product.cell.get_spatial_dimension()
        if dim not in _CUBES:
            raise NotImplementedError(f"Cannot guess cell for dimension {dim}")
        return _CUBES[dim]()

    @property
    def degree(self):
        unique_degree, = set(self.product.degree)
        return unique_degree

    @cached_property
    def _entity_dofs(self):
        return flatten_entities(self.product.entity_dofs())

    def entity_dofs(self):
        return self._entity_dofs

    def entity_support_dofs(self):
        return flatten_entities(self.product.entity_support_dofs())

    @property
    def entity_permutations(self):
        return flatten_permutations(self.product.entity_permutations)

    @property
    def fiat_equivalent(self):
        return fe_numeric.FlattenedDimensions(self.product.fiat_equivalent)

    def _cube_entity(self, entity):
        if entity is None:
            entity = (self.cell.get_spatial_dimension(), 0)
        return self._unflatten[entity]

    def basis_evaluation(self, order, ps, entity=None, coordinate_mapping=None):
        return self.product.basis_evaluation(order, ps,
                                             self._cube_entity(entity))

    def point_evaluation(self, order, point, entity=None,
                         coordinate_mapping=None):
        return self.product.point_evaluation(order, point,
                                             self._cube_entity(entity),
                                             coordinate_mapping)

    def dual_evaluation(self, argument, coordinate_mapping=None):
        return self.product.dual_evaluation(argument, coordinate_mapping)


def _forward(name, call):
    if call:
        def fwd(self):
            return getattr(self.product, name)()
        return fwd
    return property(lambda self: getattr(self.product, name))


for _name in ("complex", "formdegree", "dual_basis", "index_shape",
              "value_shape", "mapping"):
    setattr(FlattenedDimensions, _name, _forward(_name, call=False))
FlattenedDimensions.space_dimension = _forward("space_dimension", call=True)

import abc  # noqa: E402
abc.update_abstractmethods(FlattenedDimensions)
