"""Discontinuous wrapper in the symbolic layer: the wrapped element's
evaluations with every DoF re-attached to the cell.  Counterpart of
``fiat_tpu/symbolic/discontinuous.py`` (role of FInAT's
``finat/discontinuous.py``)."""

from .. import elements as fe_numeric
from .base import FiniteElementBase


def _read_through(name):
    get = lambda self: getattr(self.element, name)
    get.__name__ = name
    return property(get)


class DiscontinuousElement(FiniteElementBase):
    """Move all DoFs of a symbolic element onto the cell."""

    # the geometric/value metadata reads straight off the wrapped element
    cell = _read_through("cell")
    complex = _read_through("complex")
    degree = _read_through("degree")
    index_shape = _read_through("index_shape")
    value_shape = _read_through("value_shape")
    dual_basis = _read_through("dual_basis")
    mapping = _read_through("mapping")

    def __init__(self, element):
        super().__init__()
        self.element = element

    @property
    def formdegree(self):
        return self.element.cell.get_spatial_dimension()

    def entity_dofs(self):
        try:
            return self._entity_dofs_cache
        except AttributeError:
            dofs = {dim: {e: [] for e in entities}
                    for dim, entities in self.cell.get_topology().items()}
            dofs[self.cell.get_dimension()][0] = \
                list(range(self.space_dimension()))
            self._entity_dofs_cache = dofs
        return self._entity_dofs_cache

    @property
    def entity_permutations(self):
        if self.element.entity_dofs() == self.element.entity_closure_dofs():
            return self.element.entity_permutations
        raise NotImplementedError("entity_permutations not yet implemented "
                                  f"for a general {type(self)}")

    @property
    def fiat_equivalent(self):
        return fe_numeric.DiscontinuousElement(
            self.element.fiat_equivalent)

    def basis_evaluation(self, order, ps, entity=None,
                         coordinate_mapping=None):
        return self.element.basis_evaluation(
            order, ps, entity, coordinate_mapping=coordinate_mapping)

    def point_evaluation(self, order, refcoords, entity=None,
                         coordinate_mapping=None):
        return self.element.point_evaluation(order, refcoords, entity,
                                             coordinate_mapping)

    def space_dimension(self):
        return self.element.space_dimension()
