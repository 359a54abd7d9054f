"""Counterpart of ``fiat_tpu/symbolic/bell.py``. Bell: quintic C1 triangle
with vertex 2-jets; the three edge rows are constraints (not dofs)
folded into the vertex jets. Behavioural parity: FInAT's
``finat/bell.py``, on the shared zany engine."""

from .. import elements as fe
from .citations import cite
from .fiat_bridge import ScalarFiatElement
from .physically_mapped import PhysicallyMappedElement, identity
from .zany import (JetLayout, ZanyCtx, jet_couple, put_vertex_jets,
                   scale_jet_columns)

# constraint-row coupling into the endpoint 2-jets, per jet order
_CONSTRAINT_JET = (1 / 21, -1 / 42, 1 / 252)


class Bell(PhysicallyMappedElement, ScalarFiatElement):
    def __init__(self, cell, degree=5):
        cite("Bell1969")
        super().__init__(fe.Bell(cell, degree=degree))
        dofs = {dim: dict(ent)
                for dim, ent in self._element.entity_dofs().items()}
        dofs[1] = {e: [] for e in dofs[1]}
        self._entity_dofs = dofs

    def entity_dofs(self):
        # FIAT reports 21 rows; the element exposes 18 (the 3 edge rows
        # are constraints feeding the transformation only)
        return self._entity_dofs

    def space_dimension(self):
        return 18

    def basis_transformation(self, coordinate_mapping):
        ctx = ZanyCtx(self.cell, coordinate_mapping)
        lay = JetLayout(self.cell, 2, erows=1)
        # rectangular: the constraint rows have no dof column
        V = identity(self._element.space_dimension(),
                     self.space_dimension())
        put_vertex_jets(V, ctx, 2)
        for e in sorted(self.cell.get_topology()[1]):
            jet_couple(V, ctx, e, lay.erow(e), _CONSTRAINT_JET, lay)
        scale_jet_columns(V, ctx, lay)
        return V.T
