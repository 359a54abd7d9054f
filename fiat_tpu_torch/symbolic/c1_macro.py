"""Counterpart of ``fiat_tpu/symbolic/c1_macro.py``. C1 macroelement
transformations: Hsieh-Clough-Tocher (full and reduced) and quadratic
Powell-Sabin (6- and 12-split). Behavioural parity: FInAT's
``finat/{hct,powell_sabin}.py``, on the shared zany engine."""

from .. import elements as fe
from .citations import cite
from .fiat_bridge import ScalarFiatElement
from .hermite import vertex_gradient_transform
from .physically_mapped import PhysicallyMappedElement, identity
from .zany import (JetLayout, ZanyCtx, edge_moment_rows, jet_couple,
                   put_vertex_jets, scale_jet_columns)

# reduced HCT: edge normal-derivative rows are constrained into the
# endpoint 1-jets with these Bnt weights (cubic Hermite expansion)
_REDUCED_EDGE_JET = (-1 / 5, 1 / 10)


class HsiehCloughTocher(PhysicallyMappedElement, ScalarFiatElement):
    def __init__(self, cell, degree=3, avg=False):
        cite("Clough1965")
        if degree > 3:
            cite("Groselj2022")
        self.avg = avg
        super().__init__(fe.HsiehCloughTocher(cell, degree))

    def basis_transformation(self, coordinate_mapping):
        ctx = ZanyCtx(self.cell, coordinate_mapping)
        eorder = self.degree - 3
        lay = JetLayout(self.cell, 1, erows=2 * eorder + 1)
        V = identity(self.space_dimension())
        put_vertex_jets(V, ctx, 1)
        edge_moment_rows(V, ctx, lay, eorder, avg=self.avg)
        scale_jet_columns(V, ctx, lay)
        return V.T


class ReducedHsiehCloughTocher(PhysicallyMappedElement, ScalarFiatElement):
    def __init__(self, cell, degree=3):
        cite("Clough1965")
        super().__init__(fe.HsiehCloughTocher(cell, reduced=True))
        dofs = {dim: dict(ent)
                for dim, ent in self._element.entity_dofs().items()}
        sd = cell.get_spatial_dimension()
        dofs[sd - 1] = {e: [] for e in dofs[sd - 1]}
        self._entity_dofs = dofs

    def entity_dofs(self):
        # FIAT reports 12 rows; the element exposes 9
        return self._entity_dofs

    def space_dimension(self):
        return 9

    def basis_transformation(self, coordinate_mapping):
        ctx = ZanyCtx(self.cell, coordinate_mapping)
        lay = JetLayout(self.cell, 1, erows=1)
        V = identity(self._element.space_dimension(),
                     self.space_dimension())
        put_vertex_jets(V, ctx, 1)
        for e in sorted(self.cell.get_topology()[1]):
            jet_couple(V, ctx, e, lay.erow(e), _REDUCED_EDGE_JET, lay)
        scale_jet_columns(V, ctx, lay)
        return V.T


class QuadraticPowellSabin6(PhysicallyMappedElement, ScalarFiatElement):
    """Hermite-type dofs on the 6-way split: same transformation as
    cubic Hermite."""

    def __init__(self, cell, degree=2):
        cite("PowellSabin1977")
        super().__init__(fe.QuadraticPowellSabin6(cell))

    def basis_transformation(self, coordinate_mapping):
        return vertex_gradient_transform(self, coordinate_mapping)


class QuadraticPowellSabin12(PhysicallyMappedElement, ScalarFiatElement):
    """PS6 dofs plus one normal-derivative moment per edge."""

    def __init__(self, cell, degree=2, avg=False):
        self.avg = avg
        cite("PowellSabin1977")
        super().__init__(fe.QuadraticPowellSabin12(cell))

    def basis_transformation(self, coordinate_mapping):
        ctx = ZanyCtx(self.cell, coordinate_mapping)
        lay = JetLayout(self.cell, 1, erows=1)
        V = identity(self.space_dimension())
        put_vertex_jets(V, ctx, 1)
        edge_moment_rows(V, ctx, lay, 0, avg=self.avg)
        scale_jet_columns(V, ctx, lay)
        return V.T
