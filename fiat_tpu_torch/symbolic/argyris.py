"""Counterpart of ``fiat_tpu/symbolic/argyris.py``. Argyris: quintic C1
element with vertex 2-jets and edge normal moments. Behavioural parity:
FInAT's ``finat/argyris.py``, on the shared zany context/layout engine."""

from .. import elements as fe
from .citations import cite
from .fiat_bridge import ScalarFiatElement
from .physically_mapped import PhysicallyMappedElement, as_scalar, identity
from .zany import (JetLayout, ZanyCtx, edge_moment_rows, jet_couple,
                   put_vertex_jets, scale_jet_columns)

# point-variant edge rows couple into the endpoint 2-jets with these
# Bnt weights per jet order (from the quintic Hermite-type expansion)
_POINT_EDGE_JET = (15 / 8, -7 / 16, 1 / 32)


class Argyris(PhysicallyMappedElement, ScalarFiatElement):
    """Physically-mapped Argyris of any degree >= 5 (integral variant)
    or exactly 5 (point variant)."""

    def __init__(self, cell, degree=5, variant=None, avg=False):
        cite("Argyris1968")
        variant = variant or "integral"
        if variant == "point" and degree != 5:
            raise NotImplementedError(
                "Degree must be 5 for 'point' variant of Argyris")
        self.variant = variant
        self.avg = avg
        super().__init__(fe.Argyris(cell, degree, variant=variant))

    def basis_transformation(self, coordinate_mapping):
        ctx = ZanyCtx(self.cell, coordinate_mapping)
        eorder = self.degree - 5
        V = identity(self.space_dimension())
        put_vertex_jets(V, ctx, 2)

        if self.variant == "integral":
            lay = JetLayout(self.cell, 2, erows=2 * eorder + 1)
            edge_moment_rows(V, ctx, lay, eorder, avg=self.avg)
        else:
            lay = JetLayout(self.cell, 2, erows=eorder + 1)
            pel = ctx.edge_lengths
            for e in sorted(self.cell.get_topology()[1]):
                jet_couple(V, ctx, e, lay.erow(e), _POINT_EDGE_JET, lay,
                           diag=lambda Bnn, e=e: Bnn * pel[e])

        scale_jet_columns(V, ctx, lay)
        if self.variant == "point":
            h = ctx.h
            for e, verts in sorted(self.cell.get_topology()[1].items()):
                havg = sum(h[v] for v in verts) / len(verts)
                V[:, lay.erow(e):lay.erow(e) + eorder + 1] *= as_scalar(1 / havg)
        return V.T
