"""Counterpart of ``fiat_tpu/symbolic/morley.py``. Morley: facet normal
derivatives + codim-2 vertex/edge values. Behavioural parity: FInAT's
``finat/morley.py``, on the shared zany engine (the 3D face frame lives
in ZanyCtx.face_nn)."""

from .. import elements as fe
from .citations import cite
from .fiat_bridge import ScalarFiatElement
from .physically_mapped import (PhysicallyMappedElement, as_scalar, assign,
                                identity)
from .zany import ZanyCtx, _on


class Morley(PhysicallyMappedElement, ScalarFiatElement):
    def __init__(self, cell, degree=2):
        cite("Morley1971")
        super().__init__(fe.Morley(cell, degree=degree))

    def basis_transformation(self, coordinate_mapping):
        ctx = ZanyCtx(self.cell, coordinate_mapping)
        sd = ctx.sd
        top = self.cell.get_topology()
        nvals = len(top[sd - 2])
        V = identity(self.space_dimension())

        if sd == 2:
            for e, everts in top[1].items():
                Jn = ctx.J @ _on(self.cell.compute_normal(e), ctx.J)
                r = nvals + e
                V[r, r] = Jn @ ctx.phys_normals[e]
                tangential = (Jn @ ctx.phys_tangents[e]) \
                    / ctx.edge_lengths[e]
                v0, v1 = everts
                V[r, v0] = -1 * tangential
                V[r, v1] = tangential
        else:
            face_edges = self.cell.get_connectivity()[(sd - 1, sd - 2)]
            for f in top[sd - 1]:
                Bnn, Bnt = ctx.face_nn(f)
                r = nvals + f
                V[r, r] = Bnn
                assign(V, (r, list(face_edges[f])), Bnt)

        h = ctx.h
        for f, fverts in top[sd - 1].items():
            havg = sum(h[v] for v in fverts) / len(fverts)
            V[:, nvals + f] *= as_scalar(1 / havg)
        return V.T
