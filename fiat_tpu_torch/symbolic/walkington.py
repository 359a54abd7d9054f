"""Counterpart of ``fiat_tpu/symbolic/walkington.py``. Walkington C1
tetrahedral macroelement: vertex 2-jets, face normal moments, and edge
constraint rows recombined through the dual's nodal completion.
Behavioural parity: FInAT's ``finat/walkington.py``, on the shared zany
engine."""

import numpy as np

from .. import elements as fe
from .citations import cite
from .fiat_bridge import ScalarFiatElement
from .physically_mapped import PhysicallyMappedElement, as_scalar, identity
from .zany import (JetLayout, ZanyCtx, as_obj, jet_couple, put_vertex_jets,
                   sym_powers)

# face-row couplings into the surrounding vertex jets, per jet order:
# symmetric in the endpoints for even orders, v1-negated for odd
_FACE_JET = (1.0, 1 / 5, 1 / 60)
# edge constraint-row couplings (the 2D Bell pattern, per face edge)
_EDGE_JET = (1 / 21, -1 / 42, 1 / 252)


class Walkington(PhysicallyMappedElement, ScalarFiatElement):
    def __init__(self, cell, degree=5):
        cite("Kirby2019zany")
        super().__init__(fe.Walkington(cell, degree=degree))
        dofs = {dim: dict(ent)
                for dim, ent in self._element.entity_dofs().items()}
        sd = cell.get_spatial_dimension()
        dofs[sd - 1] = {f: ids[:1] for f, ids in dofs[sd - 1].items()}
        self._entity_dofs = dofs

    def entity_dofs(self):
        # FIAT reports 65 rows; the element exposes 45
        return self._entity_dofs

    def space_dimension(self):
        return 45

    def basis_transformation(self, coordinate_mapping):
        ctx = ZanyCtx(self.cell, coordinate_mapping)
        sd = ctx.sd
        top = self.cell.get_topology()
        ids = self._element.entity_dofs()
        face_edges = self.cell.get_connectivity()[(2, 1)]
        lay = JetLayout(self.cell, 2)

        V = identity(self._element.space_dimension(),
                     self.space_dimension())
        put_vertex_jets(V, ctx, 2)

        # tangential face constraints, nodally completed
        P = self._element.poly_set
        L = self._element.dual.nodal_completion
        tangential = L.to_riesz(P) @ P.get_coeffs().T
        tangential[abs(tangential) < 1e-10] = 0

        for f, fids in ids[2].items():
            Rnn, Rnt = ctx.face_nn(f)
            frow = fids[0]
            V[frow, frow] = Rnn
            for j, e in enumerate(face_edges[f]):
                _, _, Jt = ctx.edge_nt(e, face=f)
                jet_couple(V, ctx, e, fids[1 + j], _EDGE_JET, lay, face=f)
                # face row picks up the edge's share of each vertex jet
                v0, v1 = top[1][e]
                for k, ck in enumerate(_FACE_JET):
                    vals = [ck * Rnt[j] * p for p in sym_powers(Jt, k)]
                    off = [0, 1, 1 + sd][k]
                    for i, val in enumerate(vals):
                        # no `+=` on an entry: it would add into a tensor
                        # in place, and entries share tensors
                        w0, w1 = ids[0][v0][0] + off + i, ids[0][v1][0] + off + i
                        V[frow, w0] = V[frow, w0] + val
                        V[frow, w1] = V[frow, w1] + (-1) ** k * val

            # recombine with the nodal completion so the constraints hold
            vcols = [i for v in top[2][f] for i in ids[0][v]]
            C = tangential[L.entity_ids[2][f]]
            supp = np.unique(np.nonzero(C)[1])
            C = C.astype(object)
            C[C == 0] = 0.0
            CV = C[:, supp] @ V[np.ix_(supp, vcols)]
            Gnt = as_obj(Rnt[1:])
            c0, c1 = fids[-2:]
            V[c0, vcols] = -1 * Gnt @ CV[[0, 1]]
            V[c1, vcols] = -1 * Gnt @ CV[[1, 2]]

        h = ctx.h
        for v, vids in sorted(ids[0].items()):
            V[:, vids[1:1 + sd]] *= as_scalar(1 / h[v])
            V[:, vids[1 + sd:]] *= as_scalar(1 / (h[v] * h[v]))
        return V.T
