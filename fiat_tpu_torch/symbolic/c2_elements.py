"""Counterpart of ``fiat_tpu/symbolic/c2_elements.py``. C2-conforming
elements (Bramble-Zlamal, Alfeld C2): vertex jets to the maximum dual
derivative order plus three graded groups of edge moments (values / dn /
dnn). Behavioural parity: FInAT's ``finat/c2_elements.py``, on the
shared zany engine."""

from math import comb

from .. import elements as fe
from .citations import cite
from .fiat_bridge import ScalarFiatElement
from .physically_mapped import PhysicallyMappedElement, as_scalar, identity
from .zany import ZanyCtx, jet_block_dim, put_vertex_jets


class _C2Base(PhysicallyMappedElement, ScalarFiatElement):
    """The dn rows couple into endpoint values with derivative-Jacobi
    endpoint weights; the dnn rows couple into endpoint gradients through
    the physical normal/tangent hessian frame, and cascade into the
    lower-order moment groups."""

    def basis_transformation(self, coordinate_mapping):
        ctx = ZanyCtx(self.cell, coordinate_mapping)
        ids = self._element.entity_dofs()
        nodes = self._element.dual_basis()
        vorder = max(nodes[i].max_deriv_order for i in ids[0][0])

        V = identity(self.space_dimension())
        put_vertex_jets(V, ctx, vorder)

        n0 = self.degree - 2 * vorder - 1
        groups = {}
        for e in self.cell.get_topology()[1]:
            eids = ids[1][e]
            groups[e] = (eids[:n0], eids[n0:2 * n0 + 1], eids[2 * n0 + 1:])

        for e, everts in self.cell.get_topology()[1].items():
            v0, v1 = everts
            mom0, mom1, mom2 = groups[e]
            B2, beta = ctx.edge_hess(e)
            Bnn, Bnt, _ = ctx.edge_nt(e)
            if self.avg:
                Bnn = Bnn * ctx.edge_lengths[e]

            for k, r in enumerate(mom1, start=1):
                w = comb(k + vorder, k - 1) * (2 * vorder + k + 1)
                V[r, r] = Bnn
                V[r, ids[0][v0][0]] = (-1) ** k * w * Bnt
                V[r, ids[0][v1][0]] = w * Bnt
                if k > 1:
                    V[r, mom0[k - 2]] = -1 * Bnt

            for k, r in enumerate(mom2):
                w = comb(k + vorder, k)
                V[r, r] = B2[0, 0]
                V[r, ids[0][v0][1:ctx.sd + 1]] = -(-1) ** k * w * beta
                V[r, ids[0][v1][1:ctx.sd + 1]] = w * beta
                if k > 0:
                    prev = mom1[k - 1]
                    V[r, prev] = -2 * Bnt * V[prev, prev]
                    V[r, ids[0][v0][0]] = -1 * Bnt * V[prev, ids[0][v0][0]]
                    V[r, ids[0][v1][0]] = -1 * Bnt * V[prev, ids[0][v1][0]]
                if k > 1:
                    V[r, mom0[k - 2]] = -1 * Bnt * V[mom1[k - 1], mom0[k - 2]]

        self._rescale(V, ctx, ids, groups, vorder)
        return V.T

    def _rescale(self, V, ctx, ids, groups, vorder):
        h = ctx.h
        sd = ctx.sd
        for v, vids in ids[0].items():
            scale = 1.0
            lo = 1
            for k in range(1, vorder + 1):
                scale = scale / h[v]
                hi = lo + jet_block_dim(sd, k)
                V[:, vids[lo:hi]] *= as_scalar(scale)
                lo = hi
        for e, everts in self.cell.get_topology()[1].items():
            he = sum(h[v] for v in everts) / len(everts)
            _, mom1, mom2 = groups[e]
            V[:, mom1] *= as_scalar(1 / he)
            V[:, mom2] *= as_scalar(1 / (he * he))


class BrambleZlamalC2(_C2Base):
    def __init__(self, cell, degree=9, avg=True):
        cite("Kirby2019zany")
        self.avg = avg
        super().__init__(fe.BrambleZlamalC2(cell, degree))


class AlfeldC2(_C2Base):
    def __init__(self, cell, degree=5, avg=True):
        cite("Kirby2019zany")
        self.avg = avg
        super().__init__(fe.AlfeldC2(cell, degree))
