"""Counterpart of ``fiat_tpu/symbolic/wuxu.py``. Wu-Xu H3-nonconforming
elements: vertex 1-jets plus first/second normal-derivative edge
moments. Behavioural parity: FInAT's ``finat/wuxu.py``, on the shared
zany engine."""

from .. import elements as fe
from .citations import cite
from .fiat_bridge import ScalarFiatElement
from .physically_mapped import PhysicallyMappedElement, as_scalar, identity
from .zany import ZanyCtx, put_vertex_jets


class _WuXuBase(PhysicallyMappedElement, ScalarFiatElement):
    """Shared Wu-Xu transformation: the edge-moment rows are expressed in
    the physical normal/tangent frame; tangential parts integrate by
    parts into the endpoint jets."""

    def basis_transformation(self, coordinate_mapping):
        ctx = ZanyCtx(self.cell, coordinate_mapping)
        vdofs = self._element.entity_dofs()[0]
        edofs = self._element.entity_dofs()[1]
        V = identity(self.space_dimension())
        put_vertex_jets(V, ctx, 1)

        for e, everts in sorted(self.cell.get_topology()[1].items()):
            v0, v1 = everts
            rows = edofs[e]
            if len(rows) > 1:
                # dn moment: endpoint VALUES absorb the tangential part
                B1, alpha = ctx.edge_grad(e)
                V[rows[0], rows[0]] = B1[0, 0]
                V[rows[0], vdofs[v0][0]] = -1 * alpha
                V[rows[0], vdofs[v1][0]] = alpha
            # dnn moment: endpoint GRADIENTS absorb the tangential part
            B2, beta = ctx.edge_hess(e)
            r = rows[-1]
            V[r, r] = B2[0, 0]
            V[r, vdofs[v0][1:]] = -1 * beta
            V[r, vdofs[v1][1:]] = beta

        h = ctx.h
        for v, ids in sorted(vdofs.items()):
            V[:, ids[1:]] *= as_scalar(1 / h[v])
        for e, everts in sorted(self.cell.get_topology()[1].items()):
            he = sum(h[v] for v in everts) / len(everts)
            V[:, edofs[e][-1]] *= as_scalar(1 / (he * he))
        return V.T


class WuXuRobustH3NC(_WuXuBase):
    def __init__(self, cell, degree=7):
        if degree != 7:
            raise ValueError("Degree must be 7 for robust Wu-Xu element")
        cite("Kirby2019zany")
        super().__init__(fe.WuXuRobustH3NC(cell))


class WuXuH3NC(_WuXuBase):
    def __init__(self, cell, degree=4):
        if degree != 4:
            raise ValueError("Degree must be 4 for the Wu-Xu element")
        cite("Kirby2019zany")
        super().__init__(fe.WuXuH3NC(cell))
