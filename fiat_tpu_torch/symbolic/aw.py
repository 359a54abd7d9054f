"""Counterpart of ``fiat_tpu/symbolic/aw.py``. Arnold-Winther
conforming/nonconforming symmetric-stress elements. Behavioural parity:
FInAT's ``finat/aw.py``, on the shared zany engine (facet_moment_block /
sym_eval_block)."""

from .. import elements as fe
from .citations import cite
from .fiat_bridge import FiatElement
from .physically_mapped import PhysicallyMappedElement, as_scalar, identity
from .zany import ZanyCtx, facet_moment_block, sym_eval_block


class ArnoldWintherNC(PhysicallyMappedElement, FiatElement):
    def __init__(self, cell, degree=2):
        cite("ArnoldWinther2002")
        super().__init__(fe.ArnoldWintherNC(cell, degree))

    def basis_transformation(self, coordinate_mapping):
        ctx = ZanyCtx(self.cell, coordinate_mapping)
        # 15 dofs + 3 constraint rows; facet moments fill the first 12
        V = identity(self._element.space_dimension(),
                     self.space_dimension())
        F = facet_moment_block(ctx, 1)
        V[:len(F), :len(F)] = F
        return V.T

    def entity_dofs(self):
        edges = {e: list(range(4 * e, 4 * e + 4)) for e in range(3)}
        return {0: {v: [] for v in range(3)}, 1: edges,
                2: {0: [12, 13, 14]}}

    def space_dimension(self):
        return 15


class ArnoldWinther(PhysicallyMappedElement, FiatElement):
    def __init__(self, cell, degree=3):
        cite("ArnoldWinther2002")
        super().__init__(fe.ArnoldWinther(cell, degree))

    def basis_transformation(self, coordinate_mapping):
        ctx = ZanyCtx(self.cell, coordinate_mapping)
        # 24 dofs + 6 constraint rows
        V = identity(self._element.space_dimension(),
                     self.space_dimension())
        W = sym_eval_block(ctx)
        nc = len(W)
        nverts = ctx.sd + 1
        for v in range(nverts):
            V[nc * v:nc * (v + 1), nc * v:nc * (v + 1)] = W
        F = facet_moment_block(ctx, 1)
        lo = nverts * nc
        V[lo:lo + len(F), lo:lo + len(F)] = F

        # conditioning rescale (edge moments already length-scaled)
        h = ctx.h
        for v in range(nverts):
            V[:, nc * v:nc * (v + 1)] *= as_scalar(1 / (h[v] * h[v]))
        return V.T

    def entity_dofs(self):
        verts = {v: list(range(3 * v, 3 * v + 3)) for v in range(3)}
        edges = {e: list(range(9 + 4 * e, 13 + 4 * e)) for e in range(3)}
        return {0: verts, 1: edges, 2: {0: [21, 22, 23]}}

    def space_dimension(self):
        return 24
