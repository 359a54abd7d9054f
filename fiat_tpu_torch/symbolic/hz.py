"""Counterpart of ``fiat_tpu/symbolic/hz.py``. Hu-Zhang symmetric-stress
element. Behavioural parity: FInAT's ``finat/hz.py``, on the shared zany
engine."""

from .. import elements as fe
from .citations import cite
from .fiat_bridge import FiatElement
from .physically_mapped import PhysicallyMappedElement, as_scalar, identity
from .zany import ZanyCtx, facet_moment_block, sym_eval_block


class HuZhang(PhysicallyMappedElement, FiatElement):
    def __init__(self, cell, degree=3, variant=None, quad_scheme=None):
        cite("ArnoldWinther2002")
        self.variant = variant
        super().__init__(fe.HuZhang(cell, degree, variant=variant,
                                    quad_scheme=quad_scheme))

    def basis_transformation(self, coordinate_mapping):
        ctx = ZanyCtx(self.cell, coordinate_mapping)
        n = self.space_dimension()
        V = identity(n)
        W = sym_eval_block(ctx)
        nc = len(W)
        nverts = ctx.sd + 1
        for v in range(nverts):
            V[nc * v:nc * (v + 1), nc * v:nc * (v + 1)] = W
        F = facet_moment_block(ctx, self.degree - 2)
        lo = nverts * nc
        V[lo:lo + len(F), lo:lo + len(F)] = F
        lo += len(F)
        if self.variant == "point":
            # interior point evaluations transform like the vertex ones
            while lo < n:
                V[lo:lo + nc, lo:lo + nc] = W
                lo += nc
        h = ctx.h
        for v in range(nverts):
            V[:, nc * v:nc * (v + 1)] *= as_scalar(1 / (h[v] * h[v]))
        return V.T
