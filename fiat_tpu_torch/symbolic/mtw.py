"""Counterpart of ``fiat_tpu/symbolic/mtw.py``. Mardal-Tai-Winther element.
Behavioural parity: FInAT's ``finat/mtw.py``, on the shared zany engine."""

from math import comb

from .. import elements as fe
from .citations import cite
from .fiat_bridge import FiatElement
from .physically_mapped import PhysicallyMappedElement, assign, identity
from .zany import ZanyCtx


class MardalTaiWinther(PhysicallyMappedElement, FiatElement):
    def __init__(self, cell, order=1):
        cite("Mardal2002")
        super().__init__(fe.MardalTaiWinther(cell, order=order))

    def basis_transformation(self, coordinate_mapping):
        ctx = ZanyCtx(self.cell, coordinate_mapping)
        sd = ctx.sd
        q = self._element.order
        n_normal = comb(q + sd - 1, q)
        V = identity(self.space_dimension())
        for f, ids in sorted(self.entity_dofs()[sd - 1].items()):
            Bnt, Btt = ctx.facet_nt(f)
            normal, tangential = ids[:n_normal], ids[n_normal:]
            assign(V, (tangential, tangential), Btt)
            if sd == 2:
                assign(V, (tangential, normal[0]), Bnt)
            else:
                assign(V, (tangential[:-1], normal[0]), Bnt)
                assign(V, (tangential[-1], normal[1:comb(sd, 1)]), Bnt)
        return V.T
