"""Counterpart of ``fiat_tpu/symbolic/johnson_mercier.py``. Johnson-Mercier
symmetric-stress macroelement. Behavioural parity: FInAT's
``finat/johnson_mercier.py``, on the shared zany engine."""

from .. import elements as fe
from .fiat_bridge import FiatElement
from .physically_mapped import PhysicallyMappedElement, identity
from .zany import ZanyCtx, facet_moment_block


class JohnsonMercier(PhysicallyMappedElement, FiatElement):
    """Facet stress moments + interior moments (interior untransformed)."""

    def __init__(self, cell, degree=1, variant=None, quad_scheme=None):
        self._indices = slice(None, None)
        super().__init__(fe.JohnsonMercier(cell, degree, variant=variant,
                                           quad_scheme=quad_scheme))

    def basis_transformation(self, coordinate_mapping):
        ctx = ZanyCtx(self.cell, coordinate_mapping)
        V = identity(self._element.space_dimension(),
                     self.space_dimension())
        F = facet_moment_block(ctx, 1)[:, self._indices]
        V[:F.shape[0], :F.shape[1]] = F
        return V.T
