"""Counterpart of ``fiat_tpu/symbolic/stokes_macro.py``. Divergence-free
Stokes macroelement transformations: Bernardi-Raugel, Christiansen-Hu,
Arnold-Qin, Alfeld-Sorokina, and the Guzman-Neilan families. All
facet-bubble members ride ``PiolaBubbleElement``; Alfeld-Sorokina only
un-Piolas its pointwise dofs. Behavioural parity: FInAT's
``finat/{bernardi_raugel,christiansen_hu,arnold_qin,alfeld_sorokina,guzman_neilan}.py``."""

from .. import elements as fe
from .citations import cite
from .fiat_bridge import FiatElement
from .physically_mapped import PhysicallyMappedElement, identity
from .zany import PiolaBubbleElement, ZanyCtx, unmap_piola_rows


class BernardiRaugel(PiolaBubbleElement):
    """Pk^d plus normal facet bubbles."""

    def __init__(self, cell, order=1, quad_scheme=None):
        cite("Mardal2002")
        super().__init__(fe.BernardiRaugel(cell, order=order,
                                           quad_scheme=quad_scheme))


class BernardiRaugelBubble(BernardiRaugel):
    """The facet-bubble part alone (order 0)."""

    def __init__(self, cell, degree=None, quad_scheme=None):
        super().__init__(cell, order=0, quad_scheme=quad_scheme)


class ChristiansenHu(PiolaBubbleElement):
    def __init__(self, cell, degree=1):
        cite("GuzmanNeilan2019")
        super().__init__(fe.ChristiansenHu(cell, degree))


class ArnoldQin(FiatElement):
    """Affine-mapped; needs no basis transformation."""

    def __init__(self, cell, degree=2):
        cite("GuzmanNeilan2019")
        super().__init__(fe.ArnoldQin(cell, degree))


class ReducedArnoldQin(PiolaBubbleElement):
    """Piola-mapped with the tangential facet dofs constrained away."""

    def __init__(self, cell, degree=2):
        cite("GuzmanNeilan2019")
        super().__init__(fe.ArnoldQin(cell, degree, reduced=True))


class AlfeldSorokina(PhysicallyMappedElement, FiatElement):
    """C0 P2(Alfeld) vector element: pointwise vector dofs un-Piola by
    adj(J), divergence dofs rescale by detJ."""

    def __init__(self, cell, degree=2):
        cite("GuzmanNeilan2019")
        super().__init__(fe.AlfeldSorokina(cell, degree))

    def basis_transformation(self, coordinate_mapping):
        ctx = ZanyCtx(self.cell, coordinate_mapping)
        V = identity(self.space_dimension())
        unmap_piola_rows(V, ctx, self.entity_dofs(),
                         self._element.get_dual_set().nodes)
        return V.T


def _gn(fiat_cls):
    """A PiolaBubbleElement subclass over the given FIAT-layer family."""

    class _GN(PiolaBubbleElement):
        def __init__(self, cell, order=1, quad_scheme=None):
            cite("GuzmanNeilan2019")
            super().__init__(fiat_cls(cell, order=order,
                                      quad_scheme=quad_scheme))
    return _GN


class GuzmanNeilanFirstKindH1(_gn(fe.GuzmanNeilanFirstKindH1)):
    """Pk^d enriched with Guzman-Neilan bubbles."""


class GuzmanNeilanSecondKindH1(_gn(fe.GuzmanNeilanSecondKindH1)):
    """C0 Pk^d(Alfeld) enriched with Guzman-Neilan bubbles."""


class GuzmanNeilanBubble(GuzmanNeilanFirstKindH1):
    """Modified Bernardi-Raugel bubbles (constant divergence)."""

    def __init__(self, cell, degree=None, quad_scheme=None):
        super().__init__(cell, order=0, quad_scheme=quad_scheme)


class GuzmanNeilanH1div(PiolaBubbleElement):
    """Alfeld-Sorokina nodally enriched with Guzman-Neilan bubbles."""

    def __init__(self, cell, degree=None, quad_scheme=None):
        cite("GuzmanNeilan2019")
        super().__init__(fe.GuzmanNeilanH1div(cell, degree=degree,
                                              quad_scheme=quad_scheme))
