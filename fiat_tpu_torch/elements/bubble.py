"""(Facet)Bubble elements: entity-interior restrictions of Lagrange.

Counterpart of ``fiat_tpu/elements/bubble.py``; the 'integral' variants
restrict IntegratedLegendre instead.
"""

from .lagrange import Lagrange
from .restricted import RestrictedElement


def _host_element(ref_el, degree, variant, quad_scheme):
    if variant and variant.startswith("integral"):
        from .hierarchical import IntegratedLegendre
        return IntegratedLegendre(ref_el, degree, variant=variant,
                                  quad_scheme=quad_scheme)
    return Lagrange(ref_el, degree, variant=variant or "equispaced")


class CodimBubble(RestrictedElement):
    """The host element's DoFs interior to entities of one codimension."""

    def __init__(self, ref_el, degree, codim, variant=None, quad_scheme=None):
        host = _host_element(ref_el, degree, variant, quad_scheme)
        dim = ref_el.get_dimension() - codim
        dofs = sorted(d for ids in host.entity_dofs()[dim].values()
                      for d in ids)
        if not dofs:
            raise RuntimeError(
                f"Bubble element of degree {degree} and codimension {codim} "
                f"has no dofs")
        super().__init__(host, indices=dofs)


class Bubble(CodimBubble):
    """Interior DoFs of Lagrange."""

    def __init__(self, ref_el, degree, variant=None, quad_scheme=None):
        super().__init__(ref_el, degree, codim=0, variant=variant,
                         quad_scheme=quad_scheme)


class FacetBubble(CodimBubble):
    """Facet-interior DoFs of Lagrange."""

    def __init__(self, ref_el, degree, variant=None, quad_scheme=None):
        super().__init__(ref_el, degree, codim=1, variant=variant,
                         quad_scheme=quad_scheme)
