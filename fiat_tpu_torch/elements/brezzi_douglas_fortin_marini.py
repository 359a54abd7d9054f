"""The BDFM element: BDM_k with the facet normal components reduced to
degree k-1.  Counterpart of
``fiat_tpu/elements/brezzi_douglas_fortin_marini.py``."""

from ..core.expansions import polynomial_dimension
from .brezzi_douglas_marini import BrezziDouglasMarini
from .nodal_enriched import NodalEnrichedElement
from .restricted import RestrictedElement


def BrezziDouglasFortinMarini(ref_el, degree, variant=None, quad_scheme=None):
    """The BDFM element.

    Integral variant: keep, per facet, only the BDM_k moments against
    the degree-(k-1) facet basis (the leading block of each facet's dof
    ids, since moment dofs are ordered by basis degree), plus every
    interior dof.  Point variant: interior of BDM_k enriched by the
    facet part of BDM_{k-1}.
    """
    if variant == "point":
        parts = (("interior", degree), ("facet", degree - 1))
        return NodalEnrichedElement(*(
            RestrictedElement(BrezziDouglasMarini(ref_el, deg,
                                                  variant="point"),
                              restriction_domain=dom)
            for dom, deg in parts))

    bdm = BrezziDouglasMarini(ref_el, degree, variant=variant,
                              quad_scheme=quad_scheme)
    fdim = ref_el.get_spatial_dimension() - 1
    nkeep = polynomial_dimension(ref_el.construct_subelement(fdim),
                                 degree - 1)
    keep = [i
            for dim, ents in sorted(bdm.dual.get_entity_ids().items())
            for _, ids in sorted(ents.items())
            for i in (ids[:nkeep] if dim == fdim else ids)]
    return RestrictedElement(bdm, keep)
