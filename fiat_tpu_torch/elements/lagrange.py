"""Lagrange elements.

Counterpart of ``fiat_tpu/elements/lagrange.py``: point evaluation at
recursively-defined lattice points of every entity, on simplices and on
their split complexes; 1D uses the exact
barycentric nodal basis, higher dimensions the C0 bubble expansion.
"""

from ..core import cells as cl
from ..core import finite_element, polyset
from ..core.barycentric import LagrangePolynomialSet, get_lagrange_points
from ..core.dual_builder import DualBuilder
from ..core.orientation import make_entity_permutations_simplex
from ..core.variants import parse_lagrange_variant


def lagrange_permutations(ref_el, degree):
    """Per-entity orientation permutations of an interior lattice of the
    given degree (shared by all entities of one dimension)."""
    top = ref_el.get_topology()
    return {dim: dict.fromkeys(
                sorted(top[dim]),
                {0: [0]} if dim == 0
                else make_entity_permutations_simplex(dim, degree - dim))
            for dim in sorted(top)}


def LagrangeDualSet(ref_el, degree, point_variant="equispaced",
                    sort_entities=False):
    """Point evaluations at recursive lattice points of every entity.
    With ``sort_entities`` the entity schedule is ordered by support
    vertex ids instead of (dimension, entity id)."""
    top = ref_el.get_topology()
    schedule = [(dim, e) for dim in sorted(top) for e in sorted(top[dim])]
    if sort_entities:
        schedule.sort(key=lambda de: top[de[0]][de[1]])
    b = DualBuilder(ref_el)
    for dim, e in schedule:
        b.point_evals(dim, e, degree, variant=point_variant)
    return b.dual_set(permutations=lagrange_permutations(ref_el, degree))


class Lagrange(finite_element.CiarletElement):
    """The Lagrange element.  ``variant`` may combine a point distribution
    ('equispaced', 'gll', 'spectral', ...) and a macro splitting ('Alfeld',
    'Worsey-Farin', 'Powell-Sabin', 'Powell-Sabin(12)', 'Iso', 'Iso(k)'):
    on a split, the C0 bubble expansion set of the complex."""

    def __init__(self, ref_el, degree, variant="equispaced", sort_entities=False):
        splitting, point_variant = parse_lagrange_variant(variant)
        if splitting is not None:
            ref_el = splitting(ref_el)
        dual = LagrangeDualSet(ref_el, degree, point_variant=point_variant,
                               sort_entities=sort_entities)
        if ref_el.shape == cl.LINE:
            # 1D: the nodal basis IS the expansion basis
            poly_set = LagrangePolynomialSet(ref_el, get_lagrange_points(dual))
        else:
            poly_set = polyset.ONPolynomialSet(ref_el, degree, variant="bubble", scale=1)
        super().__init__(poly_set, dual, degree, formdegree=0)
