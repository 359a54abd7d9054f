"""P0: the piecewise-constant element.

Counterpart of ``fiat_tpu/elements/p0.py``: one barycenter evaluation,
with trivial orientation permutations throughout (on a product cell the
orientations of an entity are tuples, one entry a factor).
"""

import numpy as np

from ..core import finite_element, functionals, polyset
from ..core.dualset import DualSet


def _identity_perms(ref_el, dim, n):
    """Identity dof permutation for every orientation of an entity (a
    constant is orientation-blind)."""
    size = ref_el.symmetry_group_size(dim)
    orients = np.ndindex(size) if isinstance(dim, tuple) else range(size)
    return {o: list(range(n)) for o in orients}


class P0Dual(DualSet):
    def __init__(self, ref_el):
        sd = ref_el.get_dimension()
        top = ref_el.get_topology()
        verts = np.asarray(ref_el.get_vertices()) if sd != 0 else None
        centers = [() if sd == 0 else tuple(verts[list(top[sd][c])].mean(axis=0))
                   for c in sorted(top[sd])]
        nodes = [functionals.PointEvaluation(ref_el, x) for x in centers]
        entity_ids = {dim: {e: ([e] if dim == sd else []) for e in sorted(top[dim])}
                      for dim in sorted(top)}
        entity_permutations = {
            dim: dict.fromkeys(sorted(top[dim]), _identity_perms(ref_el, dim, 1 if dim == sd else 0))
            for dim in sorted(top)}
        super().__init__(nodes, ref_el, entity_ids, entity_permutations)


class P0(finite_element.CiarletElement):
    def __init__(self, ref_el):
        super().__init__(polyset.ONPolynomialSet(ref_el, 0), P0Dual(ref_el),
                         0, ref_el.get_spatial_dimension())
