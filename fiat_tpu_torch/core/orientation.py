"""Entity-orientation <-> DoF permutation maps on simplices.

Counterpart of ``fiat_tpu/core/orientation.py`` (the simplex entity
permutations the Lagrange and DG duals use): an
orientation of a dim-simplex entity is the index of its vertex permutation
in sorted order; the permutation arrays map entity-local DoF order to the
canonical order.  Small static integer tables.
"""

import itertools
import math

import numpy as np


def _interior_multiindices(dim, npoints):
    """Lattice multi-indices (dim+1 barycentric entries summing to
    npoints-1) sorted ascending, with components reversed -- the canonical
    DoF order of interior lattice points."""
    def gen(m, total):
        if m == 1:
            yield (total,)
            return
        for i in range(total + 1):
            for rest in gen(m - 1, i):
                yield (total - i,) + rest
    return np.array(sorted(gen(dim + 1, npoints - 1)), dtype=int)[:, ::-1]


def make_entity_permutations_simplex(dim, npoints):
    """For each orientation o (an index into the sorted vertex
    permutations), the permutation taking the o-oriented lattice DoFs to
    the canonical ones."""
    if npoints <= 0:
        return {o: [] for o in range(math.factorial(dim + 1))}
    a = _interior_multiindices(dim, npoints)
    out = {}
    for o, vperm in enumerate(sorted(itertools.permutations(range(dim + 1)))):
        out[o] = np.lexsort(a[:, vperm].T).tolist()
    return out
