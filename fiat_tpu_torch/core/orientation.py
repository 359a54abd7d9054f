"""Entity-orientation <-> DoF permutation maps.

Counterpart of ``fiat_tpu/core/orientation.py``: an orientation of a
dim-simplex entity is the index of its vertex permutation in sorted order;
the permutation arrays map entity-local DoF order to the canonical order.
Tensor-product entities compose their factors' maps under the axis
permutations of their extrinsic orientations; the reflection maps say
which cell orientations reverse it.  Small static integer tables.
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


def _make_axis_perms_tensorproduct(cells, dim):
    """Axis permutations realising the extrinsic orientations of a tensor
    product (identity unless all factors are intervals)."""
    from .cells import UFCInterval
    nprod = len(cells)
    if len(set(cells)) == nprod:
        return (tuple(range(nprod)),)
    if len(set(cells)) == 1 and isinstance(cells[0], UFCInterval):
        axis_perms = sorted(itertools.permutations(range(nprod)))
        for idim, d in enumerate(dim):
            if d == 0:
                axis_perms = [ap for ap in axis_perms if ap[idim] == idim]
        return axis_perms
    raise NotImplementedError("Extrinsic orientations only implemented for all-distinct or "
                              "all-interval tensor products")


def make_entity_permutations_tensorproduct(cells, dim, o_p_maps):
    """Compose factor orientation-permutation maps into the product map,
    keyed by (extrinsic orientation, *factor orientations)."""
    nprod = len(o_p_maps)
    axis_perms = _make_axis_perms_tensorproduct(cells, dim)
    result = {}
    for eo, ap in enumerate(axis_perms):
        for o_tuple in itertools.product(*[m.keys() for m in o_p_maps]):
            ps = [m[o] for m, o in zip(o_p_maps, o_tuple)]
            shape = [0] * nprod
            for idim in range(len(ap)):
                shape[ap[idim]] = len(ps[idim])
            size = int(np.prod(shape))
            if size == 0:
                result[(eo,) + o_tuple] = []
                continue
            a = np.arange(size).reshape(shape)
            for idim, p in enumerate(ps):
                a = a.swapaxes(0, ap[idim])[p, :].swapaxes(0, ap[idim])
            apinv = list(range(nprod))
            for idim in range(len(ap)):
                apinv[ap[idim]] = idim
            a = np.moveaxis(a, range(nprod), apinv)
            result[(eo,) + o_tuple] = a.reshape(-1).tolist()
    return result


def check_permutation_even_or_odd(perm):
    """0 for an even permutation of range(len(perm)), 1 for odd."""
    perm = list(perm)
    count = 0
    for i in range(len(perm)):
        if perm[i] != i:
            j = perm.index(i)
            perm[j], perm[i] = perm[i], i
            count += 1
    return count % 2


def make_cell_orientation_reflection_map_simplex(dim):
    """{orientation: 1 if it reflects the cell, else 0}."""
    perms = make_entity_permutations_simplex(dim, 2)
    out = {o: check_permutation_even_or_odd(p) for o, p in perms.items()}
    assert out[0] == 0
    return out


def make_cell_orientation_reflection_map_tensorproduct(cells):
    """{(extrinsic, *factor orientations): 1 if it reflects the product}."""
    dim = [cell.get_dimension() for cell in cells]
    axis_perms = _make_axis_perms_tensorproduct(cells, dim)
    out = {}
    for eo, ap in enumerate(axis_perms):
        reflected_eo = check_permutation_even_or_odd(ap)
        for o_tuple in itertools.product(
                *[cell.cell_orientation_reflection_map().keys() for cell in cells]):
            refls = [cell.cell_orientation_reflection_map()[o] for cell, o in zip(cells, o_tuple)]
            out[(eo,) + o_tuple] = (reflected_eo + sum(refls)) % 2
    return out
