"""Discontinuous Lagrange.

Counterpart of ``fiat_tpu/elements/discontinuous_lagrange.py``: all DoFs
attached to the cell interior; points either on the full
boundary-including lattice ('broken' numbering with geometric DG
orientation permutations) or on interior point families (gl/gc), one
lattice per subcell on a split complex.
"""

import math
from itertools import permutations as _permutations

import numpy as np

from ..core import cells as cl
from ..core import finite_element, polyset
from ..core.barycentric import LagrangePolynomialSet, get_lagrange_points
from ..core.dual_builder import DualBuilder
from ..core.expansions import mis
from ..core.functionals import PointEvaluation
from ..core.orientation import make_entity_permutations_simplex
from ..core.variants import parse_lagrange_variant
from .p0 import P0


def make_entity_permutations(dim, npoints):
    """Orientation permutations for broken (DG) DoFs, numbered first by
    entity dimension, then entity id, then lexicographically -- so they
    geometrically coincide with the CG DoFs of the same lattice."""
    if npoints <= 0:
        return {o: [] for o in range(math.factorial(dim + 1))}
    a = np.array(sorted(mis(dim + 1, npoints - 1)), dtype=int)[:, ::-1]

    # group key 0: dimension of the entity each lattice point lives on
    g0 = dim - (a == 0).astype(int).sum(axis=1)
    # group key 1: entity id (facets opposite vertex d are numbered d;
    # vertices run in the opposite order)
    g1 = np.zeros_like(g0)
    for d in range(dim + 1):
        g1 += d * (a[:, d] == 0).astype(int)
    g1[g0 == 0] = -g1[g0 == 0]

    dg_to_lattice = np.lexsort(np.transpose(np.concatenate(
        (a, g1.reshape(-1, 1), g0.reshape(-1, 1)), axis=1)))
    lattice_to_dg = np.empty_like(dg_to_lattice)
    lattice_to_dg[dg_to_lattice] = np.arange(len(dg_to_lattice))

    perms = {}
    for o, index_perm in enumerate(sorted(_permutations(range(dim + 1)))):
        perm = np.lexsort(np.transpose(a[:, index_perm]))
        perms[o] = lattice_to_dg[perm][dg_to_lattice].tolist()
    return perms


def _per_dim_perms(b, make_perms, degree):
    """{dim: {entity: perms}} with live permutations only on the cell."""
    cell_dim = max(b.top)
    return {dim: {e: make_perms(dim, degree + 1 if dim == cell_dim else -1)
                  for e in b.entities(dim)}
            for dim in sorted(b.top)}


def _broken_dual(ref_el, degree, point_variant):
    """Boundary-including lattice walked in CG (dim, entity) order, every
    DoF credited to the cell interior."""
    b = DualBuilder(ref_el)
    cell_dim = max(b.top)
    b.tag(cell_dim, 0,
          (PointEvaluation(ref_el, x)
           for dim in sorted(b.top)
           for e in b.entities(dim)
           for x in b.lattice(dim, e, degree, variant=point_variant)))
    return b.dual_set(permutations=_per_dim_perms(b, make_entity_permutations, degree))


def _interior_dual(ref_el, degree, point_variant):
    """Interior point families (gl/gc): one lattice per top-level cell
    (a split complex has several)."""
    b = DualBuilder(ref_el)
    cell_dim = max(b.top)
    for e in b.entities(cell_dim):
        verts = ref_el.get_vertices_of_subcomplex(b.top[cell_dim][e])
        b.tag(cell_dim, e,
              (PointEvaluation(ref_el, x)
               for x in cl.make_lattice(verts, degree, variant=point_variant)))
    return b.dual_set(permutations=_per_dim_perms(b, make_entity_permutations_simplex, degree))


class DiscontinuousLagrange(finite_element.CiarletElement):
    """Discontinuous Lagrange; degree 0 degenerates to P0, except on a
    split complex (one constant per subcell)."""

    def __new__(cls, ref_el, degree, variant="equispaced"):
        if degree == 0:
            splitting, _ = parse_lagrange_variant(variant, discontinuous=True)
            if splitting is None and not ref_el.is_macrocell():
                return P0(ref_el)
        return super().__new__(cls)

    def __init__(self, ref_el, degree, variant="equispaced"):
        splitting, point_variant = parse_lagrange_variant(variant, discontinuous=True)
        if splitting is not None:
            ref_el = splitting(ref_el)
        if point_variant in ("equispaced", "gll", "lgc"):
            dual = _broken_dual(ref_el, degree, point_variant)
        else:
            dual = _interior_dual(ref_el, degree, point_variant)
        if ref_el.shape == cl.LINE:
            poly_set = LagrangePolynomialSet(ref_el, get_lagrange_points(dual))
        else:
            poly_set = polyset.ONPolynomialSet(ref_el, degree)
        super().__init__(poly_set, dual, degree, formdegree=ref_el.get_spatial_dimension())
