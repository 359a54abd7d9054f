"""DPC: discontinuous P_k on hypercubes.

Counterpart of ``fiat_tpu/elements/discontinuous_pc.py``: the simplex
polynomial space presented on the hypercube, nodes at an equispaced
simplex lattice affinely embedded in the cube, all DoFs on the cell
interior.
"""

import numpy as np

from ..core import finite_element, functionals, polyset
from ..core.cells import (DefaultLine, Point, UFCHexahedron, UFCInterval,
                          UFCQuadrilateral, UFCTetrahedron, UFCTriangle,
                          flatten_reference_cube, make_affine_mapping)
from ..core.dualset import DualSet
from .p0 import P0Dual


def _simplex_for(flat_el):
    table = {Point: Point, DefaultLine: DefaultLine, UFCInterval: UFCInterval,
             UFCQuadrilateral: UFCTriangle, UFCHexahedron: UFCTetrahedron}
    return table[type(flat_el)]()


def _embedding(simplex, flat_el):
    """Affine image of the model simplex inside the hypercube: corner 0
    and the mid-index corner anchor the first edge; each further vertex
    lands at an even-corner average shifted by one remaining corner."""
    vh = np.asarray(flat_el.get_vertices())
    dim = flat_el.get_dimension()
    center = vh[::2].mean(axis=0)
    targets = [vh[0], vh[len(vh) // 2]]
    targets += [tuple(vh[dim - d] + center) for d in range(1, dim)]
    return make_affine_mapping(simplex.get_vertices(),
                               tuple(map(tuple, targets)))


class DPCDualSet(DualSet):
    """Equispaced simplex-lattice points mapped into the hypercube; all
    DoFs on the cell interior."""

    def __init__(self, ref_el, flat_el, degree):
        simplex = _simplex_for(flat_el)
        A, b = _embedding(simplex, flat_el)
        top = simplex.get_topology()
        pts = [p for dim in sorted(top) for e in sorted(top[dim])
               for p in simplex.make_points(dim, e, degree)]
        mapped = np.asarray(pts) @ A.T + b
        nodes = [functionals.PointEvaluation(flat_el, tuple(x))
                 for x in mapped]

        cube_top = ref_el.get_topology()
        entity_ids = {dim: {e: (list(range(len(nodes)))
                                if (dim, e) == (max(cube_top), 0) else [])
                            for e in sorted(cube_top[dim])}
                      for dim in sorted(cube_top)}
        super().__init__(nodes, ref_el, entity_ids)


class DPC0(finite_element.CiarletElement):
    def __init__(self, ref_el):
        flat_el = flatten_reference_cube(ref_el)
        dual = P0Dual(ref_el)
        dual.entity_permutations = None   # pending extrinsic-orientation entry
        super().__init__(
            poly_set=polyset.ONPolynomialSet(_simplex_for(flat_el), 0),
            dual=dual, order=0, ref_complex=ref_el,
            formdegree=ref_el.get_spatial_dimension())


class HigherOrderDPC(finite_element.CiarletElement):
    """The DPC element for degree >= 1."""

    def __init__(self, ref_el, degree):
        flat_el = flatten_reference_cube(ref_el)
        super().__init__(
            poly_set=polyset.ONPolynomialSet(_simplex_for(flat_el), degree),
            dual=DPCDualSet(ref_el, flat_el, degree),
            order=degree, ref_complex=ref_el,
            formdegree=flat_el.get_spatial_dimension())


def DPC(ref_el, degree):
    return DPC0(ref_el) if degree == 0 else HigherOrderDPC(ref_el, degree)
