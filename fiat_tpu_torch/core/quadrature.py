"""Quadrature rules on reference cells, array-native.

Counterpart of ``fiat_tpu/core/quadrature.py``: Gauss-Jacobi,
Gauss-Legendre, Gauss-Lobatto-Legendre and Gauss-Radau line rules,
collapsed Duffy simplex rules, rules pushed forward onto facets, and
tensor-product rules on product cells and hypercubes.  Points and weights
are contiguous float64 ndarrays from construction on; an affine pushforward
is one matmul.
"""

import math

import numpy as np

from . import cells as cl
from .orientation import make_entity_permutations_simplex
from .recursive_nodes import (collapsed_gauss_simplex, gauss_jacobi_rule,
                              gauss_lobatto_jacobi_rule)


class QuadratureRule:
    """Integration over a reference cell as a weighted point sum."""

    def __init__(self, ref_el, pts, wts):
        pts = np.ascontiguousarray(pts, dtype=float)
        if pts.ndim != 2:
            pts = pts.reshape(max(len(pts), 1), -1)
        wts = np.ascontiguousarray(wts, dtype=float).ravel()
        if wts.shape[0] != pts.shape[0]:
            raise ValueError(f"Have {wts.shape[0]} weights, but {pts.shape[0]} points")
        self.ref_el = ref_el
        self.pts = pts
        self.wts = wts
        self._intrinsic_orientation_permutation_map_tuple = (None,)

    def get_points(self):
        return self.pts

    def get_weights(self):
        return self.wts

    @property
    def extrinsic_orientation_permutation_map(self):
        return self.ref_el.extrinsic_orientation_permutation_map

    @property
    def intrinsic_orientation_permutation_map_tuple(self):
        if any(m is None for m in self._intrinsic_orientation_permutation_map_tuple):
            raise ValueError("intrinsic orientation permutation maps not set")
        return self._intrinsic_orientation_permutation_map_tuple


def pseudo_determinant(A):
    """sqrt(det(A^T A)): volume scale of a (possibly non-square) affine map."""
    return math.sqrt(abs(np.linalg.det(A.T @ A)))


def affine_pushforward(pts, wts, source_cell, target_cell, avg=False):
    """Push a rule from source_cell to target_cell along the vertex affine
    map.  Returns (points, weights, A): one matmul for the points, one
    pseudo-determinant scale for the weights (skipped when ``avg``)."""
    while source_cell.get_parent():
        source_cell = source_cell.get_parent()
    A, b = cl.make_affine_mapping(source_cell.get_vertices(), target_cell.get_vertices())
    pts = np.asarray(pts, dtype=float).reshape(len(pts), A.shape[1])
    scale = 1.0 if avg else pseudo_determinant(A)
    return pts @ A.T + b, np.asarray(wts, dtype=float).ravel() * scale, A


def map_quadrature(pts_ref, wts_ref, source_cell, target_cell, jacobian=False,
                   avg=False):
    """``affine_pushforward`` returning (points, weights[, A])."""
    pts, wts, A = affine_pushforward(pts_ref, wts_ref, source_cell,
                                     target_cell, avg=avg)
    return (pts, wts, A) if jacobian else (pts, wts)


def _line_rule(ref_el, x, w):
    """A 1D rule given on the default [-1, 1] line, mapped onto ref_el."""
    pts, wts, _ = affine_pushforward(x, w, cl.DefaultLine(), ref_el)
    return pts, wts


class GaussJacobiQuadratureLineRule(QuadratureRule):
    """m-point Gauss-Jacobi rule for weights (a, b) on an interval."""

    def __init__(self, ref_el, m, a=0, b=0):
        super().__init__(ref_el, *_line_rule(ref_el, *gauss_jacobi_rule(m, a, b)))
        # intrinsic orientation o -> inverse point permutation
        perm = np.zeros((math.factorial(2), m), dtype=int)
        for io, p in make_entity_permutations_simplex(1, m).items():
            perm[io, p] = range(m)
        self._intrinsic_orientation_permutation_map_tuple = (perm,)


class GaussLegendreQuadratureLineRule(GaussJacobiQuadratureLineRule):
    def __init__(self, ref_el, m):
        super().__init__(ref_el, m)


class GaussLobattoLegendreQuadratureLineRule(QuadratureRule):
    """m-point GLL rule (endpoints included, exact to degree 2m-3)."""

    def __init__(self, ref_el, m):
        if m < 2:
            raise ValueError("GLL quadrature needs at least 2 points")
        super().__init__(ref_el, *_line_rule(ref_el, *gauss_lobatto_jacobi_rule(m, 0, 0)))


class RadauQuadratureLineRule(QuadratureRule):
    """m-point Gauss-Radau rule with a fixed endpoint (exact to 2m-2).

    Built from the (m-1)-point Gauss-Jacobi rule with the weight absorbed:
    w_i = w_i^GJ / |x0 - x_i|-hat, and the endpoint weight closes the total
    volume."""

    def __init__(self, ref_el, m, right=True):
        if m < 1:
            raise ValueError("Radau quadrature needs at least 1 point")
        right = int(right)
        x0 = np.asarray(ref_el.vertices[right], dtype=float)
        volume = ref_el.volume()
        if m > 1:
            inner = GaussJacobiQuadratureLineRule(ref_el, m - 1, right, 1 - right)
            hat = (2.0 / volume) * np.abs(x0[0] - inner.pts[:, 0])
            ipts, iwts = inner.pts, inner.wts / hat
        else:
            ipts, iwts = np.zeros((0, 1)), np.zeros(0)
        w0 = volume - iwts.sum()
        if right:
            pts = np.vstack([ipts, x0[None, :]])
            wts = np.append(iwts, w0)
        else:
            pts = np.vstack([x0[None, :], ipts])
            wts = np.append(w0, iwts)
        super().__init__(ref_el, pts, wts)


class CollapsedQuadratureSimplexRule(QuadratureRule):
    """Karniadakis & Sherwin collapsed rule: Duffy image of a Gauss-Jacobi
    product grid, mapped from the default simplex."""

    def __init__(self, ref_el, m):
        dim = ref_el.get_spatial_dimension()
        x, w = collapsed_gauss_simplex(dim, m)
        pts, wts, _ = affine_pushforward(x, w, cl.default_simplex(dim), ref_el)
        super().__init__(ref_el, pts, wts)


class FacetQuadratureRule(QuadratureRule):
    """A reference rule pushed forward onto a facet of a cell."""

    def __init__(self, ref_el, entity_dim, entity_id, Q_ref, avg=False):
        facet = ref_el.construct_subelement(entity_dim)
        facet.vertices = ref_el.get_vertices_of_subcomplex(
            ref_el.get_topology()[entity_dim][entity_id])
        pts, wts, J = affine_pushforward(Q_ref.get_points(), Q_ref.get_weights(),
                                         Q_ref.ref_el, facet, avg=avg)
        super().__init__(facet, pts, wts)
        self._J = J

    def jacobian(self):
        return self._J

    def jacobian_determinant(self):
        return pseudo_determinant(self._J)


def make_tensor_product_quadrature(*quad_rules):
    """Product rule on the TensorProductCell of the factors, the first
    factor's points varying slowest."""
    ref_el = cl.TensorProductCell(*[q.ref_el for q in quad_rules])
    counts = [q.pts.shape[0] for q in quad_rules]
    cols = []
    for k, q in enumerate(quad_rules):
        before = int(np.prod(counts[:k], dtype=int))
        after = int(np.prod(counts[k + 1:], dtype=int))
        cols.append(np.repeat(np.tile(q.pts, (before, 1)), after, axis=0))
    wts = quad_rules[0].wts
    for q in quad_rules[1:]:
        wts = np.multiply.outer(wts, q.wts).ravel()
    assert wts.shape[0] == int(np.prod(counts))
    return QuadratureRule(ref_el, np.hstack(cols), wts)


def make_quadrature(ref_el, m):
    """Collapsed-quadrature rule with m points per direction (Gauss-Jacobi
    products on quadrilaterals and hexahedra)."""
    if m <= 0:
        raise ValueError("Need at least one quadrature point per direction")
    shape = ref_el.get_shape()
    if shape == cl.POINT:
        return QuadratureRule(ref_el, np.zeros((1, 0)), np.ones(1))
    if shape == cl.LINE:
        return GaussJacobiQuadratureLineRule(ref_el, m)
    if shape in (cl.TRIANGLE, cl.TETRAHEDRON):
        return CollapsedQuadratureSimplexRule(ref_el, m)
    if shape in (cl.QUADRILATERAL, cl.HEXAHEDRON):
        line = GaussJacobiQuadratureLineRule(ref_el.construct_subelement(1), m)
        return make_tensor_product_quadrature(*([line] * ref_el.get_spatial_dimension()))
    raise ValueError(f"Unable to make quadrature for cell {ref_el}")
