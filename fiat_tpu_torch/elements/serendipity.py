"""Serendipity S_k on quadrilaterals and hexahedra (Arnold & Awanou).

Counterpart of ``fiat_tpu/elements/serendipity.py``: every S_k basis
function is a product of one univariate factor per axis, drawn from the
linear vertex hats, the quadratic bubble and Legendre polynomials in the
axis midpoint coordinate.  Each factor is held as its values on a per-axis
Chebyshev-Lobatto node set, so any derivative order is one
barycentric-Lagrange table per axis contracted against the factor-value
matrices and multiplied across axes; no symbolic algebra.
"""

from itertools import product

import numpy as np

from ..core.barycentric import barycentric_interpolation, make_dmat
from ..core.cells import flatten_reference_cube, make_lattice
from ..core.dualset import DualSet
from ..core.expansions import mis
from ..core.finite_element import FiniteElement
from ..core.pointwise_dual import compute_pointwise_dual
from .lagrange import Lagrange


def _superlinear_count(k):
    """Dofs on a quad face of S_k: bidegree pairs of total degree 4..k."""
    return (k - 2) * (k - 3) // 2 if k > 3 else 0


class _AxisBasis:
    """Univariate factor vocabulary for one coordinate axis, held as
    values on a Chebyshev–Lobatto node set over the axis interval."""

    def __init__(self, lo, hi, degree):
        n = max(degree, 1)
        t = lo + (hi - lo) * 0.5 * (1.0 - np.cos(np.pi * np.arange(n + 1) / n))
        self.nodes = t
        self.dmat, self.wts = make_dmat(t)
        span = hi - lo
        self.hat = ((hi - t) / span, (t - lo) / span)
        self.bubble = self.hat[0] * self.hat[1]
        # P_j evaluated in the midpoint coordinate 2t - (lo + hi).
        mid = 2.0 * t - (lo + hi)
        self.leg = np.polynomial.legendre.legvander(mid, degree).T
        self.one = np.ones_like(t)

    def tables(self, pts, order):
        """Lagrange-basis derivative tables at ``pts`` up to ``order``."""
        tabs = barycentric_interpolation(self.nodes, self.wts, self.dmat,
                                         np.asarray(pts)[:, None], order)
        return {r: tabs[(r,)] for r in range(order + 1)}


def _emit_basis(axes, degree):
    """The S_k generators, in reference dof order, as one per-axis
    factor-value matrix each: returns [F_0, ..., F_{d-1}] with
    F_u of shape (nbasis, len(axes[u].nodes))."""
    dim = len(axes)
    rows = []                      # each row: tuple of per-axis vectors

    # Vertex hats: one per sign pattern, x-major (matches UFC vertex ids).
    for signs in product((0, 1), repeat=dim):
        rows.append(tuple(axes[u].hat[s] for u, s in enumerate(signs)))

    # Edge functions: tangent axes in descending order, the remaining
    # axes pinned to a hat, ascending-major over their sign patterns.
    for t_ax in reversed(range(dim)):
        others = [u for u in range(dim) if u != t_ax]
        for signs in product((0, 1), repeat=dim - 1):
            for j in range(degree - 1):
                row = [None] * dim
                row[t_ax] = -axes[t_ax].bubble * axes[t_ax].leg[j]
                for u, s in zip(others, signs):
                    row[u] = axes[u].hat[s]
                rows.append(tuple(row))

    # Face functions: Legendre bidegree pairs of total degree 4..k on the
    # cyclic tangent pair of each normal axis (2D: the single face).
    normals = range(dim) if dim == 3 else (2,)
    for n_ax in normals:
        ta, tb = (n_ax + 1) % 3, (n_ax + 2) % 3
        hats = (axes[n_ax].hat if dim == 3 else (None,))
        for s in range(len(hats)):
            for ktot in range(4, degree + 1):
                for j in range(ktot - 3):
                    row = [None] * dim
                    if dim == 3:
                        row[n_ax] = hats[s]
                    row[ta] = axes[ta].bubble * axes[ta].leg[j]
                    row[tb] = axes[tb].bubble * axes[tb].leg[ktot - 4 - j]
                    rows.append(tuple(row))

    # Interior functions (3D): Legendre tridegree of total degree 6..k.
    if dim == 3:
        for ltot in range(6, degree + 1):
            for j in range(ltot - 5):
                for k in range(j + 1):
                    jdeg = (ltot - 6 - j, j - k, k)
                    rows.append(tuple(-axes[u].bubble * axes[u].leg[jdeg[u]]
                                      if u == 0 else
                                      axes[u].bubble * axes[u].leg[jdeg[u]]
                                      for u in range(dim)))

    return [np.stack([row[u] for row in rows]) for u in range(dim)]


class Serendipity(FiniteElement):
    """The serendipity element S_k (quad/hex)."""

    def __new__(cls, ref_el, degree):
        dim = ref_el.get_spatial_dimension()
        if dim == 1:
            return Lagrange(ref_el, degree)
        if dim == 0:
            raise IndexError("reference element cannot be dimension 0")
        return super().__new__(cls)

    def __init__(self, ref_el, degree):
        flat_el = flatten_reference_cube(ref_el)
        dim = flat_el.get_spatial_dimension()
        verts = np.asarray(flat_el.get_vertices())
        lo, hi = verts[0], verts[-1]

        self._axes = [_AxisBasis(lo[u], hi[u], degree) for u in range(dim)]
        self._factors = _emit_basis(self._axes, degree)
        nbasis = self._factors[0].shape[0]

        # Entity dof ids follow the emission order above: vertices, then
        # edges, faces, interior, with per-entity dof counts fixed by k.
        per_dim = {0: 1, 1: degree - 1, 2: _superlinear_count(degree)}
        topology = flat_el.get_topology()
        entity_ids, cursor = {}, 0
        for d in sorted(topology):
            entity_ids[d] = {}
            width = per_dim.get(d)
            for e in sorted(topology[d]):
                if width is None:        # 3D interior: everything left
                    width = nbasis - cursor
                entity_ids[d][e] = list(range(cursor, cursor + width))
                cursor += width
        assert cursor == nbasis

        self.flat_el = flat_el
        dual = DualSet([None] * nbasis, ref_el, entity_ids)
        super().__init__(ref_el=ref_el, dual=dual, order=degree,
                         formdegree=0)
        self.dual = compute_pointwise_dual(
            self, unisolvent_pts(ref_el, degree))

    def degree(self):
        return self.order + 1

    def get_coeffs(self):
        raise NotImplementedError(
            "get_coeffs not implemented for Serendipity")

    def value_shape(self):
        return ()

    def tabulate(self, order, points, entity=None):
        if entity is None:
            entity = (self.ref_el.get_dimension(), 0)
        transform = self.ref_el.get_entity_transform(*entity)
        points = np.asarray(transform(points))

        dim = self.ref_el.get_spatial_dimension()
        if not 2 <= dim <= 3:
            raise NotImplementedError(
                "Serendipity tabulation only supports dimensions 2 and 3")
        # Per-axis Lagrange tables once, then every derivative multi-index
        # is a product of (factors @ table) across axes.
        tabs = [self._axes[u].tables(points[:, u], order)
                for u in range(dim)]
        values = {}
        for total in range(order + 1):
            for alpha in mis(dim, total):
                parts = [self._factors[u] @ tabs[u][alpha[u]]
                         for u in range(dim)]
                out = parts[0]
                for p in parts[1:]:
                    out = out * p
                values[alpha] = out
        return values


def _box_lattice(n, dim, total):
    """Multi-indices with every component >= 1 and sum <= ``total``,
    as fractions of ``n`` (vectorised; lexicographic)."""
    if total < dim:
        return np.zeros((0, dim))
    idx = np.indices((total,) * dim).reshape(dim, -1).T + 1
    return idx[idx.sum(axis=1) <= total] / n


def unisolvent_pts(K, deg):
    """A unisolvent (not dual) point set for S_deg on a quad/hex."""
    flat_el = flatten_reference_cube(K)
    dim = flat_el.get_spatial_dimension()
    if not 2 <= dim <= 3:
        raise ValueError("Serendipity only defined for quads and hexes")
    top = flat_el.get_topology()
    pts = [tuple(v) for v in flat_el.get_vertices()]

    line = flat_el.construct_subelement(1)
    edge_pts = make_lattice(line.get_vertices(), deg, 1)
    for e in sorted(top[1]):
        fmap = flat_el.get_entity_transform(1, e)
        pts.extend(tuple(fmap(p)) for p in edge_pts)

    if deg > 3:
        frac = _box_lattice(deg - 2, 2, deg - 2)
        if dim == 2:
            vs = np.asarray(flat_el.get_vertices())
            span = np.stack([vs[1] - vs[0], vs[2] - vs[0]])
            pts.extend(tuple(p) for p in vs[0] + frac @ span)
        else:
            face = flat_el.construct_subelement(2)
            fvs = np.asarray(face.get_vertices())
            span = np.stack([fvs[1] - fvs[0], fvs[2] - fvs[0]])
            face_pts = fvs[0] + frac @ span
            for f in sorted(top[2]):
                fmap = flat_el.get_entity_transform(2, f)
                pts.extend(tuple(fmap(p)) for p in face_pts)

    if dim == 3 and deg > 5:
        frac = _box_lattice(deg - 4, 3, deg - 3)
        vs = np.asarray(flat_el.get_vertices())
        span = np.stack([vs[4] - vs[0], vs[2] - vs[0], vs[1] - vs[0]])
        pts.extend(tuple(p) for p in vs[0] + frac @ span)
    return pts
