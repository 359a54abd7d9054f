"""Orthogonal (Dubiner) expansion bases on single simplices.

Counterpart of ``fiat_tpu/core/expansions.py`` (single-cell part; binning
on split complexes is not ported yet).  The Kirby singularity-free
recurrence on collapsed coordinates is written once over generic array
arithmetic: it runs in numpy on the host (construction paths) and on torch
tensors, on the CPU or the card, wherever the points are a tensor.
Derivatives come from running the same recurrence on Taylor jets.
"""

import math
from functools import lru_cache

import numpy as np
import torch

from . import cells as cl
from ..utils.jets import (Jet, concat_rows, matapply, multiindices,
                          take_rows, taylor_seeds)


# ---------------------------------------------------------------------------
# Multi-index orderings

def morton_index2(p, q=0):
    return (p + q) * (p + q + 1) // 2 + q


def morton_index3(p, q=0, r=0):
    return ((p + q + r) * (p + q + r + 1) * (p + q + r + 2) // 6
            + (q + r) * (q + r + 1) // 2 + r)


def _morton(dim):
    return (lambda p: p, morton_index2, morton_index3)[dim - 1]


def jacobi_recurrence_coeffs(a, b, n):
    """(a_n, b_n, c_n) of the three-term Jacobi recurrence (python floats)."""
    an = (2 * n + 1 + a + b) * (2 * n + 2 + a + b) / (2 * (n + 1) * (n + 1 + a + b))
    bn = (a + b) * (a - b) * (2 * n + 1 + a + b) / (2 * (n + 1) * (n + 1 + a + b) * (2 * n + a + b))
    cn = (n + a) * (n + b) * (2 * n + 2 + a + b) / ((n + 1) * (n + 1 + a + b) * (2 * n + a + b))
    return an, bn, cn


def integrated_jacobi_recurrence_coeffs(a, b, n):
    if n == 1:
        return (a + b + 2) / 2, (a - 3 * b - 2) / 2, 0.0
    return jacobi_recurrence_coeffs(a - 1, b + 1, n - 1)


# ---------------------------------------------------------------------------
# Member-vectorised recurrence
#
# Each degree step advances ALL members that share a trailing index: the
# working state is a stacked (num_rows, npts) array and the Jacobi
# coefficients are static per-row column vectors.

def _stage_multiindices(length, n, dim):
    """Multi-indices of the given length with sum <= n, ordered by the
    dim-variable morton rank (trailing zeros implied)."""
    idx = _morton(dim)
    return sorted(multiindices(length, n),
                  key=lambda mi: idx(*mi, *((0,) * (dim - length))))


def _variant_alpha(sub, variant):
    if variant == "bubble":
        return 2 * sum(sub)
    alpha = 2 * sum(sub) + len(sub)
    if variant == "dual":
        alpha += 1 + len(sub)
    return alpha


@lru_cache(maxsize=None)
def _stage_constants(dim, n, codim, variant):
    """Static per-row recurrence data for one codimension stage:
    (a1, b1) first-step vectors, {i: (a, b, c)} general-step vectors, the
    gather permutation into the next stage's morton order, and the
    normalization vector of the next stage."""
    beta = 1 if variant == "dual" else 0
    coeff_fn = (integrated_jacobi_recurrence_coeffs if variant == "bubble"
                else jacobi_recurrence_coeffs)
    subs = _stage_multiindices(codim, n, dim)
    m_in = len(subs)
    alphas = np.array([_variant_alpha(sub, variant) for sub in subs], dtype=np.float64)

    if variant == "bubble":
        a1 = np.full((m_in, 1), -0.5)
        b1 = np.full((m_in, 1), -0.5)
    else:
        a1 = (0.5 * (alphas + beta) + 1.0).reshape(-1, 1)
        b1 = (0.5 * (alphas - beta)).reshape(-1, 1)

    # step i produces trailing-index-i members from i-1 and i-2, which is
    # the three-term recurrence evaluated at index i-1
    general = {}
    for i in range(2, n + 1):
        abc = np.array([coeff_fn(al, beta, i - 1) for al in alphas])
        general[i] = (abc[:, 0:1], abc[:, 1:2], abc[:, 2:3])

    # gather permutation: next-stage multiindices -> (i * m_in + row_in)
    outs = _stage_multiindices(codim + 1, n, dim)
    sub_rank = {sub: r for r, sub in enumerate(subs)}
    perm = np.array([mi[-1] * m_in + sub_rank[mi[:-1]] for mi in outs], dtype=int)

    d = codim + 1
    shift = 1 if variant == "dual" else 0
    norms = []
    for mi in outs:
        if variant is not None:
            p = mi[-1] + shift
            al = 2 * (sum(mi[:-1]) + d * shift) - 1
            norm2 = (0.5 + d) / d
            if p > 0 and p + al > 0:
                norm2 *= (p + al) * (2 * p + al) / p
        else:
            norm2 = (2 * sum(mi) + d) / d
        norms.append(math.sqrt(norm2))
    norms = np.asarray(norms).reshape(-1, 1)
    return a1, b1, general, perm, norms


@lru_cache(maxsize=None)
def _c0_matrix(dim, n):
    """Static matrix C with phi_C0 = C @ phi_bubble (facet-bubble recovery
    differencing + entity reordering), from the index algebra run on
    identity rows."""
    m = math.comb(n + dim, dim)
    return np.stack(c0_reorder(dim, n, [row for row in np.eye(m)]))


def _base_value(x):
    """The plain array behind a coordinate (itself, or a Jet's value)."""
    return next(iter(x.comps.values())) if isinstance(x, Jet) else x


def dubiner_tabulate(dim, n, coords, scale, variant=None):
    """Stacked tabulation (num_members, npts) of the Dubiner basis at points
    on the default (-1,1) simplex.

    :arg coords: list of ``dim`` coordinate objects -- (npts,) numpy arrays
        or torch tensors (plain values), or Jets over them (values +
        derivatives).  Tensors keep their device and dtype.
    :returns: a (num_members, npts) array or tensor, or a Jet of them.
    """
    if variant not in (None, "bubble", "dual"):
        raise ValueError(f"Invalid expansion variant {variant!r}")
    if dim > 3:
        raise ValueError("Only dim <= 3 simplices supported")
    eff_scale = -scale if variant == "bubble" else scale

    x0 = coords[0]
    base = _base_value(x0)
    if isinstance(base, torch.Tensor):
        const = lambda c: torch.as_tensor(c, dtype=base.dtype, device=base.device)  # noqa: E731
        index = lambda p: torch.as_tensor(p, device=base.device)                    # noqa: E731
        ones = torch.ones_like(base)[None]
    else:
        const = index = lambda c: c                                                  # noqa: E731
        ones = np.ones(np.shape(base))[None]
    if isinstance(x0, Jet):
        R = Jet(x0.nvars, x0.order, {(0,) * x0.nvars: ones * eff_scale})
    else:
        R = ones * eff_scale

    if n > 0:
        X = tuple(coords) + (-1.0, -1.0)
        for codim in range(dim):
            x, y, z = X[codim], X[codim + 1], X[codim + 2]
            fb = 0.5 * (y + z)
            fa = x + fb + 1.0
            fc = fb * fb
            a1, b1, general, perm, norms = _stage_constants(dim, n, codim, variant)
            levels = [R, (const(a1) * fa - const(b1) * fb) * R]
            for i in range(2, n + 1):
                a, b, c = (const(v) for v in general[i])
                levels.append((a * fa - b * fb) * levels[-1]
                              - (c * fc) * levels[-2])
            R = take_rows(concat_rows(levels), index(perm)) * const(norms)

    if variant == "bubble":
        R = matapply(_c0_matrix(dim, n), R)
    return R


def c0_reorder(dim, n, phi):
    """Turn a 'bubble' (integrated-Jacobi) tabulation into the C0 hierarchy:
    recover facet bubbles by differencing, then renumber vertex/edge/face/
    interior blocks in reference order.  Index algebra on the member list."""
    idx = _morton(dim)
    phi = list(phi)
    phi[0] = -phi[0]
    for i in range(1, dim + 1):
        phi[0] = phi[0] - phi[i]
    if dim == 2:
        for i in range(2, n + 1):
            phi[idx(0, i)] = phi[idx(0, i)] - phi[idx(1, i - 1)]
    elif dim == 3:
        for i in range(2, n + 1):
            for j in range(0, n + 1 - i):
                phi[idx(0, i, j)] = phi[idx(0, i, j)] - phi[idx(1, i - 1, j)]
            icur = idx(0, 0, i)
            phi[icur] = phi[icur] - phi[idx(0, 1, i - 1)]
            phi[icur] = phi[icur] - phi[idx(1, 0, i - 1)]

    order = list(range(dim + 1))
    if dim == 1:
        order.extend(range(2, n + 1))
    elif dim == 2:
        order.extend(idx(1, i - 1) for i in range(2, n + 1))
        order.extend(idx(0, i) for i in range(2, n + 1))
        order.extend(idx(i, 0) for i in range(2, n + 1))
        order.extend(idx(i, j) for j in range(1, n + 1) for i in range(2, n - j + 1))
    elif dim == 3:
        order.extend(idx(0, 1, i - 1) for i in range(2, n + 1))
        order.extend(idx(1, 0, i - 1) for i in range(2, n + 1))
        order.extend(idx(1, i - 1, 0) for i in range(2, n + 1))
        order.extend(idx(0, 0, i) for i in range(2, n + 1))
        order.extend(idx(0, i, 0) for i in range(2, n + 1))
        order.extend(idx(i, 0, 0) for i in range(2, n + 1))
        order.extend(idx(1, i - 1, j) for j in range(1, n + 1) for i in range(2, n - j + 1))
        order.extend(idx(0, i, j) for j in range(1, n + 1) for i in range(2, n - j + 1))
        order.extend(idx(i, 0, j) for j in range(1, n + 1) for i in range(2, n - j + 1))
        order.extend(idx(i, j, 0) for j in range(1, n + 1) for i in range(2, n - j + 1))
        order.extend(idx(i, j, k) for k in range(1, n + 1)
                     for j in range(1, n - k + 1) for i in range(2, n - j - k + 1))
    return [phi[i] for i in order]


def mis(m, n):
    """All m-tuples of nonnegative integers summing to n (reference order)."""
    if m == 1:
        return [(n,)]
    if n == 0:
        return [(0,) * m]
    return [(n - i,) + rest for i in range(n + 1) for rest in mis(m - 1, i)]


# ---------------------------------------------------------------------------
# Expansion sets

class ExpansionSet:
    """Dubiner expansion set over a single simplex.

    Tabulation runs one generic recurrence: in numpy for numpy points, on
    torch tensors (their device and dtype) for tensor points."""

    def __new__(cls, *args, **kwargs):
        if cls is not ExpansionSet:
            return super().__new__(cls)
        table = {cl.POINT: PointExpansionSet,
                 cl.LINE: LineExpansionSet,
                 cl.TRIANGLE: TriangleExpansionSet,
                 cl.TETRAHEDRON: TetrahedronExpansionSet}
        try:
            sub = table[args[0].get_shape()]
        except KeyError:
            raise ValueError("Invalid reference element type.")
        return sub(*args, **kwargs)

    def __init__(self, ref_el, scale=None, variant=None):
        if ref_el.is_macrocell():
            raise NotImplementedError("Expansion sets on split complexes are not ported yet")
        self.ref_el = ref_el
        self.variant = variant
        sd = ref_el.get_spatial_dimension()
        base = cl.default_simplex(sd)
        self.affine_mappings = [cl.make_affine_mapping(ref_el.get_vertices(),
                                                       base.get_vertices())]
        if scale is None:
            scale = math.sqrt(1.0 / base.volume())
        self.scale = scale
        self.continuity = "C0" if variant == "bubble" else None
        self.recurrence_order = 2
        self._dmats_cache = {}

    def get_scale(self, n, cell=0):
        scale = self.scale
        sd = self.ref_el.get_spatial_dimension()
        if isinstance(scale, str):
            vol = self.ref_el.volume_of_subcomplex(sd, cell)
            name = scale.lower()
            if name == "orthonormal":
                scale = math.sqrt(1.0 / vol)
            elif name == "l2 piola":
                scale = 1.0 / vol
        elif n == 0 and sd > 1:
            # reference quirk: the constant member is exactly 1 on a cell
            scale = 1
        return scale

    def get_num_members(self, n):
        return polynomial_dimension(self.ref_el, n, self.continuity)

    def _tabulate_on_cell(self, n, pts, order=0, cell=0):
        """dict alpha -> (m, npts) table of D^alpha phi_i(pts_j).

        numpy points run on the host; a torch tensor runs on its device in
        its dtype.  Derivatives come from the recurrence on Taylor jets in
        the cell coordinates."""
        sd = self.ref_el.get_spatial_dimension()
        A, b = self.affine_mappings[cell]
        if isinstance(pts, torch.Tensor):
            pts = pts.reshape(-1, sd)
            ref = (pts @ torch.as_tensor(A.T, dtype=pts.dtype, device=pts.device)
                   + torch.as_tensor(b, dtype=pts.dtype, device=pts.device))
            zeros = lambda shape: torch.zeros(shape, dtype=pts.dtype, device=pts.device)  # noqa: E731
        else:
            pts = np.asarray(pts, dtype=np.float64).reshape(-1, sd)
            ref = pts @ A.T + b
            zeros = np.zeros
        scale = self.get_scale(n, cell=cell)
        vals = [ref[..., i] for i in range(sd)]
        npts = pts.shape[0]

        if order == 0:
            return {(0,) * sd: dubiner_tabulate(sd, n, vals, scale, variant=self.variant)}

        coords = taylor_seeds(vals, A, sd, order)
        out = dubiner_tabulate(sd, n, coords, scale, variant=self.variant)
        result = {}
        for alpha in multiindices(sd, order):
            d = out.derivative(alpha)
            result[alpha] = zeros((math.comb(n + sd, sd), npts)) if d is None else d
        return result

    def _tabulate(self, n, pts, order=0):
        return self._tabulate_on_cell(n, pts, order)

    def tabulate(self, n, pts):
        if len(pts) == 0:
            return np.array([])
        return self._tabulate(n, pts)[(0,) * self.ref_el.get_spatial_dimension()]

    def get_dmats(self, degree, cell=0):
        """dmat[k, j, i]: coefficients of d(phi_j)/dx_k in the expansion
        basis, from a collocation solve at a Gauss-Legendre lattice."""
        key = (degree, cell)
        if key in self._dmats_cache:
            return self._dmats_cache[key]
        sd = self.ref_el.get_spatial_dimension()
        if degree == 0:
            return self._dmats_cache.setdefault(key, np.zeros((sd, 1, 1)))
        pts = cl.make_lattice(self.ref_el.get_vertices(), degree, variant="gl")
        v = self._tabulate_on_cell(degree, pts, order=1, cell=cell)
        dv = [np.transpose(v[alpha]) for alpha in mis(sd, 1)]
        dmats = np.linalg.solve(np.transpose(v[(0,) * sd]), dv)
        return self._dmats_cache.setdefault(key, dmats)

    def __eq__(self, other):
        return (type(self) is type(other) and self.ref_el == other.ref_el
                and self.continuity == other.continuity)

    def __hash__(self):
        return hash((type(self), self.ref_el, self.continuity))


class PointExpansionSet(ExpansionSet):
    def _tabulate_on_cell(self, n, pts, order=0, cell=0):
        assert n == 0 and order == 0
        return {(): np.ones((1, len(pts)))}


class LineExpansionSet(ExpansionSet):
    pass


class TriangleExpansionSet(ExpansionSet):
    pass


class TetrahedronExpansionSet(ExpansionSet):
    pass


def polynomial_dimension(ref_el, n, continuity=None):
    if ref_el.get_shape() == cl.POINT:
        if n > 0:
            raise ValueError("Only degree-0 polynomials on a point")
        return 1
    top = ref_el.get_topology()
    if continuity == "C0":
        return sum(math.comb(n - 1, dim) * len(top[dim]) for dim in top)
    dim = ref_el.get_spatial_dimension()
    return math.comb(n + dim, dim) * len(top[dim])
