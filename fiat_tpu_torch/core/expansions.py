"""Orthogonal (Dubiner) expansion bases on simplices and split complexes.

Counterpart of ``fiat_tpu/core/expansions.py``.  The Kirby singularity-free
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


def dubiner_tabulate(dim, n, coords, scale, variant=None, raw=False):
    """Stacked tabulation (num_members, npts) of the Dubiner basis at points
    on the default (-1,1) simplex.

    :arg coords: list of ``dim`` coordinate objects -- (npts,) numpy arrays
        or torch tensors (plain values), or Jets over them (values +
        derivatives).  Tensors keep their device and dtype.
    :arg raw: the recurrence alone: ``scale`` as given and, for "bubble",
        no C0 recovery (the f32 engine folds both into its change of basis).
    :returns: a (num_members, npts) array or tensor, or a Jet of them.
    """
    if variant not in (None, "bubble", "dual"):
        raise ValueError(f"Invalid expansion variant {variant!r}")
    if dim > 3:
        raise ValueError("Only dim <= 3 simplices supported")
    eff_scale = -scale if variant == "bubble" and not raw else scale

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

    if variant == "bubble" and not raw:
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

def _is_tensor(x):
    return isinstance(x, torch.Tensor)


class ExpansionSet:
    """Dubiner expansion set over a simplicial complex (a single simplex,
    or a split complex with one Dubiner basis per subcell).

    Tabulation runs one generic recurrence: in numpy for numpy points, on
    torch tensors (their device and dtype) for tensor points.  On a split
    complex, numpy points are binned to subcells (``compute_cell_point_map``)
    and tensor points go through {0,1} partition-of-unity masks
    (``partition_of_unity_masks``), the shape-static form a device runs."""

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
        self.ref_el = ref_el
        self.variant = variant
        sd = ref_el.get_spatial_dimension()
        top = ref_el.get_topology()
        base = cl.default_simplex(sd)
        base_verts = base.get_vertices()
        self.affine_mappings = [
            cl.make_affine_mapping(ref_el.get_vertices_of_subcomplex(top[sd][cell]), base_verts)
            for cell in top[sd]]
        if scale is None:
            scale = math.sqrt(1.0 / base.volume())
        self.scale = scale
        self.continuity = "C0" if variant == "bubble" else None
        self.recurrence_order = 2
        self._dmats_cache = {}
        self._cell_node_map_cache = {}

    def reconstruct(self, ref_el=None, scale=None, variant=None):
        return ExpansionSet(ref_el or self.ref_el, scale=scale or self.scale,
                            variant=variant or self.variant)

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
        elif n == 0 and sd > 1 and len(self.affine_mappings) == 1:
            # fiat_tpu's quirk: the constant member is exactly 1 on a
            # single cell
            scale = 1
        return scale

    def get_num_members(self, n):
        return polynomial_dimension(self.ref_el, n, self.continuity)

    def get_cell_node_map(self, n):
        try:
            return self._cell_node_map_cache[n]
        except KeyError:
            cnm = polynomial_cell_node_map(self.ref_el, n, self.continuity)
            return self._cell_node_map_cache.setdefault(n, cnm)

    # -- tabulation -------------------------------------------------------------

    def _tabulate_on_cell(self, n, pts, order=0, cell=0):
        """dict alpha -> (m, npts) table of D^alpha phi_i(pts_j) of the
        Dubiner basis of subcell ``cell`` (extended polynomially past it).

        numpy points run on the host; a torch tensor runs on its device in
        its dtype.  Derivatives come from the recurrence on Taylor jets in
        the cell coordinates."""
        sd = self.ref_el.get_spatial_dimension()
        A, b = self.affine_mappings[cell]
        if _is_tensor(pts):
            pts = pts.reshape(-1, sd)
            ref = pts @ pts.new_tensor(A.T) + pts.new_tensor(b)
            zeros = lambda shape: pts.new_zeros(shape)  # noqa: E731
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
        """Tabulate on the whole complex: the identity assembly on a single
        cell; on a split complex, per-subcell tabulations scattered through
        the cell-node map (multiplicity-averaged on shared facets unless the
        basis is C0 at order 0, where the first subcell wins)."""
        if _is_tensor(pts):
            if self.ref_el.is_macrocell():
                return self._tabulate_masked(n, pts, order)
            return self._tabulate_on_cell(n, pts, order)
        pts = np.asarray(pts, dtype=np.float64)
        unique = self.continuity is not None and order == 0
        cell_point_map = compute_cell_point_map(self.ref_el, pts, unique=unique)
        phis = {c: self._tabulate_on_cell(n, pts[ipts if ipts is not Ellipsis else slice(None)],
                                          order, cell=c)
                for c, ipts in cell_point_map.items()}
        if not self.ref_el.is_macrocell():
            return phis[0]

        if not unique:
            mult = np.zeros(pts.shape[:-1])
            for ipts in cell_point_map.values():
                mult[ipts] += 1
            for c, ipts in cell_point_map.items():
                for alpha in phis[c]:
                    phis[c][alpha] /= mult[None, ipts]

        num_phis = self.get_num_members(n)
        cell_node_map = self.get_cell_node_map(n)
        result = {}
        probe = next(iter(phis.values()))
        for alpha in probe:
            out = np.zeros((num_phis, *pts.shape[:-1]), dtype=probe[alpha].dtype)
            for c, ipts in cell_point_map.items():
                ibfs = cell_node_map[c]
                if ipts is Ellipsis:
                    out[ibfs, ...] += phis[c][alpha]
                else:
                    out[np.ix_(ibfs, ipts)] += phis[c][alpha]
            result[alpha] = out
        return result

    def _tabulate_masked(self, n, pts, order=0):
        """Shape-static tabulation of tensor points on a split complex:
        every subcell tabulates at every point and the results combine
        through {0,1} partition-of-unity masks (fiat_tpu's traced form)."""
        unique = self.continuity is not None and order == 0
        masks = partition_of_unity_masks(self.ref_el, pts, unique=unique)
        sd = self.ref_el.get_spatial_dimension()
        cell_node_map = self.get_cell_node_map(n)
        result = {}
        for pos, c in enumerate(sorted(self.ref_el.get_topology()[sd])):
            rows = torch.as_tensor(cell_node_map[c], device=pts.device)
            for alpha, tab in self._tabulate_on_cell(n, pts, order, cell=c).items():
                if alpha not in result:
                    result[alpha] = tab.new_zeros((self.get_num_members(n),) + tab.shape[1:])
                result[alpha].index_add_(0, rows, masks[pos] * tab)
        return result

    def tabulate(self, n, pts):
        if len(pts) == 0:
            return np.array([])
        return self._tabulate(n, pts)[(0,) * self.ref_el.get_spatial_dimension()]

    # -- jumps on split complexes ---------------------------------------------

    def tabulate_normal_jumps(self, n, ref_pts, facet, order=0):
        """Normal-derivative jumps of the expansion at reference points of a
        facet of the complex: (order + 1, num_members, npts)."""
        sd = self.ref_el.get_spatial_dimension()
        transform = self.ref_el.get_entity_transform(sd - 1, facet)
        pts = np.asarray(transform(ref_pts))
        cell_point_map = compute_cell_point_map(self.ref_el, pts, unique=False)
        cell_node_map = self.get_cell_node_map(n)
        results = np.zeros((order + 1, self.get_num_members(n), *pts.shape[:-1]))
        for c, ipts in cell_point_map.items():
            normal = self.ref_el.compute_normal(facet, cell=c)
            side = np.dot(normal, self.ref_el.compute_normal(facet))
            sel = slice(None) if ipts is Ellipsis else ipts
            phi = self._tabulate_on_cell(n, pts[sel], order, cell=c)
            v0 = phi[(0,) * sd]
            ibfs = cell_node_map[c]
            for r in range(order + 1):
                vr = np.zeros((sd,) * r + v0.shape, dtype=v0.dtype)
                for index in np.ndindex(vr.shape[:r]):
                    vr[index] = phi[tuple(map(index.count, range(sd)))]
                for _ in range(r):
                    vr = np.tensordot(normal, vr, axes=(0, 0))
                indices = np.ix_(ibfs, np.arange(pts.shape[0])[sel])
                if r % 2 == 0 and side < 0:
                    results[r][indices] -= vr
                else:
                    results[r][indices] += vr
        return results

    def tabulate_jumps(self, n, points, order=0):
        """Derivative jumps across the interior facets of the complex:
        {r: (num_members, nalpha_r * njumps)}."""
        sd = self.ref_el.get_spatial_dimension()
        cell_node_map = self.get_cell_node_map(n)
        points = np.asarray(points, dtype=np.float64)
        cell_point_map = compute_cell_point_map(self.ref_el, points, unique=False)

        num_jumps = 0
        facet_point_map = {}
        for facet in self.ref_el.get_interior_facets(sd - 1):
            cells_ = self.ref_el.connectivity[(sd - 1, sd)][facet]
            # a jump needs the point binned to BOTH adjacent cells
            ipts = list(set.intersection(*(set(np.atleast_1d(cell_point_map.get(c, ())))
                                           for c in cells_)))
            if ipts:
                facet_point_map[facet] = ipts
                num_jumps += len(ipts)

        derivs = {c: self._tabulate_on_cell(n, points, order=order, cell=c)
                  for c in cell_point_map}
        jumps = {}
        for r in range(order + 1):
            cur = 0
            alphas = mis(sd, r)
            jumps[r] = np.zeros((self.get_num_members(n), len(alphas) * num_jumps))
            for facet, ipts in facet_point_map.items():
                c0, c1 = self.ref_el.connectivity[(sd - 1, sd)][facet]
                for alpha in alphas:
                    ijump = range(cur, cur + len(ipts))
                    jumps[r][np.ix_(cell_node_map[c1], ijump)] += derivs[c1][alpha][:, ipts]
                    jumps[r][np.ix_(cell_node_map[c0], ijump)] -= derivs[c0][alpha][:, ipts]
                    cur += len(ipts)
        return jumps

    # -- spectral differentiation matrices --------------------------------------

    def get_dmats(self, degree, cell=0):
        """dmat[k, j, i]: coefficients of d(phi_j)/dx_k in the basis of
        subcell ``cell``, from a collocation solve at a Gauss-Legendre
        lattice."""
        key = (degree, cell)
        if key in self._dmats_cache:
            return self._dmats_cache[key]
        sd = self.ref_el.get_spatial_dimension()
        if degree == 0:
            return self._dmats_cache.setdefault(key, np.zeros((sd, 1, 1)))
        top = self.ref_el.get_topology()
        verts = self.ref_el.get_vertices_of_subcomplex(top[sd][cell])
        pts = cl.make_lattice(verts, degree, variant="gl")
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
        if _is_tensor(pts):
            return {(): pts.new_ones((1, len(pts)))}
        return {(): np.ones((1, len(pts)))}


class LineExpansionSet(ExpansionSet):
    pass


class TriangleExpansionSet(ExpansionSet):
    pass


class TetrahedronExpansionSet(ExpansionSet):
    pass


# ---------------------------------------------------------------------------
# Complex-wide numbering and binning

def polynomial_dimension(ref_el, n, continuity=None):
    if ref_el.get_shape() == cl.POINT:
        if n > 0:
            raise ValueError("Only degree-0 polynomials on a point")
        return 1
    top = ref_el.get_topology()
    if isinstance(continuity, dict):
        return sum(len(continuity[dim][0]) * len(top[dim]) for dim in top)
    if continuity == "C0":
        return sum(math.comb(n - 1, dim) * len(top[dim]) for dim in top)
    dim = ref_el.get_spatial_dimension()
    return math.comb(n + dim, dim) * len(top[dim])


def polynomial_entity_ids(ref_el, n, continuity=None):
    """{dim: {entity: [member ids]}}: C0 members sit on every entity,
    discontinuous ones on the cells only; a dict ``continuity`` (an
    element's entity dofs) puts as many on each entity as it lists."""
    top = ref_el.get_topology()
    sd = ref_el.get_spatial_dimension()
    entity_ids = {}
    cur = 0
    for dim in sorted(top):
        if isinstance(continuity, dict):
            dofs, = set(len(continuity[dim][e]) for e in continuity[dim])
        elif continuity == "C0":
            dofs = math.comb(n - 1, dim)
        else:
            dofs = math.comb(n + dim, dim) if dim == sd else 0
        entity_ids[dim] = {e: list(range(cur + i * dofs, cur + (i + 1) * dofs))
                           for i, e in enumerate(sorted(top[dim]))}
        cur += dofs * len(top[dim])
    return entity_ids


def polynomial_cell_node_map(ref_el, n, continuity=None):
    """(num_cells, dofs_per_cell) map from each subcell's local members to
    the complex's members."""
    top = ref_el.get_topology()
    sd = ref_el.get_spatial_dimension()
    entity_ids = polynomial_entity_ids(ref_el, n, continuity)
    ref_ids = polynomial_entity_ids(ref_el.construct_subelement(sd), n, continuity)
    dofs_per_cell = sum(len(ref_ids[dim][e]) for dim in ref_ids for e in ref_ids[dim])
    cell_node_map = np.zeros((len(top[sd]), dofs_per_cell), dtype=int)
    conn = ref_el.get_cell_connectivity()
    for c in top[sd]:
        for dim in top:
            for ref_e, e in enumerate(conn[c][dim]):
                cell_node_map[c, ref_ids[dim][ref_e]] = entity_ids[dim][e]
    return cell_node_map


def compute_cell_point_map(ref_el, pts, unique=True, tol=1e-12):
    """Bin host points to the nearest subcells of a complex: a subcell takes
    a point when its rescaled L1 distance is strictly below the parent's
    plus ``tol``.  Returns {cell: point-index array or Ellipsis}."""
    top = ref_el.get_topology()
    sd = ref_el.get_spatial_dimension()
    if len(top[sd]) == 1:
        return {0: Ellipsis}
    pts = np.asarray(pts)
    tol = ref_el.get_parent().distance_to_point_l1(pts, rescale=True) + tol
    out = {}
    for c in sorted(top[sd]):
        near = ref_el.distance_to_point_l1(pts, entity=(sd, c), rescale=True) < tol
        if near.ndim == 0:
            if near:
                out[c] = Ellipsis
                if unique:
                    break
        else:
            if unique:
                for other in out.values():
                    near[other] = False
            ipts = np.where(near)[0]
            if len(ipts) > 0:
                out[c] = ipts
    return out


def partition_of_unity_masks(ref_el, pts, unique=True, tol=None, raw=False):
    """Per-subcell {0,1} masks over a point batch (torch tensors on the
    points' device; numpy points become a CPU float64 tensor), the
    shape-static binning the device engine runs: ``subcell_masks`` with the
    complex's rescaled barycentric maps."""
    sd = ref_el.get_spatial_dimension()
    maps = [ref_el.barycentric_map(entity=(sd, c), rescale=True)
            for c in sorted(ref_el.get_topology()[sd])]
    return subcell_masks(pts, ref_el.get_parent().barycentric_map(rescale=True), maps,
                         unique=unique, tol=tol, raw=raw)


def subcell_masks(pts, parent_map, cell_maps, unique=True, tol=None, raw=False):
    """{0,1} subcell masks from barycentric maps (A, b) (lambda = A x + b):
    subcell c takes a point when its L1 distance sum_j max(-lambda_j, 0) is
    at most the parent's plus ``tol`` (1e-12 in float64, 1e-5 otherwise).
    ``unique`` keeps the first hit in subcell order; otherwise every mask is
    divided by the cover count (with ``raw``, the undivided masks and the
    cover count -- None when ``unique`` -- come back instead).

    Below float64 the distances are elementwise operations in a fixed
    order, which the kernels' float binning (``csrc/binning.cuh``) repeats
    bit for bit: there a rounding step is ~1e-7 against a tolerance of
    1e-5, and a point binned differently would move a table entry by
    O(tol)."""
    if not _is_tensor(pts):
        pts = torch.as_tensor(np.asarray(pts, dtype=np.float64))
    f64 = pts.dtype == torch.float64
    if tol is None:
        tol = 1e-12 if f64 else 1e-5

    def distance(A, b):
        A, b = pts.new_tensor(np.asarray(A)), pts.new_tensor(np.asarray(b))
        if f64:
            bary = pts @ A.T + b
            return 0.5 * abs((abs(bary) - bary).sum(-1))
        bary = pts[:, :1] * A[:, 0]
        for i in range(1, A.shape[1]):
            bary = bary + pts[:, i:i + 1] * A[:, i]
        bary = bary + b
        t = abs(bary) - bary
        s = t[:, 0]
        for j in range(1, t.shape[1]):
            s = s + t[:, j]
        return 0.5 * abs(s)

    best = distance(*parent_map) + tol
    masks = []
    taken = None
    for A, b in cell_maps:
        m = (distance(A, b) <= best).to(pts.dtype)
        if unique:
            if taken is not None:
                m = m * (1.0 - taken)
                taken = torch.maximum(taken, m)
            else:
                taken = m
        masks.append(m)
    if raw:
        return masks, (None if unique else sum(masks))
    if not unique:
        total = sum(masks)
        masks = [m / total for m in masks]
    return masks
