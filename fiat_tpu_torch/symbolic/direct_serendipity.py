"""Directly defined serendipity elements on general convex quadrilaterals.

Counterpart of ``fiat_tpu/symbolic/direct_serendipity.py`` (parity with
FInAT's ``finat/direct_serendipity.py``, Arbogast & Tao 2017/2018): the
basis is built once in sympy with *symbolic* physical vertex coordinates,
and tabulation substitutes the runtime geometry -- FInAT rewrites into
gem; here the trees are evaluated against the bound arrays via
sympy2array: host numpy, or torch tensors on the geometry's device, where
the tables then come back as one tensor per derivative on that device.

Being physically defined, the element needs no reference mapping at all:
``mapping() == "physical"``."""

import numpy as np
import sympy as sp
import torch

from ..core.cells import UFCQuadrilateral
from ..core.expansions import mis
from .base import FiniteElementBase
from .citations import cite
from .physically_mapped import DirectlyDefinedElement
from .point_set import _is_traced
from .sympy2array import evaluate_sympy


def _vertex_symbols():
    return np.asarray(list(zip(sp.symbols("x:4"), sp.symbols("y:4"))))


def _edge_frame(ct, vs, xx):
    """Edge tangents, inward normals, midpoints, and the affine edge
    functions lam_e (zero on edge e, positive inside)."""
    ts = np.zeros((4, 2), dtype=object)
    ns = np.zeros((4, 2), dtype=object)
    xstars = np.zeros((4, 2), dtype=object)
    for e in range(4):
        v0, v1 = ct[1][e]
        ts[e, :] = vs[v1, :] - vs[v0, :]
        xstars[e, :] = (vs[v0, :] + vs[v1, :]) / 2
    for e in (0, 3):
        ns[e, :] = (-ts[e, 1], ts[e, 0])
    for e in (1, 2):
        ns[e, :] = (ts[e, 1], -ts[e, 0])
    lams = [(xx - xstars[e, :]) @ ns[e, :] for e in range(4)]
    return ts, ns, xstars, lams


def _sub(xx, pt):
    return {xx[0]: pt[0], xx[1]: pt[1]}


def ds1_basis(ct, vs, xx):
    """Lowest-order direct serendipity: 4 vertex functions including the
    rational correction R (FInAT: direct_serendipity.py:136-215)."""
    ts, ns, xstars, lams = _edge_frame(ct, vs, xx)

    RV = (lams[0] - lams[1]) / (lams[0] + lams[1])
    RH = (lams[2] - lams[3]) / (lams[2] + lams[3])
    Rs = [RV, RH]

    xis = []
    for e in range(4):
        d = _sub(xx, xstars[e, :])
        i = 2 * ((3 - e) // 2)
        j = i + 1
        xi = (lams[i] * lams[j] * (1 + (-1) ** (e + 1) * Rs[e // 2])
              / lams[i].subs(d) / lams[j].subs(d) / 2)
        xis.append(xi)

    d = _sub(xx, vs[0, :])
    r = lams[1] * lams[3] / lams[1].subs(d) / lams[3].subs(d)
    d = _sub(xx, vs[2, :])
    r -= lams[0] * lams[3] / lams[0].subs(d) / lams[3].subs(d)
    d = _sub(xx, vs[3, :])
    r += lams[0] * lams[2] / lams[0].subs(d) / lams[2].subs(d)
    d = _sub(xx, vs[1, :])
    r -= lams[1] * lams[2] / lams[1].subs(d) / lams[2].subs(d)
    R = r - sum(r.subs(_sub(xx, xstars[i, :])) * xis[i] for i in range(4))

    rot = np.array([[0, -1], [1, 0]])
    lam03 = (xx - vs[0, :]) @ (rot @ (vs[3, :] - vs[0, :]))
    lam12 = (xx - vs[2, :]) @ (rot @ (vs[2, :] - vs[1, :]))

    tildes = [lam12 - lam12.subs(_sub(xx, vs[3, :])) * (1 + R) / 2,
              lam03 - lam03.subs(_sub(xx, vs[2, :])) * (1 - R) / 2,
              lam03 - lam03.subs(_sub(xx, vs[1, :])) * (1 - R) / 2,
              lam12 - lam12.subs(_sub(xx, vs[0, :])) * (1 + R) / 2]
    phis = [t / t.subs(_sub(xx, vs[i, :])) for i, t in enumerate(tildes)]
    nodes = [tuple(vs[i, :]) for i in range(4)]
    return np.asarray(phis), nodes


def _newton_poly(nds, fs, s):
    """Newton-form interpolating polynomial through (nds, fs) in s."""
    n = len(nds)
    mat = np.zeros((n, n), dtype=object)
    mat[:, 0] = fs[:]
    for j in range(1, n):
        for i in range(n - j):
            mat[i, j] = (mat[i + 1, j - 1] - mat[i, j - 1]) \
                / (nds[i + j] - nds[i])
    coeffs = mat[0, :]
    result = coeffs[-1]
    for i in range(n - 2, -1, -1):
        result = result * (s - nds[i]) + coeffs[i]
    return result


def dsr_basis(ct, r, vs, xx):
    """Degree >= 2 direct serendipity (FInAT:
    direct_serendipity.py:256-478): polynomials of degree r plus two
    rational functions, nodal at vertices, edge lattice points, and an
    interior triangular lattice."""
    ts, ns, xstars, lams = _edge_frame(ct, vs, xx)
    bubble = np.prod(lams)

    # interior functions and nodes
    if r < 4:
        internal_bfs, internal_nodes = [], []
    elif r == 4:
        centroid = (sum(vs[i, 0] for i in range(4)) / 4,
                    sum(vs[i, 1] for i in range(4)) / 4)
        internal_bfs = [bubble / bubble.subs(_sub(xx, centroid))]
        internal_nodes = [centroid]
    else:
        dx0 = (vs[1, :] - vs[0, :]) / (r - 2)
        dx1 = (vs[2, :] - vs[0, :]) / (r - 2)
        v0 = vs[0, :] + dx0 + dx1
        v1 = vs[0, :] + (r - 3) * dx0 + dx1
        v2 = vs[0, :] + dx0 + (r - 3) * dx1
        # barycentric coordinates of the interior triangle
        y12 = v1[1] - v2[1]
        x21 = v2[0] - v1[0]
        x02 = v0[0] - v2[0]
        y02 = v0[1] - v2[1]
        det = y12 * x02 + x21 * y02
        delx = xx[0] - v2[0]
        dely = xx[1] - v2[1]
        bary = [(y12 * delx + x21 * dely) / det,
                (-y02 * delx + x02 * dely) / det, None]
        bary[2] = 1 - bary[0] - bary[1]

        # equispaced-lattice Lagrange polynomials of degree r-4, built
        # multiplicatively to avoid symbolic Vandermonde inversion
        rm4 = r - 4
        internal_bfs, internal_nodes = [], []
        for i in range(rm4, -1, -1):
            for j in range(rm4 - i, -1, -1):
                k = rm4 - i - j
                node = tuple((v0 * i + v1 * j + v2 * k) / rm4)
                lag = sp.Integer(1)
                for q, iq in enumerate((i, j, k)):
                    for p in range(iq):
                        lag *= (rm4 * bary[q] - p) / (iq - p)
                foo = lag.simplify() * bubble
                internal_bfs.append(foo / foo.subs(_sub(xx, node)))
                internal_nodes.append(node)

    RV = (lams[0] - lams[1]) / (lams[0] + lams[1])
    RH = (lams[2] - lams[3]) / (lams[2] + lams[3])
    Rs = [(1 - RV) / 2, (1 + RV) / 2, (1 - RH) / 2, (1 + RH) / 2]

    nodes1d = [sp.Rational(i, r) for i in range(1, r)]
    s = sp.Symbol("s")

    opposite = {e: next(f for f in ct[1]
                        if not set(ct[1][e]) & set(ct[1][f]))
                for e in ct[1]}
    adjacent = {e: tuple(sorted(f for f in ct[1] if f != e
                                and set(ct[1][e]) & set(ct[1][f])))
                for e in ct[1]}
    tunnel_R = {e: ((lams[adjacent[e][0]] - lams[adjacent[e][1]])
                    / (lams[adjacent[e][0]] + lams[adjacent[e][1]]))
                for e in range(4)}

    edge_nodes = []
    for e in range(4):
        (v0x, v0y), (v1x, v1y) = vs[ct[1][e], :]
        edge_nodes.append([(v0x + nd * (v1x - v0x), v0y + nd * (v1y - v0y))
                           for nd in nodes1d])

    def nodalize(f):
        return f - sum(f.subs(_sub(xx, nd)) * bf
                       for bf, nd in zip(internal_bfs, internal_nodes))

    edge_bfs = []
    if r == 2:
        for e in range(4):
            pre = lams[adjacent[e][0]] * lams[adjacent[e][1]] * Rs[e]
            edge_bfs.append([nodalize(pre)
                             / pre.subs(_sub(xx, xstars[e]))])
    else:
        for e in range(4):
            (v0x, v0y), (v1x, v1y) = vs[ct[1][e], :]
            Rcur = tunnel_R[e]
            lam_op = lams[opposite[e]]
            cur = []
            for i in range(len(nodes1d)):
                idcs = [j for j in range(len(nodes1d)) if i != j]
                # interpolate the rational tail at the other nodes
                pvals = []
                for j in idcs:
                    d = _sub(xx, edge_nodes[e][j])
                    pvals.append(-Rcur.subs(d) ** (r - 2) / lam_op.subs(d))
                ptilde = _newton_poly([nodes1d[j] for j in idcs], pvals, s)
                xt = xx @ ts[e]
                vt0 = np.asarray((v0x, v0y)) @ ts[e]
                vt1 = np.asarray((v1x, v1y)) @ ts[e]
                p = ptilde.subs({s: (xt - vt0) / (vt1 - vt0)})
                pre = (lams[adjacent[e][0]] * lams[adjacent[e][1]]
                       * (lam_op * p + Rcur ** (r - 2) * Rs[e]))
                pre = nodalize(pre)
                cur.append(pre / pre.subs(_sub(xx, edge_nodes[e][i])))
            edge_bfs.append(cur)

    v_adj_edges = {v: tuple(e for e in ct[1] if v in ct[1][e])
                   for v in ct[0]}
    v_off_edges = {v: tuple(e for e in ct[1] if v not in ct[1][e])
                   for v in ct[0]}
    vertex_bfs = []
    for v in range(4):
        e0, e1 = v_off_edges[v]
        pre = lams[e0] * lams[e1]
        for ae in v_adj_edges[v]:
            for nd, edbf in zip(edge_nodes[ae], edge_bfs[ae]):
                d = _sub(xx, nd)
                pre -= lams[e0].subs(d) * lams[e1].subs(d) * edbf
        vertex_bfs.append(nodalize(pre) / pre.subs(_sub(xx, vs[v, :])))

    bfs = list(vertex_bfs)
    nodes = [tuple(vs[i, :]) for i in range(4)]
    for e in range(4):
        bfs.extend(edge_bfs[e])
        nodes.extend(edge_nodes[e])
    bfs.extend(internal_bfs)
    nodes.extend(internal_nodes)
    return np.asarray(bfs), nodes


class DirectSerendipity(DirectlyDefinedElement, FiniteElementBase):
    """Arbogast's directly defined C0 serendipity element on convex
    quadrilaterals."""

    def __init__(self, cell, degree):
        cite("Arbogast2017")
        assert isinstance(cell, UFCQuadrilateral)
        self._cell = cell
        self._degree = degree
        self._deriv_cache = {}
        self._basis_cache = None

    @property
    def cell(self):
        return self._cell

    @property
    def complex(self):
        return self._cell

    @property
    def degree(self):
        return self._degree

    @property
    def formdegree(self):
        return 0

    def entity_dofs(self):
        d = self.degree
        if d == 1:
            return {0: {i: [i] for i in range(4)},
                    1: {i: [] for i in range(4)},
                    2: {0: []}}
        return {0: {i: [i] for i in range(4)},
                1: {i: list(range(4 + i * (d - 1), 4 + (i + 1) * (d - 1)))
                    for i in range(4)},
                2: {0: list(range(4 + 4 * (d - 1), self.space_dimension()))}}

    def space_dimension(self):
        d = self.degree
        return 4 if d == 1 else (d + 1) * (d + 2) // 2 + 2

    @property
    def index_shape(self):
        return (self.space_dimension(),)

    @property
    def value_shape(self):
        return ()

    @property
    def _basis(self):
        if self._basis_cache is None:
            vs = _vertex_symbols()
            xx = np.asarray(sp.symbols("x,y"))
            ct = self.cell.get_topology()
            if self.degree == 1:
                phis, nodes = ds1_basis(ct, vs, xx)
            else:
                phis, nodes = dsr_basis(ct, self.degree, vs, xx)
            self._basis_cache = (vs, xx, phis, nodes)
        return self._basis_cache

    def _basis_deriv(self, alpha):
        try:
            return self._deriv_cache[alpha]
        except KeyError:
            vs, xx, phis, _ = self._basis
            dphis = tuple(phi.diff(*zip(xx, alpha)) for phi in phis)
            return self._deriv_cache.setdefault(alpha, dphis)

    def basis_evaluation(self, order, ps, entity=None,
                         coordinate_mapping=None):
        vs, xx, phis, _ = self._basis
        phys_verts = coordinate_mapping.physical_vertices()
        phys_points = coordinate_mapping.physical_points(ps, entity=entity)
        if isinstance(phys_points, (list, tuple)):
            phys_points = (torch.stack(list(phys_points))
                           if any(_is_traced(p) for p in phys_points)
                           else np.asarray(phys_points))

        bindings = {}
        for idx in np.ndindex(vs.shape):
            bindings[vs[idx]] = phys_verts[idx]
        for k in range(2):
            bindings[xx[k]] = phys_points[..., k]

        pts_shape = tuple(phys_points.shape[:-1])
        like = next((x for x in (phys_points, phys_verts) if _is_traced(x)), None)
        if like is None:
            def lift(val):       # broadcast constants
                return val + np.zeros(pts_shape)
        else:
            zeros = torch.zeros(pts_shape, dtype=torch.float64, device=like.device)

            def lift(val):       # broadcast constants, on the geometry's device
                return torch.as_tensor(val, dtype=torch.float64, device=like.device) + zeros
        cache = {}
        result = {}
        for o in range(order + 1):
            for alpha in mis(2, o):
                rows = []
                for dphi in self._basis_deriv(alpha):
                    val = evaluate_sympy(dphi, bindings, cache)
                    rows.append(lift(val))
                result[alpha] = np.stack(rows) if like is None else torch.stack(rows)
        return result

    def point_evaluation(self, order, point, entity=None,
                         coordinate_mapping=None):
        raise NotImplementedError(
            "Point evaluation not implemented for DirectSerendipity")

    @property
    def mapping(self):
        return "physical"

    @property
    def nodes(self):
        """Symbolic node positions (in terms of vertex symbols)."""
        return self._basis[3]
