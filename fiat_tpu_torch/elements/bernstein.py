"""Bernstein element.

Counterpart of ``fiat_tpu/elements/bernstein.py``: a non-Ciarlet element
whose basis functions are the Bernstein polynomials in barycentric
coordinates, with a pointwise-recovered dual.  D^alpha of the degree-n
basis is a falling factorial times a few weighted gathers of the
degree-(n-o) Bernstein value table (dB_K/db_j = n B_{K-e_j}), with the
Cartesian chain rule folded into the gather weights as the monomial
coefficients of prod_d (R2B . t)^alpha_d.  The order-0 table is K8's
feature table (``ops/bernstein.py``) with its rows in ``mis`` order.
"""

import math

import numpy as np

from ..core.cells import make_lattice
from ..core.dualset import DualSet
from ..core.expansions import mis
from ..core.finite_element import FiniteElement
from ..core.pointwise_dual import compute_pointwise_dual


def _multiindices(nvars, degree):
    """All barycentric multi-indices of one degree, in the canonical
    (dof) order, as an integer array."""
    return np.asarray(mis(nvars, degree), dtype=int)


def _btable(bary, K):
    """Value table (len(K), npts) of the Bernstein monomials
    multinomial(K) * prod_j b_j^K_j at barycentric points."""
    coef = np.asarray([math.factorial(int(k.sum()))
                       // math.prod(math.factorial(int(x)) for x in k)
                       for k in K], dtype=float)
    return coef[:, None] * np.prod(
        bary.T[None, :, :] ** K[:, :, None], axis=1)


def _chain_weights(R2B, alpha):
    """Barycentric monomial coefficients {beta: w} of
    prod_d (sum_j R2B[j, d] t_j)^alpha_d -- the Cartesian->barycentric
    chain rule for the derivative multi-index ``alpha``."""
    nb = R2B.shape[0]
    acc = {(0,) * nb: 1.0}
    for d, a in enumerate(alpha):
        for _ in range(a):
            nxt = {}
            for beta, w in acc.items():
                for j in range(nb):
                    key = beta[:j] + (beta[j] + 1,) + beta[j + 1:]
                    nxt[key] = nxt.get(key, 0.0) + w * R2B[j, d]
            acc = nxt
    return acc


class BernsteinDualSet(DualSet):
    """Entity layout of the Bernstein DoFs: multi-index i belongs to the
    entity whose vertex set equals the support of its multi-index.  The
    nodes themselves are filled by the pointwise dual."""

    def __init__(self, ref_el, degree):
        top = ref_el.get_topology()
        K = _multiindices(ref_el.get_spatial_dimension() + 1, degree)
        support = K > 0
        entity_ids = {
            dim: {e: np.flatnonzero(
                      support[:, list(verts)].all(axis=1)
                      & (support.sum(axis=1) == len(verts))).tolist()
                  for e, verts in ents.items()}
            for dim, ents in top.items()}
        super().__init__([None] * len(K), ref_el, entity_ids)


class Bernstein(FiniteElement):
    """The Bernstein basis element."""

    def __init__(self, ref_el, degree):
        dual = BernsteinDualSet(ref_el, degree)
        super().__init__(ref_el, dual, degree, 0)
        pts = make_lattice(ref_el.vertices, degree, variant="gll")
        self.dual = compute_pointwise_dual(self, pts)

    def degree(self):
        return self.get_order()

    def value_shape(self):
        return ()

    def tabulate(self, order, points, entity=None):
        ref_el = self.get_reference_element()
        dim = ref_el.get_spatial_dimension()
        if entity is None:
            entity = (dim, 0)
        points = ref_el.get_entity_transform(*entity)(np.asarray(points))

        # Cartesian -> barycentric, and the inverse map for the chain rule
        vs = np.asarray(ref_el.get_vertices())
        R2B = np.linalg.inv(np.vstack([vs.T, np.ones(len(vs))]))
        bary = np.concatenate(
            [points, np.ones((*points.shape[:-1], 1))], axis=-1) @ R2B.T

        n = self.degree()
        K = _multiindices(dim + 1, n)
        result = {}
        falling = 1.0          # n! / (n-o)!
        for o in range(order + 1):
            alphas = mis(dim, o)
            if n - o < 0:
                result.update({alpha: np.zeros((len(K),
                                                *points.shape[:-1]))
                               for alpha in alphas})
                continue
            Ko = _multiindices(dim + 1, n - o)
            lookup = {tuple(k): i for i, k in enumerate(Ko)}
            V = _btable(bary, Ko)
            if o == n:
                # parity quirk: the reference's bernstein_db early-return
                # (FIAT/bernstein.py, the all-zero ls branch) skips the
                # multinomial coefficient at top order, reporting D^n as
                # 1/n! of the true derivative; matched here so tables
                # stay interchangeable
                falling = 1.0
            for alpha in alphas:
                out = np.zeros((len(K), *points.shape[:-1]))
                for beta, w in _chain_weights(R2B, alpha).items():
                    idx = np.asarray([lookup.get(tuple(k), -1)
                                      for k in K - np.asarray(beta)])
                    hit = idx >= 0
                    out[hit] += (falling * w) * V[idx[hit]]
                result[alpha] = out
            falling *= max(n - o, 1)
        return result
