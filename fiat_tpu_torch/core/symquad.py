"""Fully symmetric Gauss rules on simplices.

Counterpart of ``fiat_tpu/core/symquad.py``: rules are stored as symmetry
ORBITS of the simplex's permutation group (barycentric generators plus one
weight per orbit) in ``core/symquad_data.py``, loaded on first use
(``quad_tables``), and expanded to points and weights on demand.

Orbit types (barycentric):
  triangle:  S3 ();  S21 (a,);  S111 (a, b)
  tet:       S4 ();  S31 (a,);  S22 (a,);  S211 (a, b);  S1111 (a, b, c)
"""

from itertools import permutations

import numpy as np

from .quad_tables import load_table


def _orbit(bary):
    """All distinct permutations of one barycentric generator."""
    return sorted(set(permutations(bary)))


def orbit_bary(kind, params):
    """Barycentric coordinates (npts, sd+1) of one orbit."""
    if kind == "S3":
        return np.array([[1, 1, 1]]) / 3.0
    if kind == "S21":
        a, = params
        return np.array(_orbit((a, a, 1 - 2 * a)))
    if kind == "S111":
        a, b = params
        return np.array(_orbit((a, b, 1 - a - b)))
    if kind == "S4":
        return np.array([[1, 1, 1, 1]]) / 4.0
    if kind == "S31":
        a, = params
        return np.array(_orbit((a, a, a, 1 - 3 * a)))
    if kind == "S22":
        a, = params
        return np.array(_orbit((a, a, 0.5 - a, 0.5 - a)))
    if kind == "S211":
        a, b = params
        return np.array(_orbit((a, a, b, 1 - 2 * a - b)))
    if kind == "S1111":
        a, b, c = params
        return np.array(_orbit((a, b, c, 1 - a - b - c)))
    raise KeyError(kind)


ORBIT_SIZE = {"S3": 1, "S21": 3, "S111": 6,
              "S4": 1, "S31": 4, "S22": 6, "S211": 12, "S1111": 24}


def expand_rule(orbits):
    """[(kind, params, weight)] -> (barycentric points, weights), with the
    orbit weight shared by every point of the orbit.  Stored weights
    integrate over the UFC simplex (volume 1/d!); the caller rescales by
    the volume ratio for other cells."""
    pts, wts = [], []
    for kind, params, w in orbits:
        B = orbit_bary(kind, params)
        pts.append(B)
        wts.append(np.full(len(B), w))
    return np.vstack(pts), np.concatenate(wts)


# Weight-conditioning gate for the 'default' scheme: sum|w| / sum w.
# Rules above this make variable-coefficient mass matrices indefinite and
# amplify roundoff; the reference's XG tables are strictly positive
# (cond 1.0), so 'default' only serves rules close to that.  Explicit
# scheme='symmetric' requests bypass the gate.
RULE_COND_MAX = 2.0


def rule_cond(orbits):
    """Weight conditioning sum|w|/sum w of an orbit rule (1.0 iff all
    weights are positive)."""
    num = sum(abs(w) * ORBIT_SIZE[k] for k, _, w in orbits)
    den = sum(w * ORBIT_SIZE[k] for k, _, w in orbits)
    return num / den


def _best_covering_degree(table, degree, max_cond=None):
    """The stored degree >= ``degree`` with the FEWEST points (a
    higher-degree rule is a valid -- and occasionally cheaper -- rule
    for a lower request, e.g. when elimination converged better there).
    With ``max_cond``, only rules whose weight conditioning passes the
    gate are considered."""
    cands = [d for d in table if d >= max(degree, 1)]
    if max_cond is not None:
        cands = [d for d in cands if rule_cond(table[d]) <= max_cond]
    if not cands:
        raise KeyError(degree)
    return min(cands, key=lambda d: sum(ORBIT_SIZE[k]
                                        for k, _, _ in table[d]))


_RESOLVE_CACHE = {}


def _resolve(dim, degree, max_cond):
    """Memoized covering-degree lookup: element constructors call
    create_quadrature -> rule_size AND symmetric_rule per moment set, and
    each covering scan recomputes rule_cond over the stored tail."""
    key = (dim, degree, max_cond)
    try:
        return _RESOLVE_CACHE[key]
    except KeyError:
        pass
    symquad_data = load_table("symquad_data")
    table = symquad_data.TRIANGLE if dim == 2 else symquad_data.TETRAHEDRON
    d = _best_covering_degree(table, degree, max_cond=max_cond)
    _RESOLVE_CACHE[key] = d
    return d


def rule_size(dim, degree, max_cond=None):
    """Point count of the symmetric rule serving ``degree``; raises
    KeyError when uncovered (or covered only by rules failing the
    ``max_cond`` weight-conditioning gate)."""
    symquad_data = load_table("symquad_data")
    table = symquad_data.TRIANGLE if dim == 2 else symquad_data.TETRAHEDRON
    d = _resolve(dim, degree, max_cond)
    return sum(ORBIT_SIZE[kind] for kind, _, _ in table[d])


def symmetric_rule(ref_el, degree, max_cond=None):
    """The generated symmetric rule of exactness >= degree on a simplex,
    mapped to ref_el's coordinates.  Raises KeyError when no generated
    rule covers the degree (caller falls back to GM / collapsed)."""
    symquad_data = load_table("symquad_data")
    from .quadrature import QuadratureRule
    sd = ref_el.get_spatial_dimension()
    table = symquad_data.TRIANGLE if sd == 2 else symquad_data.TETRAHEDRON
    orbits = table[_resolve(sd, degree, max_cond)]
    bary, wts = expand_rule(orbits)
    verts = np.asarray(ref_el.get_vertices(), dtype=float)
    from math import factorial
    scale = ref_el.volume() * factorial(sd)   # vs the UFC simplex's 1/d!
    return QuadratureRule(ref_el, bary @ verts, wts * scale)
