"""Degree -> quadrature rule selection.

Counterpart of ``fiat_tpu/core/quadrature_schemes.py``.
The 'default' scheme picks the CHEAPEST of the interchangeable exact
candidates, exactly as fiat_tpu does, so the moment duals land on the
same points and the coefficients of the moment elements agree:

* the generated fully symmetric orbit rules (``symquad``), gated on weight
  conditioning sum|w| / sum w <= 2;
* the generated positive node-elimination rules (``elimquad``);
* collapsed Gauss (``((degree + 2) // 2) ** sd`` points);

with ties going to the symmetric rule, then elimination.  Lines and
points always take collapsed Gauss (Gauss-Jacobi).  Split complexes get
the composite rule (``macro.MacroQuadratureRule``); tensor-product cells
the product of their factors' rules (a degree per factor, or one for
all), and quadrilaterals and hexahedra those of their interval products.
``"KMV"`` takes the Kong-Mulder-Veldhuizen mass-lumping rules (GLL on a
line), and ``"gm"`` / ``"grundmann_moller"`` the Grundmann-Moller rules,
their alternating layer weights summed in exact rational arithmetic.
"""

import numpy as np

from . import cells as cl
from .quadrature import (FacetQuadratureRule,
                         GaussLobattoLegendreQuadratureLineRule, QuadratureRule,
                         make_quadrature, make_tensor_product_quadrature)


def create_quadrature(ref_el, degree, scheme="default", entity=None):
    """A rule integrating degree-``degree`` polynomials exactly on
    ``ref_el`` (or one of its subentities, via ``entity=(dim, id)``)."""
    if entity is not None:
        dimension, entity_id = entity
        sub_el = ref_el.construct_subelement(dimension)
        Q_ref = create_quadrature(sub_el, degree, scheme=scheme)
        return FacetQuadratureRule(ref_el, dimension, entity_id, Q_ref)

    if ref_el.is_macrocell():
        from .macro import MacroQuadratureRule
        sub_el = ref_el.construct_subelement(ref_el.get_dimension())
        Q_ref = create_quadrature(sub_el, degree, scheme=scheme)
        return MacroQuadratureRule(ref_el, Q_ref)

    if ref_el.get_shape() == cl.TENSORPRODUCT:
        try:
            degree = tuple(degree)
        except TypeError:
            degree = (degree,) * len(ref_el.cells)
        assert len(ref_el.cells) == len(degree)
        return make_tensor_product_quadrature(
            *[create_quadrature(c, d, scheme) for c, d in zip(ref_el.cells, degree)])

    if ref_el.get_shape() in (cl.QUADRILATERAL, cl.HEXAHEDRON):
        return create_quadrature(ref_el.product, degree, scheme)

    if degree < 0:
        raise ValueError(f"Need positive degree, not {degree}")

    if scheme == "default":
        sd = ref_el.get_spatial_dimension()
        if sd >= 2:
            candidates = []
            try:
                from .symquad import RULE_COND_MAX, rule_size
                candidates.append((rule_size(sd, degree, max_cond=RULE_COND_MAX),
                                   _gated_symmetric_scheme))
            except KeyError:
                pass
            try:
                from .elimquad import rule_size as elim_rule_size
                candidates.append((elim_rule_size(degree, sd), _general_elim_scheme))
            except KeyError:
                pass
            candidates.append((((degree + 2) // 2) ** sd, _collapsed_scheme))
            # stable min: the (conditioning-gated) symmetric rule wins ties
            _, builder = min(candidates, key=lambda t: t[0])
            return builder(ref_el, degree)
        return _collapsed_scheme(ref_el, degree)
    if scheme == "canonical":
        return _collapsed_scheme(ref_el, degree)
    if scheme in ("gm", "grundmann_moller"):
        return _grundmann_moller_scheme(ref_el, degree)
    if scheme in ("symmetric", "xg"):
        return _symmetric_scheme(ref_el, degree)
    if scheme == "KMV":
        return _kmv_lump_scheme(ref_el, degree)
    raise ValueError(f"Unknown quadrature scheme {scheme!r}")


def _symmetric_scheme(ref_el, degree):
    """Generated fully symmetric simplex rule (core/symquad.py); raises
    KeyError when no generated rule covers the degree."""
    from .symquad import symmetric_rule
    return symmetric_rule(ref_el, degree)


def _gated_symmetric_scheme(ref_el, degree):
    """Symmetric rule restricted to weight-conditioning <= RULE_COND_MAX
    (the 'default' dispatch path)."""
    from .symquad import RULE_COND_MAX, symmetric_rule
    return symmetric_rule(ref_el, degree, max_cond=RULE_COND_MAX)


def _general_elim_scheme(ref_el, degree):
    """Generated general (asymmetric, positive) simplex rule."""
    from .elimquad import general_rule
    return general_rule(ref_el, degree)


def _grundmann_moller_scheme(ref_el, degree):
    """Grundmann & Moller (1978) fully symmetric simplex rule of the
    requested exactness: degree 2s+1 with binom(s+dim, dim) points on
    the s-th member.  Points are barycentric lattice nodes; weights have
    alternating signs (use scheme='canonical' when positivity matters,
    e.g. lumping).

    Layer weights and their normalisation are accumulated in exact
    rational arithmetic (the alternating sum cancels catastrophically in
    floats past s ~ 12) and rounded once at the end."""
    from fractions import Fraction
    from math import factorial

    d = ref_el.get_spatial_dimension()
    s = degree // 2  # rule of degree 2s+1 >= degree
    if 2 * s + 1 < degree:
        s += 1

    verts = np.asarray(ref_el.get_vertices(), dtype=np.float64)
    pts, wts, counts = [], [], []
    for i in range(s + 1):
        # i-th layer weight (Grundmann & Moller 1978, Theorem 4): the
        # global constant is fixed afterwards by matching the volume
        w = Fraction((-1) ** i * (d + 2 * s + 1 - 2 * i) ** (2 * s + 1),
                     factorial(i) * factorial(d + 2 * s + 1 - i))
        denom = float(d + 2 * s + 1 - 2 * i)
        layer = [np.array([(2 * k + 1) / denom for k in kk]) @ verts
                 for kk in _compositions(d + 1, s - i)]
        pts.extend(layer)
        wts.append(w)
        counts.append(len(layer))
    total = sum(w * c for w, c in zip(wts, counts))
    vol = ref_el.volume()
    wts = np.concatenate([np.full(c, float(w / total) * vol)
                          for w, c in zip(wts, counts)])
    return QuadratureRule(ref_el, np.asarray(pts), wts)


def _compositions(parts, total):
    """All tuples of ``parts`` nonnegative ints summing to ``total``."""
    if parts == 1:
        yield (total,)
        return
    for first in range(total + 1):
        for rest in _compositions(parts - 1, total - first):
            yield (first,) + rest


def _collapsed_scheme(ref_el, degree):
    """Collapsed Gauss rule exact to the requested degree."""
    return make_quadrature(ref_el, (degree + 2) // 2)


def _kmv_lump_scheme(ref_el, degree):
    """Kong-Mulder-Veldhuizen spectral mass-lumping rules."""
    if ref_el.get_spatial_dimension() == 1:
        return GaussLobattoLegendreQuadratureLineRule(ref_el, degree + 1)
    from ..elements.kong_mulder_veldhuizen import kmv_quadrature
    return kmv_quadrature(ref_el, degree)
