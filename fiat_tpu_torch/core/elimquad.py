"""General (asymmetric) positive-weight simplex quadrature.

Counterpart of ``fiat_tpu/core/elimquad.py``: node-elimination rules with
strictly positive weights, stored in ``core/triquad_data.py`` and
``tetquad_data.py`` (loaded on first use, ``quad_tables``) as degree ->
(barycentric points flat, weights); weights integrate over the UFC
reference simplex (sum = 1/d!) and are rescaled by ref_el.volume() * d!
on mapping, the same contract as ``symquad``.
"""

from math import factorial

import numpy as np

from .quad_tables import load_table


def _table(sd):
    if sd == 2:
        return load_table("triquad_data").TRIANGLE
    if sd == 3:
        return load_table("tetquad_data").TETRAHEDRON
    raise KeyError(sd)


def _best_covering_degree(table, degree):
    cands = [d for d in table if d >= max(degree, 1)]
    if not cands:
        raise KeyError(degree)
    return min(cands, key=lambda d: len(table[d][1]))


def rule_size(degree, sd=3):
    """Point count of the stored general rule serving ``degree``;
    KeyError when uncovered."""
    table = _table(sd)
    return len(table[_best_covering_degree(table, degree)][1])


def general_rule(ref_el, degree):
    """The stored general rule of exactness >= degree, mapped onto
    ``ref_el``.  Raises KeyError when uncovered."""
    from .quadrature import QuadratureRule
    sd = ref_el.get_spatial_dimension()
    table = _table(sd)
    bary_flat, wts = table[_best_covering_degree(table, degree)]
    bary = np.asarray(bary_flat, dtype=float).reshape(-1, sd + 1)
    verts = np.asarray(ref_el.get_vertices(), dtype=float)
    scale = ref_el.volume() * factorial(sd)
    return QuadratureRule(ref_el, bary @ verts,
                          np.asarray(wts, dtype=float) * scale)
