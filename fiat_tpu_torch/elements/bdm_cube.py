"""Brezzi-Douglas-Marini elements on quadrilateral cells.

Counterpart of ``fiat_tpu/elements/bdm_cube.py``, after Brezzi, Douglas &
Marini (1985) and Brezzi, Douglas, Fortin & Marini (1987):
BDM_j(K) = [P_j(K)^2 + span(curl(x y^{j+1}, x^{j+1} y))] on a rectangle,
tabulated by vectorised lambdify through ``SympyVectorElement``."""

from sympy import binomial
from sympy import legendre as leg

from ..core.cells import flatten_reference_cube
from .sympy_vector import SympyVectorElement, cube_geometry


def bdmce_basis(flat_el, degree):
    """The curl-conforming BDM-cube basis: per edge, ``degree`` plain
    tangential Legendre moments plus one curl-augmented function whose
    curl stays in P_{degree-1}; then interior bubbles (reference:
    brezzi_douglas_marini_cube.py:140-213)."""
    (dx, dy), (mx, my) = cube_geometry(flat_el)
    bx = dx[0] * dx[1]
    by = dy[0] * dy[1]
    # scaling that matches the leading coefficient of leg(degree, 2x-1)
    coeff = binomial(2 * degree, degree) / (
        (degree + 1) * binomial(2 * degree - 2, degree - 1))

    basis = [(0, -leg(j, my) * dx[0]) for j in range(degree)]
    basis += [(-coeff * leg(degree - 1, my) * by, -leg(degree, my) * dx[0])]
    basis += [(0, -leg(j, my) * dx[1]) for j in range(degree)]
    basis += [(coeff * leg(degree - 1, my) * by, -leg(degree, my) * dx[1])]
    basis += [(-leg(j, mx) * dy[0], 0) for j in range(degree)]
    basis += [(-leg(degree, mx) * dy[0], -coeff * leg(degree - 1, mx) * bx)]
    basis += [(-leg(j, mx) * dy[1], 0) for j in range(degree)]
    basis += [(-leg(degree, mx) * dy[1], coeff * leg(degree - 1, mx) * bx)]

    for k in range(2, degree + 1):
        for j in range(k - 1):
            basis += [(0, leg(j, mx) * leg(k - 2 - j, my) * bx)]
            basis += [(leg(k - 2 - j, mx) * leg(j, my) * by, 0)]
    return basis


def _entity_ids(flat_el, degree, nbf):
    top = flat_el.get_topology()
    ids = {d: {e: [] for e in ents} for d, ents in top.items()}
    cur = 0
    for j in sorted(top[1]):
        ids[1][j] = list(range(cur, cur + degree + 1))
        cur += degree + 1
    ids[2][0] = list(range(cur, nbf))
    return ids


def _check(ref_el, degree):
    if degree < 1:
        raise ValueError("BDM-cube elements only valid for degree >= 1")
    flat_el = flatten_reference_cube(ref_el)
    if flat_el.get_spatial_dimension() != 2:
        raise ValueError("BDM-cube elements only valid in dimension 2")
    return flat_el


class BrezziDouglasMariniCubeEdge(SympyVectorElement):
    """BDMCE: the curl-conforming BDM element on quads."""

    def __init__(self, ref_el, degree):
        flat_el = _check(ref_el, degree)
        basis = bdmce_basis(flat_el, degree)
        ids = _entity_ids(flat_el, degree, len(basis))
        super().__init__(ref_el, degree, "covariant piola", 1, basis, ids)


class BrezziDouglasMariniCubeFace(SympyVectorElement):
    """BDMCF: the div-conforming BDM element on quads (rotation of
    BDMCE)."""

    def __init__(self, ref_el, degree):
        flat_el = _check(ref_el, degree)
        basis = [(-b[1], b[0]) for b in bdmce_basis(flat_el, degree)]
        ids = _entity_ids(flat_el, degree, len(basis))
        super().__init__(ref_el, degree, "contravariant piola", 1, basis,
                         ids)
