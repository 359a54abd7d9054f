"""Kong-Mulder-Veldhuizen mass-lumped spectral simplicial elements and their
lumped quadrature rules.  Counterpart of
``fiat_tpu/elements/kong_mulder_veldhuizen.py``, with its own copy of the
point/weight constants: the published mass-lumping rules of Chin-Joe-Kong,
Mulder & Van Veldhuizen (tri, p<=6) and Geevers, Mulder & van der Vegt
(tet, p<=3)."""

import math

import numpy as np

from ..core import cells as cl
from ..core import finite_element, functionals
from ..core.dualset import DualSet
from ..core.expansions import polynomial_entity_ids
from ..core.polyset import ONPolynomialSet
from ..core.quadrature import QuadratureRule, map_quadrature
from ..core.variants import parse_lagrange_variant

# --- published lumped rules on the UFC triangle -----------------------------
# per degree: (alphas [edge class-3 sets], betas [bisector class-5 sets],
#              (gamma, delta) pairs [class-6 sets], weight blocks)
_TRI_RULES = {
    3: ([0.2934695559090401], [0.2073451756635909], [],
        [(3, 0.007436456512410291), (6, 0.02442084061702551),
         (3, 0.1103885289202054)]),
    4: ([0.2113248654051871], [0.4247639617258106, 0.130791593829745], [],
        [(3, 0.003174603174603175), (3, 0.0126984126984127),
         (6, 0.01071428571428571), (3, 0.07878121446939182),
         (3, 0.05058386489568756)]),
    5: ([0.3632980741536860, 0.1322645816327140],
        [0.4578368380791611, 0.2568591072619591, 0.5752768441141011e-1],
        [(0.7819258362551702e-1, 0.2210012187598900)],
        [(3, 0.7094239706792450e-3), (6, 0.6190565003676629e-2),
         (6, 0.3480578640489211e-2), (3, 0.3453043037728279e-1),
         (3, 0.4590123763076286e-1), (3, 0.1162613545961757e-1),
         (6, 0.2727857596999626e-1)]),
    6: ([8.29411811106452e-2, 2.68649695592714e-1],
        [4.68059729056814e-1, 7.93088545089875e-2, 3.92931636618867e-1],
        [(2.48172758709406e-1, 6.99812197147049e-1),
         (1.56582066033687e-1, 2.43089592364562e-1)],
        [(3, 5.35113520281665e-4), (3, 4.29435346026293e-3),
         (6, 3.02990950926060e-3), (6, 3.16396316646563e-3),
         (3, 2.43035184285235e-2), (3, 1.66312091329395e-2),
         (3, 3.42178857644876e-2), (6, 1.73480160090330e-2),
         (6, 1.98004044953264e-2)]),
}

_TET_EDGE_T = 0.314210342418033           # edge subdivision parameter, p=3
_TET_FACE_T = 0.21548220313557542         # face point parameter, p=3


def _tri_points(T, degree):
    alphas, betas, gd_pairs, _ = _TRI_RULES[degree]
    x = list(T.vertices)
    if degree % 2 == 0:
        for entity in T.topology[1]:
            x.extend(T.make_points(1, entity, 2))
    for a in alphas:
        x.extend([(1 - a, a), (a, 1 - a), (0.0, 1 - a),
                  (0.0, a), (a, 0.0), (1 - a, 0.0)])
    for b in betas:
        x.extend([(b, b), (1 - 2 * b, b), (b, 1 - 2 * b)])
    for g, d in gd_pairs:
        x.extend([(g, d), (1 - g - d, d), (g, 1 - g - d),
                  (d, g), (1 - g - d, g), (d, 1 - g - d)])
    return x


def kmv_quadrature(ref_el, degree):
    """The KMV lumped rule on a triangle (p<=6) or tetrahedron (p<=3)."""
    sd = ref_el.get_spatial_dimension()
    T = cl.ufc_simplex(sd)
    x = list(T.vertices)
    if degree == 1:
        w = np.full(len(x), T.volume() / len(x))
    elif degree == 2:
        for dim in range(1, sd + 1):
            for entity in T.topology[dim]:
                x.extend(T.make_points(dim, entity, dim + 1))
        w = np.zeros(len(x))
        if sd == 2:
            w[0:3], w[3:6], w[6] = 1 / 40, 1 / 15, 9 / 40
        elif sd == 3:
            w[0:4], w[4:10], w[10:14], w[14] = 17 / 5040, 2 / 315, 9 / 560, 16 / 315
        else:
            raise ValueError("Dimension not supported")
    elif sd == 3:
        if degree > 3:
            raise ValueError("Degree not supported")
        t, s = _TET_EDGE_T, 1.0 - _TET_EDGE_T
        x.extend([(0, s, t), (0, t, s), (t, 0, s), (s, 0, t), (s, t, 0.0),
                  (t, s, 0.0), (0, 0, s), (0, 0, t), (0, t, 0.0), (0, s, 0.0),
                  (t, 0, 0.0), (s, 0, 0.0)])
        a = _TET_FACE_T
        b = 1.0 - 2 * a
        x.extend([(a, b, a), (a, a, b), (b, a, a),
                  (0.0, b, a), (0.0, a, b), (0.0, a, a),
                  (b, 0.0, a), (a, 0.0, b), (a, 0.0, a),
                  (b, a, 0.0), (a, b, 0.0), (a, a, 0.0)])
        c = 1 / 6
        x.extend([(c, c, 0.5), (0.5, c, c), (c, 0.5, c), (c, c, c)])
        w = np.zeros(len(x))
        w[0:4] = 0.00068688236002531922325120561367839
        w[4:16] = 0.0015107814913526136472998739890272
        w[16:28] = 0.0050062894680040258624242888174649
        w[28:32] = 0.021428571428571428571428571428571
    elif sd == 2:
        if degree not in _TRI_RULES:
            raise ValueError("Degree not supported")
        x = _tri_points(T, degree)
        w = np.zeros(len(x))
        cur = 0
        for count, weight in _TRI_RULES[degree][3]:
            w[cur:cur + count] = weight
            cur += count
        assert cur == len(x)
    else:
        raise ValueError("Dimension not supported")

    x, w = map_quadrature(np.asarray(x), np.asarray(w), T, ref_el)
    return QuadratureRule(ref_el, x, w)


def bump(T, deg):
    """Interior-bubble degree raises per codimension for mass lumping."""
    sd = T.get_spatial_dimension()
    if deg == 1 or sd == 1:
        return ()
    if sd == 2:
        if deg < 5:
            return (1,)
        if deg in (5, 6):
            return (2,)
        raise ValueError("Degree not supported")
    if sd == 3:
        if deg < 4:
            return (2, 1)
        raise ValueError("Degree not supported")
    raise ValueError("Dimension of element is not supported")


def KongMulderVeldhuizenSpace(ref_el, deg):
    sd = ref_el.get_spatial_dimension()
    degree = [deg] * (sd + 1)
    for codim, raise_ in enumerate(bump(ref_el, deg)):
        degree[sd - codim] += raise_
    k = max(degree)
    P = ONPolynomialSet(ref_el, k, variant="bubble")
    entity_ids = polynomial_entity_ids(ref_el, k,
                                       continuity=P.get_expansion_set().continuity)
    ids = []
    for dim in entity_ids:
        num_bubbles = math.comb(degree[dim] - 1, dim)
        for entity in entity_ids[dim]:
            ids.extend(entity_ids[dim][entity][:num_bubbles])
    return P.take(ids)


class KongMulderVeldhuizenDualSet(DualSet):
    """Point evaluations at the lumped quadrature points."""

    def __init__(self, ref_el, degree):
        Q = kmv_quadrature(ref_el, degree) if ref_el.get_spatial_dimension() > 1 \
            else None
        if Q is None:
            from ..core.quadrature_schemes import create_quadrature
            Q = create_quadrature(ref_el, degree, scheme="KMV")
        points = Q.get_points()
        entity_ids = ref_el.point_entity_ids(points)
        nodes = [functionals.PointEvaluation(ref_el, x) for x in points]
        super().__init__(nodes, ref_el, entity_ids)


class KongMulderVeldhuizen(finite_element.CiarletElement):
    """The mass-lumped spectral simplicial element (diagonal mass matrix
    under the KMV quadrature)."""

    def __init__(self, ref_el, degree, variant=None):
        splitting, variant = parse_lagrange_variant(variant)
        if splitting:
            ref_el = splitting(ref_el)
        if ref_el.shape not in {cl.LINE, cl.TRIANGLE, cl.TETRAHEDRON}:
            raise ValueError("KMV is only valid for simplices of dimension <= 3.")
        if degree > 6 and ref_el.shape == cl.TRIANGLE:
            raise NotImplementedError("Only P < 7 implemented on triangles.")
        if degree > 3 and ref_el.shape == cl.TETRAHEDRON:
            raise NotImplementedError("Only P < 4 implemented on tetrahedra.")
        S = KongMulderVeldhuizenSpace(ref_el, degree)
        dual = KongMulderVeldhuizenDualSet(ref_el, degree)
        super().__init__(S, dual, S.degree, 0)
