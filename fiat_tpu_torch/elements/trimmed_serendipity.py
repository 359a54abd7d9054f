"""Trimmed serendipity elements S-minus on quads and hexes.

Counterpart of ``fiat_tpu/elements/trimmed_serendipity.py``, after
Gillette & Kloefkorn, "Trimmed serendipity finite element differential
forms" (2019): the same basis lists, in the same order, tabulated by
vectorised lambdify.  As in fiat_tpu, every entity count is derived from
the generated basis, so space_dimension() equals the number of basis
functions; the face element is defined on quadrilaterals only."""

from sympy import legendre as leg

from ..core.cells import flatten_reference_cube
from .sympy_vector import SympyVectorElement, cube_geometry, tri


def _rotate(basis):
    """(u, v) -> (-v, u): turns curl-conforming pairs div-conforming."""
    return [(-b[1], b[0]) for b in basis]


# ---------------------------------------------------------------- 2-D ---

def edge_funcs_2d(deg, dfac, mid):
    """Edge functions: tangential Legendre moments on the four edges,
    ordered (x=0, x=1, y=0, y=1) to match sorted flat edge ids
    (Sminus.py:162-169)."""
    dx, dy = dfac
    mx, my = mid
    out = [(0, -leg(j, my) * dx[0]) for j in range(deg)]
    out += [(0, -leg(j, my) * dx[1]) for j in range(deg)]
    out += [(-leg(j, mx) * dy[0], 0) for j in range(deg)]
    out += [(-leg(j, mx) * dy[1], 0) for j in range(deg)]
    return out


def interior_tilde_2d(deg, dfac, mid):
    """The trimmed top-degree interior functions (Sminus.py:225-232)."""
    dx, dy = dfac
    mx, my = mid
    bx = dx[0] * dx[1]
    by = dy[0] * dy[1]
    out = [(leg(deg - 2, my) * by, 0), (0, leg(deg - 2, mx) * bx)]
    out += [(leg(k, mx) * leg(deg - k - 2, my) * by,
             -leg(k - 1, mx) * leg(deg - k - 1, my) * bx)
            for k in range(1, deg - 1)]
    return out


def interior_funcs_2d(deg, dfac, mid, order="degree-major"):
    """Full-degree interior functions plus the trimmed tilde block.

    Two orderings occur in the reference: Sminus.py/SminusCurl.py emit
    (bubble_y, bubble_x) pairs per (j, k) walking j upward
    ('degree-major'); SminusDiv.py walks the same set with the x-bubble
    first and the Legendre arguments swapped ('div')."""
    dx, dy = dfac
    mx, my = mid
    bx = dx[0] * dx[1]
    by = dy[0] * dy[1]
    out = []
    for i in range(2, deg):
        t = i - 2
        for j in range(t + 1):
            k = t - j
            if order == "degree-major":
                out += [(leg(j, mx) * leg(k, my) * by, 0),
                        (0, leg(j, mx) * leg(k, my) * bx)]
            else:
                out += [(0, leg(j, mx) * leg(k, my) * bx),
                        (leg(k, mx) * leg(j, my) * by, 0)]
    return out + interior_tilde_2d(deg, dfac, mid)


def _entity_ids_2d(flat_el, deg, nbf):
    top = flat_el.get_topology()
    ids = {d: {e: [] for e in ents} for d, ents in top.items()}
    cur = 0
    for j in sorted(top[1]):
        ids[1][j] = list(range(cur, cur + deg))
        cur += deg
    ids[2][0] = list(range(cur, nbf))
    return ids


# ---------------------------------------------------------------- 3-D ---

_AXES_3D = ((0, 1, 2), (1, 0, 2), (2, 0, 1))  # (normal/along, b, c)


def edge_funcs_3d(deg, dfac, mid):
    """Edge functions on the 12 hex edges: along-axis component carrying
    Legendre moments, ordered z-edges, y-edges, x-edges with the second
    transverse axis fastest (Sminus.py:243-281, SminusCurl.py:198-236)."""
    out = []
    for a, b, c in ((2, 0, 1), (1, 0, 2), (0, 1, 2)):
        for beta in (0, 1):
            for gamma in (0, 1):
                for j in range(deg):
                    vec = [0, 0, 0]
                    vec[a] = leg(j, mid[a]) * dfac[b][beta] * dfac[c][gamma]
                    out.append(tuple(vec))
    return out


def face_funcs_3d_curl(deg, dfac, mid, trimmed):
    """Face functions of the curl-conforming families: per face (normal
    axis a, tangents b < c), a tilde block then full-degree pairs.
    ``trimmed=True`` keeps only the top-degree pairs with the
    reference's per-face argument quirks (Sminus.py:284-356);
    ``trimmed=False`` is the full tower (SminusCurl.py:239-307)."""
    out = []
    for a, b, c in _AXES_3D:
        bub_b = dfac[b][0] * dfac[b][1]
        bub_c = dfac[c][0] * dfac[c][1]
        for s in (0, 1):
            da = dfac[a][s]
            # tilde block
            vec = [0, 0, 0]
            vec[b] = leg(deg - 2, mid[c]) * da * bub_c
            out.append(tuple(vec))
            vec = [0, 0, 0]
            vec[c] = leg(deg - 2, mid[b]) * da * bub_b
            out.append(tuple(vec))
            for j in range(1, deg - 1):
                vec = [0, 0, 0]
                vec[b] = leg(j, mid[b]) * leg(deg - j - 2, mid[c]) * da * bub_c
                vec[c] = -leg(j - 1, mid[b]) * leg(deg - j - 1, mid[c]) \
                    * da * bub_b
                out.append(tuple(vec))
            if trimmed:
                # top-degree pairs only; the reference's second entry
                # uses leg(k, mid_a) on x/y faces but leg(k, mid_b) on
                # z faces -- replicated verbatim (Sminus.py:293-331)
                second_arg = mid[a] if a in (0, 1) else mid[b]
                for j in range(1, deg - 1):
                    k = deg - j - 2
                    vec = [0, 0, 0]
                    vec[b] = leg(j, mid[b]) * leg(k, mid[c]) * da * bub_c
                    out.append(tuple(vec))
                    vec = [0, 0, 0]
                    vec[c] = leg(j, mid[c]) * leg(k, second_arg) * da * bub_b
                    out.append(tuple(vec))
            else:
                for i in range(2, deg):
                    for j in range(i - 1):
                        k = i - 2 - j
                        vec = [0, 0, 0]
                        vec[b] = leg(j, mid[b]) * leg(k, mid[c]) * da * bub_c
                        out.append(tuple(vec))
                        vec = [0, 0, 0]
                        vec[c] = leg(j, mid[c]) * leg(k, mid[b]) * da * bub_b
                        out.append(tuple(vec))
    return out


def interior_funcs_3d_curl(deg, dfac, mid, trimmed):
    """Interior functions of the curl-conforming families
    (Sminus.py:359-404, SminusCurl.py:310-351)."""
    bub = [dfac[a][0] * dfac[a][1] for a in range(3)]
    mx, my, mz = mid

    def piece(j, k, l):
        f = leg(j, mx) * leg(k, my) * leg(l, mz)
        return [(f * bub[1] * bub[2], 0, 0),
                (0, f * bub[0] * bub[2], 0),
                (0, 0, f * bub[0] * bub[1])]

    out = []
    if trimmed:
        # Sminus.py I_lambda_1_3d: all (j,k,l) with j+k+l = deg-4,
        # z-bubble entry uses dy-squared (reference quirk, line 384)
        for j in range(0, deg - 3):
            for k in range(0, deg - 3 - j):
                l = deg - 4 - j - k
                if l < 0:
                    continue
                f = leg(j, mx) * leg(k, my) * leg(l, mz)
                out += [(f * bub[1] * bub[2], 0, 0),
                        (0, f * bub[0] * bub[2], 0),
                        (0, 0, f * bub[1] * bub[1])]
        # tilde (Sminus.py:388-404)
        out += [(leg(deg - 4, my) * bub[1] * bub[2], 0, 0),
                (leg(deg - 4, mz) * bub[1] * bub[2], 0, 0),
                (0, leg(deg - 4, mx) * bub[0] * bub[2], 0),
                (0, leg(deg - 4, mz) * bub[0] * bub[2], 0),
                (0, 0, leg(deg - 4, mx) * bub[0] * bub[1]),
                (0, 0, leg(deg - 4, my) * bub[0] * bub[1])]
        for j in range(1, deg - 3):
            out.append((leg(j, mx) * leg(deg - j - 4, my) * bub[1] * bub[2],
                        -leg(j - 1, mx) * leg(deg - j - 3, my)
                        * bub[0] * bub[2], 0))
            out.append((leg(j, mx) * leg(deg - j - 4, mz) * bub[1] * bub[2],
                        0, -leg(j - 1, mx) * leg(deg - j - 3, mz)
                        * bub[0] * bub[1]))
            if deg > 5:
                out.append((0, leg(j, my) * leg(deg - j - 4, mz)
                            * bub[0] * bub[2],
                            -leg(j - 1, my) * leg(deg - j - 3, mz)
                            * bub[0] * bub[1]))
    else:
        # SminusCurl.py I_lambda_1_3d: towers of pieces then tilde
        for i in range(4, deg):
            for j in range(0, i - 3):
                for k in range(0, i - 3 - j):
                    l = i - 4 - j - k
                    out += piece(j, k, l)
        # tilde (SminusCurl.py:321-343)
        if deg == 4:
            out += [(bub[1] * bub[2], 0, 0),
                    (0, bub[0] * bub[2], 0),
                    (0, 0, bub[0] * bub[1])]
        if deg > 4:
            out += [(leg(deg - 4, my) * bub[1] * bub[2], 0, 0),
                    (leg(deg - 4, mz) * bub[1] * bub[2], 0, 0),
                    (0, leg(deg - 4, mx) * bub[0] * bub[2], 0),
                    (0, leg(deg - 4, mz) * bub[0] * bub[2], 0),
                    (0, 0, leg(deg - 4, mx) * bub[0] * bub[1]),
                    (0, 0, leg(deg - 4, my) * bub[0] * bub[1])]
        for j in range(1, deg - 3):
            out.append((leg(j, mx) * leg(deg - j - 4, my) * bub[1] * bub[2],
                        -leg(j - 1, mx) * leg(deg - j - 3, my)
                        * bub[0] * bub[2], 0))
            out.append((leg(j, mx) * leg(deg - j - 4, mz) * bub[1] * bub[2],
                        0, -leg(j - 1, mx) * leg(deg - j - 3, mz)
                        * bub[0] * bub[1]))
            if deg > 5:
                # reference quirk: the third component repeats leg(.., my)
                # and the xz bubble (SminusCurl.py:338) -- verbatim
                out.append((0, leg(j, my) * leg(deg - j - 4, mz)
                            * bub[0] * bub[2],
                            -leg(j - 1, my) * leg(deg - j - 3, my)
                            * bub[0] * bub[2]))
        if deg == 6:
            out += [(leg(1, my) * leg(1, mz) * bub[1] * bub[2], 0, 0),
                    (0, leg(1, mx) * leg(1, mz) * bub[0] * bub[2], 0),
                    (0, 0, leg(1, mx) * leg(1, my) * bub[0] * bub[1])]
    return out


def face_funcs_3d_div(deg, dfac, mid):
    """Face functions of the div-conforming family: normal component
    carrying a 2-D Legendre triangle per face (SminusDiv.py:180-188)."""
    signs = (-1, 1, -1)
    out = []
    for a, b, c in _AXES_3D:
        for s in (0, 1):
            for k in range(deg):
                for j in range(deg - k):
                    vec = [0, 0, 0]
                    vec[a] = signs[a] * leg(j, mid[b]) * leg(k, mid[c]) \
                        * dfac[a][s]
                    out.append(tuple(vec))
    return out


def interior_funcs_3d_div(deg, dfac, mid):
    """Interior functions of the div-conforming family
    (SminusDiv.py:191-230)."""
    bub = [dfac[a][0] * dfac[a][1] for a in range(3)]
    mx, my, mz = mid
    out = []
    for i in range(2, deg):
        for j in range(0, i - 1):
            for k in range(0, i - 1 - j):
                f = leg(j, mx) * leg(k, my) * leg(i - 2 - j - k, mz)
                out += [(0, 0, -f * bub[2]), (0, -f * bub[1], 0),
                        (-f * bub[0], 0, 0)]
    # tilde
    out += [(0, 0, leg(deg - 2, mz) * bub[2]),
            (0, leg(deg - 2, my) * bub[1], 0),
            (leg(deg - 2, mx) * bub[0], 0, 0)]
    out += [(leg(deg - j - 2, mx) * leg(j, my) * bub[0],
             leg(deg - j - 1, mx) * leg(j - 1, my) * bub[1], 0)
            for j in range(1, deg - 1)]
    out += [(leg(deg - j - 2, mx) * leg(j, mz) * bub[0], 0,
             leg(deg - j - 1, mx) * leg(j - 1, mz) * bub[2])
            for j in range(1, deg - 1)]
    out += [(0, leg(deg - j - 2, my) * leg(j, mz) * bub[1],
             leg(deg - j - 1, my) * leg(j - 1, mz) * bub[2])
            for j in range(1, deg - 1)]
    for k in range(1, deg - 2):
        for l in range(1, deg - 1 - k):
            j = deg - 2 - k - l
            out.append((-leg(j, mx) * leg(k, my) * leg(l, mz) * bub[0],
                        leg(j + 1, mx) * leg(k - 1, my) * leg(l, mz)
                        * bub[1],
                        -leg(j + 1, mx) * leg(k, my) * leg(l - 1, mz)
                        * bub[2]))
    return out


def _entity_ids_3d(flat_el, deg, n_edge, n_face, nbf):
    top = flat_el.get_topology()
    ids = {d: {e: [] for e in ents} for d, ents in top.items()}
    cur = 0
    for j in sorted(top[1]):
        ids[1][j] = list(range(cur, cur + n_edge))
        cur += n_edge
    for j in sorted(top[2]):
        ids[2][j] = list(range(cur, cur + n_face))
        cur += n_face
    ids[3][0] = list(range(cur, nbf))
    return ids


def _entity_ids_3d_div(flat_el, deg, n_face, nbf):
    top = flat_el.get_topology()
    ids = {d: {e: [] for e in ents} for d, ents in top.items()}
    cur = 0
    for j in sorted(top[2]):
        ids[2][j] = list(range(cur, cur + n_face))
        cur += n_face
    ids[3][0] = list(range(cur, nbf))
    return ids


# ------------------------------------------------------------ elements ---

def _check_cell(ref_el, degree, dims):
    if degree < 1:
        raise ValueError(
            "Trimmed serendipity elements only valid for degree >= 1")
    flat_el = flatten_reference_cube(ref_el)
    dim = flat_el.get_spatial_dimension()
    if dim not in dims:
        raise ValueError(
            f"Trimmed serendipity element not defined in dimension {dim}")
    return flat_el, dim


class TrimmedSerendipityEdge(SympyVectorElement):
    """S-minus edge (curl-conforming, trimmed interior) element
    (reference: FIAT/Sminus.py TrimmedSerendipityEdge)."""

    def __init__(self, ref_el, degree):
        flat_el, dim = _check_cell(ref_el, degree, (2, 3))
        dfac, mid = cube_geometry(flat_el)
        if dim == 2:
            basis = edge_funcs_2d(degree, dfac, mid)
            if degree >= 2:
                basis += interior_funcs_2d(degree, dfac, mid,
                                           order="degree-major")
            ids = _entity_ids_2d(flat_el, degree, len(basis))
        else:
            basis = edge_funcs_3d(degree, dfac, mid)
            n_face = 0
            if degree >= 2:
                faces = face_funcs_3d_curl(degree, dfac, mid, trimmed=True)
                n_face = len(faces) // 6
                basis += faces
            if degree >= 4:
                basis += interior_funcs_3d_curl(degree, dfac, mid,
                                                trimmed=True)
            ids = _entity_ids_3d(flat_el, degree, degree, n_face,
                                 len(basis))
        super().__init__(ref_el, degree, "covariant piola", 1, basis, ids)


class TrimmedSerendipityFace(SympyVectorElement):
    """S-minus face (div-conforming) element on quads: the 90-degree
    rotation of the edge element (reference: FIAT/Sminus.py
    TrimmedSerendipityFace)."""

    def __init__(self, ref_el, degree):
        flat_el, dim = _check_cell(ref_el, degree, (2,))
        dfac, mid = cube_geometry(flat_el)
        basis = edge_funcs_2d(degree, dfac, mid)
        if degree >= 2:
            basis += interior_funcs_2d(degree, dfac, mid,
                                       order="degree-major")
        basis = _rotate(basis)
        ids = _entity_ids_2d(flat_el, degree, len(basis))
        super().__init__(ref_el, degree, "contravariant piola", 1,
                         basis, ids)


class TrimmedSerendipityDiv(SympyVectorElement):
    """S-minus div-conforming element on quads and hexes (reference:
    FIAT/SminusDiv.py TrimmedSerendipityDiv)."""

    def __init__(self, ref_el, degree):
        flat_el, dim = _check_cell(ref_el, degree, (2, 3))
        dfac, mid = cube_geometry(flat_el)
        if dim == 2:
            basis = edge_funcs_2d(degree, dfac, mid)
            if degree >= 2:
                basis += interior_funcs_2d(degree, dfac, mid, order="div")
            basis = _rotate(basis)
            ids = _entity_ids_2d(flat_el, degree, len(basis))
        else:
            basis = face_funcs_3d_div(degree, dfac, mid)
            if degree >= 2:
                basis += interior_funcs_3d_div(degree, dfac, mid)
            ids = _entity_ids_3d_div(flat_el, degree, tri(degree),
                                     len(basis))
        super().__init__(ref_el, degree, "contravariant piola", dim - 1,
                         basis, ids)


class TrimmedSerendipityCurl(SympyVectorElement):
    """S-minus curl-conforming element on quads and hexes (reference:
    FIAT/SminusCurl.py TrimmedSerendipityCurl)."""

    def __init__(self, ref_el, degree):
        flat_el, dim = _check_cell(ref_el, degree, (2, 3))
        dfac, mid = cube_geometry(flat_el)
        if dim == 2:
            basis = edge_funcs_2d(degree, dfac, mid)
            if degree >= 2:
                basis += interior_funcs_2d(degree, dfac, mid,
                                           order="degree-major")
            ids = _entity_ids_2d(flat_el, degree, len(basis))
        else:
            basis = edge_funcs_3d(degree, dfac, mid)
            n_face = 0
            if degree >= 2:
                faces = face_funcs_3d_curl(degree, dfac, mid,
                                           trimmed=False)
                n_face = len(faces) // 6
                basis += faces
            if degree >= 4:
                basis += interior_funcs_3d_curl(degree, dfac, mid,
                                                trimmed=False)
            ids = _entity_ids_3d(flat_el, degree, degree, n_face,
                                 len(basis))
        super().__init__(ref_el, degree, "covariant piola", 1, basis, ids)
