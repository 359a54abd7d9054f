"""First-kind Nedelec H(curl): N1_k = (P_{k-1})^d + S_k, with edge tangent,
face tangential, and interior moments.  Counterpart of
``fiat_tpu/elements/nedelec.py``, on the declarative dual builder; a split
variant builds the element on the split complex (``MacroPolynomialSet``)."""

import numpy as np

from ..core import expansions, finite_element, functionals, polyset
from ..core.dual_builder import DualBuilder
from ..core.macro import MacroPolynomialSet
from ..core.quadrature_schemes import create_quadrature
from ..core.variants import check_format_variant


def _graded_vector_slice(vec_set, sd, lo, hi):
    """Members lo..hi of each Cartesian component of a vector ON set."""
    width = vec_set.get_num_members() // sd
    return vec_set.take([i * width + j
                        for i in range(sd) for j in range(lo, hi)])


def _radial_extension(ref_el, seed_tab, qpts, qwts, scalar, vec_es, k):
    """Project the seed tabulation (already multiplied by the radial /
    rotational factor) onto the degree-(k+1) vector expansion."""
    coeffs = (seed_tab * qwts) @ scalar.tabulate(qpts)[
        (0,) * ref_el.get_spatial_dimension()].T
    return polyset.PolynomialSet(ref_el, k + 1, k + 1, vec_es, coeffs)


def NedelecSpace2D(ref_el, degree):
    """(P_{k-1})^2 + P^H_{k-1} rot(x)."""
    sd = ref_el.get_spatial_dimension()
    if sd != 2:
        raise ValueError("NedelecSpace2D requires a 2d reference element")
    k = degree - 1
    dims = [expansions.polynomial_dimension(ref_el, d)
            for d in (k - 1, k, k + 1)]
    vec_full = polyset.ONPolynomialSet(ref_el, k + 1, (sd,))
    vec_Pk = _graded_vector_slice(vec_full, sd, 0, dims[1])
    scalar = polyset.ONPolynomialSet(ref_el, k + 1)
    top_layer = scalar.take(list(range(dims[0], dims[1])))

    Q = create_quadrature(ref_el, 2 * (k + 1))
    qpts, qwts = Q.get_points(), Q.get_weights()
    rot_x = np.stack([qpts[:, 1], -qpts[:, 0]])
    seed = top_layer.tabulate(qpts)[(0,) * sd][:, None, :] \
        * rot_x[None, :, :]
    rotational = _radial_extension(ref_el, seed, qpts, qwts, scalar,
                                   vec_full.get_expansion_set(), k)
    return polyset.polynomial_set_union_normalized(vec_Pk, rotational)


def NedelecSpace3D(ref_el, degree):
    """(P_{k-1})^3 + (top-layer P_k)^3 x x (cross product)."""
    sd = ref_el.get_spatial_dimension()
    if sd != 3:
        raise ValueError("NedelecSpace3D requires a 3d reference element")
    k = degree - 1
    dims = [expansions.polynomial_dimension(ref_el, d)
            for d in (k - 1, k, k + 1)]
    vec_full = polyset.ONPolynomialSet(ref_el, k + 1, (sd,))
    vec_Pk = _graded_vector_slice(vec_full, sd, 0, dims[1])
    vec_top = _graded_vector_slice(vec_full, sd, dims[0], dims[1])
    scalar = polyset.ONPolynomialSet(ref_el, k + 1)

    Q = create_quadrature(ref_el, 2 * (k + 1))
    qpts, qwts = Q.get_points(), Q.get_weights()
    seed = np.cross(vec_top.tabulate(qpts)[(0,) * sd],
                    qpts.T[None, :, :], axis=1)
    crossed = _radial_extension(ref_el, seed, qpts, qwts, scalar,
                                vec_full.get_expansion_set(), k)
    return polyset.polynomial_set_union_normalized(vec_Pk, crossed)


def nedelec_moment_duals(b, degree, qdegree, scheme):
    """Tangential vector moments on edges/faces."""
    for dim in range(1, b.sd):
        q = degree - dim
        if q < 0:
            continue
        Q_ref, phis = b.facet_basis(dim, q, qdegree + q, scheme,
                                    shape=(dim,))
        phis = np.transpose(phis, (0, 2, 1))
        for e in b.entities(dim):
            Q = b.map_rule(dim, e, Q_ref)
            tangents = np.asarray(b.ref_el.compute_tangents(dim, e))
            pulled = np.transpose(phis @ tangents, (0, 2, 1))
            b.tag(dim, e, (functionals.FrobeniusIntegralMoment(
                b.ref_el, Q, phi) for phi in pulled))


def nedelec_point_duals(b, degree):
    """Tangential point evaluations on edges (and faces in 3D)."""
    for e in b.entities(1):
        b.tag(1, e, (functionals.PointEdgeTangentEvaluation(
            b.ref_el, e, p) for p in b.lattice(1, e, degree + 1)))
    if b.sd > 2 and degree > 1:
        for f in b.entities(2):
            b.tag(2, f, (functionals.PointFaceTangentEvaluation(
                b.ref_el, f, k, p)
                for k in range(2) for p in b.lattice(2, f, degree + 1)))


def nedelec_interior_duals(b, degree, qdegree, scheme):
    """Componentwise interior moments of P_{k-d}."""
    q = degree - b.sd
    if q < 0:
        return
    Q_ref, phis = b.facet_basis(b.sd, q, qdegree + q, scheme)
    for c in b.entities(b.sd):
        Q = b.map_rule(b.sd, c, Q_ref, avg=False)
        b.tag(b.sd, c, (functionals.IntegralMoment(
            b.ref_el, Q, phi, (d,), (b.sd,))
            for d in range(b.sd) for phi in phis))


class Nedelec(finite_element.CiarletElement):
    """First-kind Nedelec element (covariant Piola)."""

    def __init__(self, ref_el, degree, variant=None, quad_scheme=None):
        splitting, variant, qdegree = check_format_variant(variant, degree)
        if splitting is not None:
            ref_el = splitting(ref_el)
        sd = ref_el.get_spatial_dimension()
        if ref_el.is_macrocell():
            poly_set = MacroPolynomialSet(ref_el, type(self)(ref_el.get_parent(), degree))
        elif sd == 3:
            poly_set = NedelecSpace3D(ref_el, degree)
        elif sd == 2:
            poly_set = NedelecSpace2D(ref_el, degree)
        else:
            raise ValueError("Nedelec is only defined in 2D and 3D")

        b = DualBuilder(ref_el)
        if variant == "integral":
            nedelec_moment_duals(b, degree, qdegree, quad_scheme)
        else:
            nedelec_point_duals(b, degree)
        nedelec_interior_duals(b, degree,
                               degree if qdegree is None else qdegree,
                               quad_scheme)
        super().__init__(poly_set, b.dual_set(), degree, 1,
                         mapping="covariant piola")
