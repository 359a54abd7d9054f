"""Raviart-Thomas H(div): RT_k = (P_{k-1})^d + x P^H_{k-1}, with
scaled-normal facet dofs and interior vector moments.  Counterpart of
``fiat_tpu/elements/raviart_thomas.py``, on the declarative dual builder; a
split variant builds the element on the split complex
(``MacroPolynomialSet``)."""

from ..core import expansions, finite_element, functionals, polyset
from ..core.dual_builder import DualBuilder
from ..core.macro import MacroPolynomialSet
from ..core.quadrature_schemes import create_quadrature
from ..core.variants import check_format_variant


def RTSpace(ref_el, degree):
    """(P_{k-1})^d extended by x times the top-degree harmonic layer,
    projected onto the degree-k orthonormal expansion by quadrature."""
    sd = ref_el.get_spatial_dimension()
    k = degree - 1
    dims = [expansions.polynomial_dimension(ref_el, d)
            for d in (k - 1, k, k + 1)]

    vec_full = polyset.ONPolynomialSet(ref_el, k + 1, (sd,))
    vec_Pk = vec_full.take([i * dims[2] + j
                            for i in range(sd) for j in range(dims[1])])
    scalar = polyset.ONPolynomialSet(ref_el, k + 1)
    top_layer = scalar.take(list(range(dims[0], dims[1])))

    Q = create_quadrature(ref_el, 2 * (k + 1))
    qpts, qwts = Q.get_points(), Q.get_weights()
    # L2-exact projection of p(x)*x (integrand lies in P_{k+1})
    xp = top_layer.tabulate(qpts)[(0,) * sd][:, None, :] \
        * qpts.T[None, :, :]
    coeffs = (xp * qwts) @ scalar.tabulate(qpts)[(0,) * sd].T
    radial = polyset.PolynomialSet(ref_el, k, k + 1,
                                   vec_full.get_expansion_set(), coeffs)
    return polyset.polynomial_set_union_normalized(vec_Pk, radial)


def rt_moment_duals(b, degree, qdegree, scheme):
    """Facet moments of n-weighted P_{k-1} + interior component
    moments of P_{k-2}."""
    sd = b.sd
    q = degree - 1
    Q_ref, phis = b.facet_basis(sd - 1, q if sd > 1 else 0,
                                qdegree + q, scheme)
    for f in b.entities(sd - 1):
        n = b.ref_el.compute_scaled_normal(f)
        weighted = n[None, :, None] * phis[:, None, :]
        b.tag(sd - 1, f, (functionals.FrobeniusIntegralMoment(
            b.ref_el, b.map_rule(sd - 1, f, Q_ref), phi)
            for phi in weighted))
    if q > 0:
        Q_ref, phis = b.facet_basis(sd, q - 1, qdegree + q - 1, scheme)
        for c in b.entities(sd):
            Q = b.map_rule(sd, c, Q_ref, avg=False)
            b.tag(sd, c, (functionals.IntegralMoment(
                b.ref_el, Q, phi, (d,), (sd,))
                for d in range(sd) for phi in phis))


def rt_point_duals(b, degree):
    """Scaled-normal point evaluations on facets + interior component
    values."""
    sd = b.sd
    for f in b.entities(sd - 1):
        b.tag(sd - 1, f, (functionals.PointScaledNormalEvaluation(
            b.ref_el, f, p)
            for p in b.lattice(sd - 1, f, sd + degree - 1)))
    if degree > 1:
        b.tag(sd, 0, (functionals.ComponentPointEvaluation(
            b.ref_el, d, (sd,), p)
            for d in range(sd)
            for p in b.lattice(sd, 0, sd + degree - 1)))


class RaviartThomas(finite_element.CiarletElement):
    """The Raviart-Thomas element (contravariant Piola)."""

    def __init__(self, ref_el, degree, variant=None, quad_scheme=None):
        splitting, variant, qdegree = check_format_variant(variant, degree)
        if splitting is not None:
            ref_el = splitting(ref_el)
        if ref_el.is_macrocell():
            poly_set = MacroPolynomialSet(ref_el, type(self)(ref_el.get_parent(), degree))
        else:
            poly_set = RTSpace(ref_el, degree)
        b = DualBuilder(ref_el)
        if variant == "integral":
            rt_moment_duals(b, degree, qdegree, quad_scheme)
        else:
            rt_point_duals(b, degree)
        super().__init__(poly_set, b.dual_set(), degree,
                         ref_el.get_spatial_dimension() - 1,
                         mapping="contravariant piola")
