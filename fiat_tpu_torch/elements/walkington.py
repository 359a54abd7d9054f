"""Walkington: quintic C1 macroelement on the Alfeld-split tetrahedron.
Vertex 2-jets, face normal-derivative averages, barycentre value, plus
trailing constraint functionals (and a nodal-completion side dual) used
by the transformation theory.  Counterpart of
``fiat_tpu/elements/walkington.py``, on the declarative dual builder."""

import numpy as np

from ..core import cells as cl
from ..core import finite_element, polyset
from ..core.dual_builder import DualBuilder
from ..core.expansions import polynomial_dimension
from ..core.functionals import IntegralMomentOfDerivative, PointEvaluation
from ..core.jacobi import eval_jacobi
from ..core.macro import AlfeldSplit, CkPolynomialSet
from ..core.quadrature import QuadratureRule
from ..core.quadrature_schemes import create_quadrature


def cubic_probe(ref_face):
    """A sparse cubic density (supported at a few quadrature points) that
    detects the non-cubic part of a face restriction."""
    k = 3
    sd = ref_face.get_spatial_dimension()
    Q = create_quadrature(ref_face, 2 * k)
    lo = polynomial_dimension(ref_face, k - 1)
    P = polyset.ONPolynomialSet(ref_face, k)

    probe_pts = list(Q.get_points()[:3]) + [Q.get_points()[-1]]
    top_block = P.tabulate(probe_pts)[(0,) * sd][lo:]
    c = np.linalg.solve(top_block.T, [0, 0, 0, 1])
    phi = c @ P.tabulate(Q.get_points())[(0,) * sd][lo:]

    supp = abs(phi) > 1e-12
    return (QuadratureRule(ref_face, Q.get_points()[supp],
                           Q.get_weights()[supp]), phi[supp])


def walkington_duals(b, degree):
    """The 45 nodal dofs + 20 constraint rows; returns the 15-row
    nodal-completion builder alongside."""
    ref_el = b.ref_el
    sd = b.sd
    b.vertex_jets(2)

    ref_face = ref_el.construct_subelement(2)
    Q_face = create_quadrature(ref_face, degree - 1)
    ones = np.ones(Q_face.get_weights().shape)
    for f in b.entities(2):
        Q = b.map_rule(2, f, Q_face)
        b.tag(2, f, [IntegralMomentOfDerivative(
            ref_el, Q, ones, ref_el.compute_normal(f))])

    for c in b.entities(sd):
        x, = b.lattice(sd, c, sd + 1)
        b.tag(sd, c, [PointEvaluation(ref_el, x)])

    # constraint rows: quartic-Legendre edge moments of the face-normal
    # derivative, plus the probe moments of its tangential derivatives
    face_edges = ref_el.get_connectivity()[(2, 1)]
    ref_edge = ref_el.construct_subelement(1)
    Q_edge = create_quadrature(ref_edge, 2 * (degree - 1))
    s = ref_edge.compute_barycentric_coordinates(Q_edge.get_points())
    leg4 = eval_jacobi(0, 0, 4, s[:, 1] - s[:, 0])
    Q_probe, probe = cubic_probe(ref_face)

    completion = DualBuilder(ref_el)
    for f in b.entities(2):
        ts = ref_el.compute_tangents(sd - 1, f)
        nf = -np.cross(*ts)
        nf /= np.linalg.norm(nf)

        rows = []
        for e in sorted(face_edges[f]):
            Qe = b.map_rule(1, e, Q_edge)
            nfe = np.cross(ref_el.compute_edge_tangent(e), nf)
            rows.append(IntegralMomentOfDerivative(
                ref_el, Qe, leg4, nfe / np.linalg.norm(nfe)))
        Qf = b.map_rule(2, f, Q_probe)
        rows += [IntegralMomentOfDerivative(ref_el, Qf, probe, nf, t)
                 for t in ts]
        b.tag(2, f, rows)

        completion.tag(2, f, (IntegralMomentOfDerivative(
            ref_el, Qf, probe, ts[i], ts[j])
            for i in range(2) for j in range(i, 2)))
    return completion


class Walkington(finite_element.CiarletElement):
    """The Walkington C1 quintic macroelement."""

    def __init__(self, ref_el, degree=5):
        if ref_el.get_shape() != cl.TETRAHEDRON:
            raise ValueError("Walkington only defined on tetrahedra")
        if degree != 5:
            raise ValueError("Walkington only defined for degree=5.")
        b = DualBuilder(ref_el)
        completion = walkington_duals(b, degree)
        dual = b.dual_set()
        dual.nodal_completion = completion.dual_set()
        poly_set = CkPolynomialSet(AlfeldSplit(ref_el), degree, order=1,
                                   vorder=4, variant="bubble")
        super().__init__(poly_set, dual, degree)
