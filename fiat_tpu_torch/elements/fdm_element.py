"""FDM elements: 1D bases whose interior shape functions diagonalise the
Laplacian or the biharmonic under the given boundary conditions (the
fast-diagonalisation preconditioner's bases).

Counterpart of ``fiat_tpu/elements/fdm_element.py``.  ``_fdm_basis``
computes the (poly set, quadrature rule, moment-weight table, kept-row
selector) tuple in numpy f64; ``FDMFiniteElement`` turns it into a dual
set on the declarative builder.  Generalised eigenproblems are whitened
by a Cholesky factor of the metric.  The eigenvector signs are part of
the basis: ``_canonical_signs`` fixes them, and the expressions below run
in fiat_tpu's order, since another order of the same algebra can flip
a sign.
"""

import abc

import numpy as np

from ..core import cells as cl
from ..core import finite_element, functionals, quadrature
from ..core.barycentric import LagrangePolynomialSet
from ..core.dual_builder import DualBuilder
from ..core.polyset import ONPolynomialSet
from .p0 import P0


def _canonical_signs(V):
    """Flip each eigenvector so that its largest-magnitude entry is
    positive: LAPACK's sign choice depends on the inputs' bit patterns, a
    fixed convention makes the basis deterministic."""
    lead = np.take_along_axis(V, np.abs(V).argmax(axis=0)[None, :], axis=0)
    return V * np.where(lead < 0, -1.0, 1.0)


def sym_eig(A, B):
    """Solve A v = lam B v (A symmetric, B s.p.d.) by Cholesky whitening;
    the vectors are B-orthonormal with canonical signs."""
    Linv = np.linalg.inv(np.linalg.cholesky(B))
    lam, Y = np.linalg.eigh(Linv @ A @ Linv.T, "U")
    return lam, _canonical_signs(Linv.T @ Y)


def tridiag_eig(A, B):
    """sym_eig for a diagonal A: the diagonal scaling folded in, the
    reciprocal problem solved for B."""
    a = np.sqrt(np.reciprocal(A.diagonal()))
    lam, V = np.linalg.eigh(a * B * a[:, None], "U")
    lam = np.reciprocal(lam)
    V = np.sqrt(lam) * V * a[:, None]
    return lam[::-1], _canonical_signs(V[:, ::-1])


def _vertex_constraints(P, ref_el, bc_order):
    """C[i, j]: the i-th endpoint condition (vertex jets up to
    bc_order - 1) applied to basis function j; empty for a free (broken)
    element."""
    if bc_order == 0:
        return np.empty((0, len(P)))
    jets = P.tabulate(ref_el.get_vertices(), bc_order - 1)
    return np.column_stack(list(jets.values())).T


def _homogenize(C, n):
    """Basis change E with C @ E = [I 0]: the trailing (interior) columns
    satisfy the homogeneous conditions, the leading ones interpolate them."""
    nb = C.shape[0]
    E = np.eye(n)
    if nb:
        # one combined solve (not inv + solve): the eigenvector signs
        # downstream depend on its bit pattern
        E[:nb, nb:] = -C[:, nb:]
        E[:nb, :] = np.linalg.solve(C[:, :nb], E[:nb, :])
    return E


def _fdm_basis(ref_el, degree, bc_order, formdegree, orthogonalize):
    """(poly set, rule, moment table, interior selector, #bc rows).

    The moment table's rows are the FDM dual functions tabulated at the
    rule's points; the selector picks the rows that become moment DoFs."""
    P = ONPolynomialSet(ref_el, degree + formdegree, variant="bubble")
    n = len(P)
    # vertex-first order: the two endpoint-supported functions lead
    P = P.take([*range(2), *range(2, n, 2), *range(3, n, 2)])

    if bc_order == 1 and formdegree == 0:
        rule = quadrature.GaussLobattoLegendreQuadratureLineRule(ref_el, n + 1)
    else:
        rule = quadrature.GaussLegendreQuadratureLineRule(ref_el, n)

    C = _vertex_constraints(P, ref_el, bc_order)
    nb = C.shape[0]
    E = _homogenize(C, n)

    k = max(1, bc_order)
    tab = P.tabulate(rule.get_points(), k)
    wts = rule.get_weights()
    E0 = E.T @ tab[(0,)]
    Ek = E.T @ tab[(k,)]
    B = (E0 * wts) @ E0.T
    A = (Ek * wts) @ Ek.T

    S = np.eye(n)
    lam = np.ones(n)
    if n > nb:
        ii = slice(nb, None)
        solver = tridiag_eig if bc_order == 1 else sym_eig
        lam[ii], Sii = solver(A[ii, ii], B[ii, ii])
        S[ii, ii] = Sii
        S[ii, :nb] = Sii @ (Sii.T @ -B[ii, :nb])

    if orthogonalize:
        Sb = S[:, :nb]
        _, Qbb = sym_eig(Sb.T @ A @ Sb, Sb.T @ B @ Sb)
        S[:, :nb] = Sb @ Qbb

    if formdegree == 0:
        table = S.T @ E0
        keep = slice(None) if orthogonalize else slice(nb, None)
    else:
        keep = slice(formdegree, None)
        if bc_order == 0:
            nonnull = lam > 1e-12
            lam = np.where(nonnull, lam, 1.0)
            keep = nonnull
        table = (S * np.sqrt(np.reciprocal(lam))).T @ Ek
        if bc_order > 0:
            table[:nb] = np.sqrt(1.0 / ref_el.volume())
    return P, rule, table, keep, nb


class FDMFiniteElement(finite_element.CiarletElement):
    """1D element diagonalising a bilinear form with boundary conditions."""

    _orthogonalize = False

    @property
    @abc.abstractmethod
    def _bc_order(self):
        pass

    @property
    @abc.abstractmethod
    def _formdegree(self):
        pass

    def __new__(cls, ref_el, degree):
        if cls._formdegree == 1 and degree == 0:
            return P0(ref_el)
        return super().__new__(cls)

    def __init__(self, ref_el, degree):
        if ref_el.shape != cl.LINE:
            raise ValueError(f"{type(self)} is only defined in one dimension.")
        P, rule, table, keep, nb = _fdm_basis(
            ref_el, degree, self._bc_order, self._formdegree, self._orthogonalize)

        b = DualBuilder(ref_el)
        vertex_jets = (self._formdegree == 0 and self._bc_order > 0
                       and not self._orthogonalize)
        if vertex_jets:
            for v in b.entities(0):
                x, = ref_el.make_points(0, v, 0)
                b.tag(0, v, [functionals.PointEvaluation(ref_el, x)]
                      + [functionals.PointDerivative(ref_el, x, (a,))
                         for a in range(1, self._bc_order)])
        b.tag(1, 0, (functionals.IntegralMoment(ref_el, rule, f) for f in table[keep]))

        if self._formdegree == 0:
            poly_set = P
        else:
            lr = quadrature.GaussLegendreQuadratureLineRule(ref_el, degree + 1)
            poly_set = LagrangePolynomialSet(ref_el, lr.get_points())
        super().__init__(poly_set, b.dual_set(), degree, self._formdegree)


def _fdm_family(name, doc, bc_order, formdegree, orthogonalize=False):
    globals()[name] = type(name, (FDMFiniteElement,), {
        "__doc__": doc, "__module__": __name__, "_bc_order": bc_order,
        "_formdegree": formdegree, "_orthogonalize": orthogonalize})


_fdm_family("FDMLagrange",
            "CG with interior functions diagonalising the Laplacian.", 1, 0)
_fdm_family("FDMDiscontinuousLagrange",
            "DG from derivatives of the interior CG FDM functions.", 1, 1)
_fdm_family("FDMQuadrature",
            "CG FDM interior functions with orthogonalised vertex modes.",
            1, 0, orthogonalize=True)
_fdm_family("FDMBrokenH1",
            "DG functions diagonalising the Laplacian.", 0, 0)
_fdm_family("FDMBrokenL2",
            "Derivatives of the DG FDM functions.", 0, 1)
_fdm_family("FDMHermite",
            "CG with interior functions diagonalising the biharmonic.", 2, 0)
