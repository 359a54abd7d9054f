"""Finite element bases.

Counterpart of ``fiat_tpu/core/finite_element.py``.  The nodal solve
(``nodal_coefficients``) LU-factorises the generalized Vandermonde matrix
once, guards ill-conditioning with a LAPACK reciprocal-condition estimate,
and refines ill-conditioned solves with longdouble residuals.
``entity_support_dofs`` integrates |phi|^2 over every entity of a
dimension in one stacked tabulation and one einsum.  All of it is
host-side float64 numpy/scipy; the coefficient tensors are the static
data of the device engine (``fiat_tpu_torch.ops.tabulate``).
"""

import numpy as np
from scipy.linalg import get_lapack_funcs, lu_factor, lu_solve

from .polyset import PolynomialSet
from .quadrature_schemes import create_quadrature


def nodal_coefficients(poly_set, dual):
    """Coefficients of the nodal basis: invert ell_i(phi_j) = delta_ij.

    Builds V[i, j] = ell_i(b_j) over the prime basis b, LU-factorises it,
    estimates the reciprocal condition number with LAPACK ``gecon``, and
    back-substitutes the prime coefficients.  Returns (new_coeffs, V)."""
    B = poly_set.get_coeffs()
    R = dual.to_riesz(poly_set)
    n = R.shape[0]
    Bf = B.reshape(n, -1)
    V = R.reshape(n, -1) @ Bf.T

    # factorise V and solve the TRANSPOSED system V^T c = B: with LU(V)
    # the nodality product V c^T stays ~eps-accurate even at large
    # condition numbers (LU(V^T) loses ~cond(V)*eps on it)
    lu, piv = lu_factor(V)
    gecon, = get_lapack_funcs(("gecon",), (lu,))
    rcond, _ = gecon(lu, np.linalg.norm(V, 1))
    if rcond < np.finfo(V.dtype).eps:
        raise np.linalg.LinAlgError(f"Singular Vandermonde matrix (rcond={rcond:.1e})")
    X = lu_solve((lu, piv), Bf, trans=1)
    if rcond < 1e-8:
        # extended-precision iterative refinement: at cond(V) ~ 1e8+ the
        # plain solve's forward error ~cond*eps dominates; two longdouble
        # residual corrections bring the coefficients to ~eps
        Vl = V.T.astype(np.longdouble)
        Bl = Bf.astype(np.longdouble)
        for _ in range(2):
            res = np.asarray(Bl - Vl @ X.astype(np.longdouble), dtype=np.float64)
            X += lu_solve((lu, piv), res, trans=1)
    return X.reshape((n,) + B.shape[1:]), V


class FiniteElement:
    """Template for finite element families; non-nodal unless a
    CiarletElement."""

    is_nodal_basis = False

    def __init__(self, ref_el, dual, order, formdegree=None, mapping="affine",
                 ref_complex=None):
        self.ref_el = ref_el
        self.dual = dual
        self.order = order
        self.formdegree = formdegree
        self.ref_complex = ref_complex or ref_el
        self._mapping = mapping

    def get_reference_element(self):
        return self.ref_el

    def get_reference_complex(self):
        return self.ref_complex

    def get_dual_set(self):
        return self.dual

    def get_order(self):
        return self.order

    def get_formdegree(self):
        return self.formdegree

    def dual_basis(self):
        return self.dual.get_nodes()

    def entity_dofs(self):
        return self.dual.get_entity_ids()

    def entity_closure_dofs(self):
        return self.dual.get_entity_closure_ids()

    def entity_permutations(self):
        return self.dual.get_entity_permutations()

    def mapping(self):
        """Pullback type per basis function."""
        return [self._mapping] * self.space_dimension()

    def space_dimension(self):
        return len(self.dual)

    def num_sub_elements(self):
        return 1

    def is_macroelement(self):
        return self.ref_el is not self.ref_complex

    @classmethod
    def is_nodal(cls):
        return cls.is_nodal_basis

    def tabulate(self, order, points, entity=None):
        raise NotImplementedError(
            f"tabulate is defined by the subclasses of {type(self).__name__}")


class CiarletElement(FiniteElement):
    """A nodal element: (cell, polynomial set, dual set), nodal basis by
    the generalized Vandermonde solve in ``nodal_coefficients``."""

    is_nodal_basis = True

    def __init__(self, poly_set, dual, order, formdegree=None, mapping="affine",
                 ref_complex=None):
        ref_el = dual.get_reference_element()
        ref_complex = ref_complex or poly_set.get_reference_element()
        super().__init__(ref_el, dual, order, formdegree, mapping, ref_complex)
        if len(poly_set) != len(dual):
            raise ValueError(f"Dimension of function space is {len(poly_set)}, "
                             f"but got {len(dual)} nodes.")
        coeffs, self.V = nodal_coefficients(poly_set, dual)
        self.poly_set = PolynomialSet(poly_set.get_reference_element(),
                                      poly_set.get_degree(),
                                      poly_set.get_embedded_degree(),
                                      poly_set.get_expansion_set(), coeffs)

    def degree(self):
        """Degree of the embedding polynomial space."""
        return self.poly_set.get_embedded_degree()

    def get_nodal_basis(self):
        return self.poly_set

    def get_coeffs(self):
        return self.poly_set.get_coeffs()

    def value_shape(self):
        return self.poly_set.get_shape()

    def dmats(self):
        return self.poly_set.get_dmats()

    def get_num_members(self, arg):
        return self.poly_set.get_expansion_set().get_num_members(arg)

    def tabulate(self, order, points, entity=None):
        """dict alpha -> D^alpha tabulation (num_bfs[, components], npts) at
        ``points`` (optionally given on a subentity)."""
        if entity is None:
            entity = (self.ref_el.get_spatial_dimension(), 0)
        transform = self.ref_el.get_entity_transform(*entity)
        return self.poly_set.tabulate(transform(points), order)


def entity_support_dofs(elem, entity_dim):
    """{entity id: dofs whose basis functions are nonzero on the entity}.

    The reference-entity rule is pushed onto every entity of the
    dimension, the element is tabulated once at the stacked points, and
    the (entity, dof) L2 masses come out of one einsum; cached on the
    element."""
    cache = elem.__dict__.setdefault("_entity_support_dofs", {})
    try:
        return cache[entity_dim]
    except KeyError:
        pass
    ref_el = elem.get_reference_element()
    sd = ref_el.get_spatial_dimension()
    quad = create_quadrature(ref_el.construct_subelement(entity_dim), max(2 * elem.degree(), 1))
    qpts, qwts = quad.get_points(), quad.get_weights()
    entities = sorted(elem.entity_dofs()[entity_dim])
    stacked = np.concatenate([ref_el.get_entity_transform(entity_dim, e)(qpts) for e in entities])
    vals = np.asarray(elem.tabulate(0, stacked)[(0,) * sd])
    # (ndof[, comps...], nent, nq) -> mass (nent, ndof): contract comps + q
    blocks = vals.reshape(vals.shape[:-1] + (len(entities), len(qwts)))
    sq = (blocks * blocks).sum(axis=tuple(range(1, blocks.ndim - 2)))
    masses = np.einsum("deq,q->ed", sq, qwts)
    result = {e: np.flatnonzero(masses[k] > 1e-8).tolist() for k, e in enumerate(entities)}
    cache[entity_dim] = result
    return result
