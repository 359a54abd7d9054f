"""Polynomial sets: spaces as coefficient tensors over an expansion basis.

Counterpart of ``fiat_tpu/core/polyset.py`` (the parts the ``full_zoo``
elements use).  A set is ``coeffs[i, (shape...), k]`` against expansion
member k; tabulation is one dense contraction ``coeffs . base_vals``.
Vector sets (``shape=``), symmetric and traceless matrix-valued sets,
unions re-orthonormalised by SVD, null-space bases (the C^k macro spaces)
and bubbles are here.
"""

from itertools import chain

import numpy as np

from . import expansions
from .expansions import mis  # noqa: F401  (re-export, fiat_tpu's API location)


class PolynomialSet:
    """Members span(coeffs @ expansion) of degree ``degree`` embedded in the
    expansion set of ``embedded_degree``."""

    def __init__(self, ref_el, degree, embedded_degree, expansion_set, coeffs):
        vars(self).update(ref_el=ref_el, degree=degree,
                          embedded_degree=embedded_degree,
                          expansion_set=expansion_set, coeffs=coeffs,
                          num_members=coeffs.shape[0])

    def tabulate(self, pts, jet_order=0):
        """dict alpha -> D^alpha of every member at pts."""
        jets = self.expansion_set._tabulate(self.embedded_degree, pts,
                                            order=jet_order)
        return {alpha: np.dot(self.coeffs, tab)
                for alpha, tab in jets.items()}

    def get_shape(self):
        """Value shape of members: () scalar, (d,) vector, etc."""
        return self.coeffs.shape[1:-1]

    def get_dmats(self, cell=0):
        return self.expansion_set.get_dmats(self.embedded_degree, cell=cell)

    def take(self, items):
        sliced = self.coeffs[np.asarray(items, dtype=int)]
        return PolynomialSet(self.ref_el, self.degree,
                             self.embedded_degree, self.expansion_set,
                             sliced)

    def __len__(self):
        return self.num_members


def _simple_getter(attr):
    get = lambda self: getattr(self, attr)  # noqa: E731
    get.__name__ = "get_" + attr
    return get


for _attr, _name in (("expansion_set", None), ("coeffs", None),
                     ("num_members", None), ("degree", None),
                     ("embedded_degree", None),
                     ("ref_el", "get_reference_element")):
    setattr(PolynomialSet, _name or f"get_{_attr}", _simple_getter(_attr))


def _pattern_coeffs(patterns, num_exp):
    """One member per (pattern, expansion member): coefficient tensor
    pattern ⊗ e_k, shape (npat*num_exp, *pattern_shape, num_exp) with the
    expansion index fastest."""
    pats = np.asarray(patterns, dtype=float)
    kron = np.multiply.outer(pats, np.eye(num_exp))
    # (npat, shape..., m, k) -> (npat, m, shape..., k)
    kron = np.moveaxis(kron, -2, 1)
    return kron.reshape(pats.shape[0] * num_exp, *pats.shape[1:], num_exp)


def _component_identity_coeffs(shape, num_exp):
    """Coefficients giving one copy of the expansion basis per component."""
    if shape == ():
        return np.eye(num_exp)
    ncomp = int(np.prod(shape, dtype=int))
    patterns = np.eye(ncomp).reshape(ncomp, *shape)
    return _pattern_coeffs(patterns, num_exp)


class ONPolynomialSet(PolynomialSet):
    """Orthonormal expansion basis as a set (per component for non-scalar
    shapes)."""

    def __init__(self, ref_el, degree, shape=(), **kwargs):
        es = expansions.ExpansionSet(ref_el, **kwargs)
        coeffs = _component_identity_coeffs(shape, es.get_num_members(degree))
        super().__init__(ref_el, degree, degree, es, coeffs)


class ONSymTensorPolynomialSet(PolynomialSet):
    """Orthonormal basis of symmetric-matrix-valued polynomials."""

    def __init__(self, ref_el, degree, size=None, **kwargs):
        es = expansions.ExpansionSet(ref_el, **kwargs)
        size = size or ref_el.get_spatial_dimension()
        rows, cols = np.triu_indices(size)
        patterns = np.zeros((rows.size, size, size))
        arange = np.arange(rows.size)
        patterns[arange, rows, cols] = 1.0
        patterns[arange, cols, rows] = 1.0
        coeffs = _pattern_coeffs(patterns, es.get_num_members(degree))
        super().__init__(ref_el, degree, degree, es, coeffs)


class TracelessTensorPolynomialSet(PolynomialSet):
    """Orthonormal basis of traceless-matrix-valued polynomials."""

    def __init__(self, ref_el, degree, size=None, **kwargs):
        es = expansions.ExpansionSet(ref_el, **kwargs)
        size = size or ref_el.get_spatial_dimension()
        # E_ij for every component but the last diagonal entry, which
        # absorbs -trace so every pattern is traceless
        npat = size * size - 1
        patterns = np.eye(size * size)[:npat].reshape(npat, size, size)
        patterns[:, -1, -1] = -np.trace(patterns, axis1=1, axis2=2)
        coeffs = _pattern_coeffs(patterns, es.get_num_members(degree))
        super().__init__(ref_el, degree, degree, es, coeffs)


def project(f, U, Q):
    """Expansion coefficients of f against the members of U by quadrature Q."""
    pts = Q.get_points()
    weighted = Q.get_weights() * np.asarray([f(x) for x in pts])
    zeroth = (0,) * U.get_reference_element().get_spatial_dimension()
    members = U.tabulate(pts)[zeroth]
    return members.reshape(len(members), -1) @ weighted.ravel()


def form_matrix_product(mats, alpha):
    """prod_i mats[i]^alpha[i] (for dmats chains)."""
    out = np.eye(mats[0].shape[0])
    for mat, power in zip(mats, alpha):
        out = np.linalg.matrix_power(mat, power) @ out
    return out


def spanning_basis(A, nullspace=False, rtol=1e-10):
    """Row-space (or nullspace) orthonormal basis of A by SVD.

    Nullspace bases get two extended-precision refinement steps, as in
    fiat_tpu: the f64 SVD leaves each nullspace vector with a leaked
    row-space component ~eps * sigma_max / sigma_rank, which the longdouble
    residual A v and the f64 pseudoinverse project out."""
    flat = A.reshape(len(A), -1)
    U, sig, vt = np.linalg.svd(flat, full_matrices=True)
    rank = int(np.count_nonzero(np.abs(sig) > rtol * (sig[0] + 1)))
    rows = vt[rank:] if nullspace else vt[:rank]
    if nullspace and rank and len(rows):
        Al = flat.astype(np.longdouble)
        pinv = ((vt[:rank].T / sig[:rank])
                @ U[:, :rank].T).astype(np.longdouble)
        for _ in range(2):
            R = Al @ rows.astype(np.longdouble).T
            rows = rows - np.asarray(pinv @ R, np.float64).T
        q, _ = np.linalg.qr(rows.T)      # re-orthonormalise (near-ON)
        rows = q.T
    return rows.reshape(-1, *A.shape[1:])


def construct_new_coeffs(ref_el, A, B):
    """Stack coefficients of A and B over a common embedded degree
    (zero-padding the smaller, exploiting that lower-degree Dubiner bases
    prefix higher-degree ones)."""
    if A.get_expansion_set().continuity != B.get_expansion_set().continuity:
        raise ValueError("Continuity of expansion sets does not match.")
    da, db = A.get_embedded_degree(), B.get_embedded_degree()
    if da == db:
        return np.concatenate((A.coeffs, B.coeffs), axis=0)
    if A.get_expansion_set().continuity is not None:
        raise NotImplementedError(
            "Union with continuity and mismatched degrees is not supported")
    hi, lo = (A, B) if da > db else (B, A)
    grown = np.zeros(lo.coeffs.shape[:-1] + hi.coeffs.shape[-1:])
    grown[..., :lo.coeffs.shape[-1]] = lo.coeffs
    return np.concatenate((grown, hi.coeffs), axis=0)


def polynomial_set_union_normalized(A, B):
    """A set spanning span(A) + span(B), re-orthonormalised by SVD."""
    cell = A.get_reference_element()
    assert cell == B.get_reference_element()
    stacked = construct_new_coeffs(cell, A, B)
    return PolynomialSet(cell,
                         max(A.get_degree(), B.get_degree()),
                         max(A.get_embedded_degree(),
                             B.get_embedded_degree()),
                         A.get_expansion_set(),
                         spanning_basis(stacked))


def make_bubbles(ref_el, degree, codim=0, shape=(), scale="L2 piola"):
    """Bubbles (C0 members vanishing on dimension sd-codim entity
    boundaries) up to ``degree``."""
    poly_set = ONPolynomialSet(ref_el, degree, shape=shape, scale=scale,
                               variant="bubble")
    sd = ref_el.get_spatial_dimension()
    if sd == 0:
        return poly_set
    entity_ids = expansions.polynomial_entity_ids(ref_el, degree,
                                                  continuity="C0")
    interior = np.asarray(list(
        chain(*entity_ids[sd - codim].values())), dtype=int)
    ncomp = int(np.prod(shape, dtype=int))
    if ncomp > 1:
        # per-component copies sit dimPk apart in the flat member index
        stride = len(poly_set) // ncomp
        interior = (interior[:, None] + stride * np.arange(ncomp)).ravel()
    return poly_set.take(interior)
