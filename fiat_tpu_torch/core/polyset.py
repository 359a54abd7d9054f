"""Polynomial sets: spaces as coefficient tensors over an expansion basis.

Counterpart of ``fiat_tpu/core/polyset.py`` (the part the nodal elements
use).  A set is ``coeffs[i, (shape...), k]`` against expansion member k;
tabulation is one dense contraction ``coeffs . base_vals``.
"""

import numpy as np

from . import expansions
from .expansions import mis  # noqa: F401  (re-export, reference API location)


class PolynomialSet:
    """Members span(coeffs @ expansion) of degree ``degree`` embedded in the
    expansion set of ``embedded_degree``."""

    def __init__(self, ref_el, degree, embedded_degree, expansion_set, coeffs):
        self.ref_el = ref_el
        self.degree = degree
        self.embedded_degree = embedded_degree
        self.expansion_set = expansion_set
        self.coeffs = coeffs
        self.num_members = coeffs.shape[0]

    def tabulate(self, pts, jet_order=0):
        """dict alpha -> D^alpha of every member at pts."""
        jets = self.expansion_set._tabulate(self.embedded_degree, pts, order=jet_order)
        return {alpha: np.dot(self.coeffs, tab) for alpha, tab in jets.items()}

    def get_shape(self):
        """Value shape of members: () scalar, (d,) vector, etc."""
        return self.coeffs.shape[1:-1]

    def get_dmats(self, cell=0):
        return self.expansion_set.get_dmats(self.embedded_degree, cell=cell)

    def __len__(self):
        return self.num_members

    def get_expansion_set(self):
        return self.expansion_set

    def get_coeffs(self):
        return self.coeffs

    def get_num_members(self):
        return self.num_members

    def get_degree(self):
        return self.degree

    def get_embedded_degree(self):
        return self.embedded_degree

    def get_reference_element(self):
        return self.ref_el


def _pattern_coeffs(patterns, num_exp):
    """One member per (pattern, expansion member): coefficient tensor
    pattern (x) e_k, shape (npat*num_exp, *pattern_shape, num_exp) with the
    expansion index fastest."""
    pats = np.asarray(patterns, dtype=float)
    kron = np.moveaxis(np.multiply.outer(pats, np.eye(num_exp)), -2, 1)
    return kron.reshape(pats.shape[0] * num_exp, *pats.shape[1:], num_exp)


def _component_identity_coeffs(shape, num_exp):
    """Coefficients giving one copy of the expansion basis per component."""
    if shape == ():
        return np.eye(num_exp)
    ncomp = int(np.prod(shape, dtype=int))
    return _pattern_coeffs(np.eye(ncomp).reshape(ncomp, *shape), num_exp)


class ONPolynomialSet(PolynomialSet):
    """Orthonormal expansion basis as a set (per component for non-scalar
    shapes)."""

    def __init__(self, ref_el, degree, shape=(), **kwargs):
        es = expansions.ExpansionSet(ref_el, **kwargs)
        coeffs = _component_identity_coeffs(shape, es.get_num_members(degree))
        super().__init__(ref_el, degree, degree, es, coeffs)
