"""Guzman-Neilan macroelements: the (extended) Bernardi-Raugel space
projected into C0 Pk(Alfeld)^d with P_{k-1} divergence -- kinds 1/2 plus
the H1(div) enrichment.  Counterpart of
``fiat_tpu/elements/guzman_neilan.py``."""

import math

import numpy as np

from ..core import expansions, finite_element, polyset
from ..core.macro import AlfeldSplit
from ..core.quadrature_schemes import create_quadrature
from .alfeld_sorokina import AlfeldSorokina
from .bernardi_raugel import (BernardiRaugel, BernardiRaugelDualSet,
                              BernardiRaugelSpace)
from .brezzi_douglas_marini import BrezziDouglasMarini
from .nodal_enriched import NodalEnrichedElement
from .restricted import RestrictedElement


def _dot(u, v, w):
    """Weighted inner products of two tabulations over all value axes."""
    return np.tensordot(u * w, v, axes=(range(1, u.ndim), range(1, v.ndim)))


def _divergence(tables):
    """Divergence from an order-1 tabulation dict."""
    return sum(tables[a][:, a.index(1), :] for a in tables if sum(a) == 1)


def take_interior_bubbles(P, degree=None):
    """Members of a complete PolynomialSet supported on interior facets
    of the complex (optionally capped at ``degree``)."""
    complex_ = P.get_reference_element()
    ncomp = int(np.prod(P.get_shape()))
    nsc = P.expansion_set.get_num_members(P.degree)
    assert ncomp * nsc == P.get_num_members()
    eids = expansions.polynomial_entity_ids(
        complex_, P.degree, continuity=P.expansion_set.continuity)
    cap = {dim: slice(None) if degree is None or degree >= P.degree
           else slice(math.comb(degree - 1, dim)) for dim in eids}
    keep = [i + j * nsc
            for dim in cap
            for f in sorted(complex_.get_interior_facets(dim))
            for i in eids[dim][f][cap[dim]]
            for j in range(ncomp)]
    return P.take(keep)


def modified_bubble_subspace(B):
    """M_k(K^r) of Guzman-Neilan 2019: hat^(k-j) * BDM_j facet functions
    projected onto the interior bubbles (3D path)."""
    complex_ = B.get_reference_element()
    sd = complex_.get_spatial_dimension()
    k = B.degree
    rule = create_quadrature(complex_, 2 * k)
    qpts, qwts = rule.get_points(), rule.get_weights()
    hat = B.take([0]).tabulate(qpts)[(0,) * sd][0, 0]

    parent = complex_.get_parent()
    targets = [np.eye(sd)[:, :, None] * hat[None, None, :] ** k]
    for j in range(1, k):
        bdm = BrezziDouglasMarini(parent, j)
        facet_part = bdm.get_nodal_basis().take(
            bdm.dual.get_indices("facet"))
        targets.append(facet_part.tabulate(qpts)[(0,) * sd]
                       * hat ** (k - j))
    targets = np.concatenate(targets, axis=0)

    v = B.tabulate(qpts)[(0,) * sd]
    proj = np.linalg.solve(_dot(v, v, qwts), _dot(v, targets, qwts))
    return polyset.PolynomialSet(
        complex_, k, k, B.get_expansion_set(),
        np.tensordot(proj, B.get_coeffs(), axes=(0, 0)))


def constant_div_projection(BR, C0, M, num_bubbles):
    """Correct the BR bubbles by members of M so the projected space has
    divergence in P_{k-1} (constant on each subcell for k=1)."""
    complex_ = C0.get_reference_element()
    sd = complex_.get_spatial_dimension()
    k = C0.degree
    rule = create_quadrature(complex_, 2 * k)
    qpts, qwts = rule.get_points(), rule.get_weights()

    # mean-free non-constant test functions for the divergence residual
    tests = polyset.ONPolynomialSet(complex_, k - 1)
    tests = tests.take(list(range(1, tests.get_num_members())))
    T = tests.tabulate(qpts)[(0,) * sd]
    T = T - np.dot(T, qwts)[:, None] / sum(qwts)

    U = M.tabulate(qpts, 1)
    X = BR.tabulate(qpts, 1)
    fix = np.linalg.solve(_dot(T, _divergence(U), qwts),
                          _dot(T, _divergence(X)[-num_bubbles:], qwts))

    v = C0.tabulate(qpts)[(0,) * sd]
    coeffs = np.linalg.solve(_dot(v, v, qwts),
                             _dot(v, X[(0,) * sd], qwts))
    coeffs = coeffs.T.reshape(BR.get_num_members(), sd, -1)
    coeffs[-num_bubbles:] -= np.tensordot(fix, M.get_coeffs(), axes=(0, 0))
    return polyset.PolynomialSet(complex_, k, k, C0.get_expansion_set(),
                                 coeffs)


def GuzmanNeilanSpace(ref_el, order, kind=1, reduced=False):
    """Basis for the (extended) Guzman-Neilan H1 space."""
    sd = ref_el.get_spatial_dimension()
    complex_ = AlfeldSplit(ref_el)
    C0 = polyset.ONPolynomialSet(complex_, sd, shape=(sd,), scale=1,
                                 variant="bubble")
    B = take_interior_bubbles(C0)
    if sd > 2:
        B = modified_bubble_subspace(B)

    K = complex_ if kind == 2 else ref_el
    num_bubbles = sd + 1
    if reduced:
        BR = BernardiRaugel(K, order, hierarchical=True).get_nodal_basis()
        BR = BR.take(list(range(
            BR.get_num_members() - (sd - 1) * (sd + 1))))
    else:
        num_bubbles *= sd
        BR = BernardiRaugelSpace(K, order)
    return constant_div_projection(BR, C0, B, num_bubbles)


class GuzmanNeilanH1(finite_element.CiarletElement):
    """The Guzman-Neilan H1-conforming (extended) macroelement."""

    def __init__(self, ref_el, order=1, kind=1, quad_scheme=None):
        sd = ref_el.get_spatial_dimension()
        if order >= sd:
            raise ValueError("GuzmanNeilan is only defined for order < dim")
        poly_set = GuzmanNeilanSpace(ref_el, order, kind=kind)
        K = poly_set.get_reference_element() if kind == 2 else ref_el
        dual = BernardiRaugelDualSet(K, order, degree=sd,
                                     quad_scheme=quad_scheme)
        super().__init__(poly_set, dual, sd, sd - 1,
                         mapping="contravariant piola")


class GuzmanNeilanFirstKindH1(GuzmanNeilanH1):
    """GN of the first kind: Pk^d + GN bubbles (paired with unsplit DG)."""

    def __init__(self, ref_el, order=1, quad_scheme=None):
        super().__init__(ref_el, order=order, kind=1,
                         quad_scheme=quad_scheme)


class GuzmanNeilanSecondKindH1(GuzmanNeilanH1):
    """GN of the second kind: C0 Pk(Alfeld)^d + GN bubbles."""

    def __init__(self, ref_el, order=1, quad_scheme=None):
        super().__init__(ref_el, order=order, kind=2,
                         quad_scheme=quad_scheme)


def GuzmanNeilanH1div(ref_el, degree=2, reduced=False, quad_scheme=None):
    """GN H1(div): Alfeld-Sorokina enriched with GN bubbles."""
    order = 0
    AS = AlfeldSorokina(ref_el, 2)
    if reduced or ref_el.get_spatial_dimension() <= 2:
        order = 1
        div_nodes = [i for i, node in enumerate(AS.dual_basis())
                     if len(node.deriv_dict) > 0]
        AS = RestrictedElement(AS, indices=div_nodes)
    GN = GuzmanNeilanH1(ref_el, order=order, quad_scheme=quad_scheme)
    return NodalEnrichedElement(AS, GN)
