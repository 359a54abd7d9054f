"""Nodal enriched element: the direct sum of nodal elements, re-nodalised
against the concatenated dual basis.

Counterpart of ``fiat_tpu/elements/nodal_enriched.py``, in three small
array programs: an expansion-embedding index map (low-degree members into
the host layout), a stacked dual, and a re-expansion (1D nodal
interpolation, or an L2 projection) for mismatched expansion sets.
"""

import math

import numpy as np

from ..core.barycentric import LagrangeLineExpansionSet
from ..core.dualset import DualSet
from ..core.expansions import polynomial_entity_ids
from ..core.finite_element import CiarletElement
from ..core.polyset import PolynomialSet
from ..core.quadrature_schemes import create_quadrature

__all__ = ["NodalEnrichedElement"]


def expansion_embedding(ref_el, degree, host_degree, continuity):
    """Index map of the degree-``degree`` expansion members into the
    degree-``host_degree`` layout on the same cell: per entity of the
    host layout, its first dim_k(degree) members (hierarchical nesting
    of both the C0/bubble and the discontinuous expansions)."""
    layout = polynomial_entity_ids(ref_el, host_degree, continuity)
    if continuity == "C0":
        dims = sorted(layout)
        block = lambda dim: math.comb(degree - 1, dim)  # noqa: E731
    else:
        dims = (ref_el.get_spatial_dimension(),)
        block = lambda dim: math.comb(degree + dim, dim)  # noqa: E731
    return [i for dim in dims
            for e in sorted(layout[dim])
            for i in layout[dim][e][:block(dim)]]


def _stacked_dual(elements, ref_el):
    """One DualSet concatenating every element's nodes, entity ids
    shifted by the running dof offset."""
    offsets = np.cumsum([0] + [e.space_dimension() for e in elements])
    layout = elements[0].entity_dofs()
    entity_ids = {
        dim: {ent: [int(off) + dof
                    for off, el in zip(offsets, elements)
                    for dof in el.entity_dofs()[dim][ent]]
              for ent in layout[dim]}
        for dim in layout}
    nodes = [node for e in elements for node in e.dual_basis()]
    return DualSet(nodes, ref_el.get_parent() or ref_el, entity_ids)


def _merged_coeffs(elements, ref_el, expansion_set, embedded_degree):
    """Primal coefficients of the direct sum on the host expansion set."""
    sd = ref_el.get_spatial_dimension()
    if (isinstance(expansion_set, LagrangeLineExpansionSet)
            and expansion_set.degree == embedded_degree):
        # 1D nodal host: interpolation at its own points is the change of
        # basis
        pts = expansion_set.get_points()
        return np.vstack([e.tabulate(0, pts)[(0,)] for e in elements])

    if all(e.get_nodal_basis().get_expansion_set() == expansion_set
           for e in elements):
        # shared expansion: zero-pad each block through the embedding map
        blocks = [e.get_coeffs() for e in elements]
        vshape = blocks[0].shape[1:-1]
        assert all(c.shape[1:-1] == vshape for c in blocks)
        width = max(c.shape[-1] for c in blocks)
        out = np.zeros((sum(len(c) for c in blocks), *vshape, width),
                       dtype=blocks[0].dtype)
        lo = 0
        for e, c in zip(elements, blocks):
            emb = expansion_embedding(ref_el, e.degree(), embedded_degree,
                                      expansion_set.continuity)
            out[lo:lo + len(c), ..., emb] = c
            lo += len(c)
        return out

    # mismatched expansions: Galerkin (L2) projection onto the host span
    Q = create_quadrature(ref_el, 2 * embedded_degree)
    qpts = Q.get_points()
    phis = expansion_set._tabulate(embedded_degree, qpts, 0)[(0,) * sd]
    PhiW = phis * Q.get_weights()
    proj = np.linalg.solve(np.tensordot(phis, PhiW, (-1, -1)), PhiW)
    tabs = np.concatenate([e.tabulate(0, qpts)[(0,) * sd]
                           for e in elements], axis=0)
    return np.tensordot(tabs, proj, (-1, -1))


class NodalEnrichedElement(CiarletElement):
    """Direct sum of nodal elements, with the primal basis re-nodalised
    against the concatenated dual basis (well defined iff the summands'
    primal, equivalently dual, bases are mutually independent)."""

    def __init__(self, *elements):
        if not all(e.is_nodal() for e in elements):
            raise ValueError("NodalEnrichedElement requires nodal inputs")

        # the host: the summand on the maximal complex at top degree
        # carries the expansion set everything else embeds into
        host = max(elements,
                   key=lambda e: (e.get_reference_complex(), e.degree()))
        ref_el = host.get_reference_complex()
        expansion_set = host.get_nodal_basis().get_expansion_set()
        mapping = host.mapping()[0]
        assert all(e.get_reference_complex() <= ref_el for e in elements)
        assert all(set(e.mapping()) == {mapping} for e in elements)
        assert all(e.value_shape() == host.value_shape() for e in elements)

        embedded_degree = max(e.degree() for e in elements)
        coeffs = _merged_coeffs(elements, ref_el, expansion_set,
                                embedded_degree)
        assert coeffs.shape[1:-1] == host.value_shape()
        poly_set = PolynomialSet(ref_el, embedded_degree, embedded_degree,
                                 expansion_set, coeffs)

        formdegree = (None
                      if any(e.get_formdegree() is None for e in elements)
                      else max(e.get_formdegree() for e in elements))
        super().__init__(poly_set, _stacked_dual(elements, ref_el),
                         max(e.get_order() for e in elements),
                         formdegree=formdegree, mapping=mapping)
