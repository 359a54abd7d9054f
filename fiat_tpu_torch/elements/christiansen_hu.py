"""Christiansen-Hu C0(Worsey-Farin) Stokes macroelement:
{v in C0 P1(WF)^d : div v = 0} + P0 x, augmented (unless ``reduced``)
with facet bubbles rotated onto the facet tangent spaces.  Counterpart of
``fiat_tpu/elements/christiansen_hu.py``: a divergence-nullspace
projection, the radial P0 x mode, and an einsum-batched bubble rotation.
"""

import numpy as np

from ..core import finite_element, polyset
from ..core.macro import CkPolynomialSet, WorseyFarinSplit
from ..core.quadrature_schemes import create_quadrature
from .bernardi_raugel import BernardiRaugelDualSet


def _div_free_coeffs(C0, degree):
    """Coefficients of the divergence-free subspace of a vector-valued
    C0 set, by the nullspace of the divergence tabulation."""
    complex_ = C0.get_reference_element()
    sd = complex_.get_spatial_dimension()
    Q = create_quadrature(complex_, degree - 1)
    tab = C0.tabulate(Q.get_points(), 1)
    div = sum(tab[tuple(a)][:, d, :]
              for d, a in enumerate(np.eye(sd, dtype=int)))
    nsp = polyset.spanning_basis(div.T, nullspace=True)
    return np.tensordot(nsp, C0.get_coeffs(), axes=(-1, 0))


def _rotated_facet_bubbles(ref_el, verts, facet_bubbles):
    """Tangential companions of the facet bubbles: each bubble points
    from its facet split point toward the cell split point; its scalar
    profile is re-emitted along every facet tangent."""
    sd = ref_el.get_spatial_dimension()
    WT = verts[-1]                      # cell split point
    WF = verts[sd + 1:-1]               # one split point per facet
    facets = sorted(ref_el.get_topology()[sd - 1])
    profiles = np.einsum("fd,fdm->fm", WF - WT, facet_bubbles)
    thats = np.asarray([ref_el.compute_tangents(sd - 1, f) for f in facets])
    ext = np.einsum("ftd,fm->ftdm", thats, profiles)
    return ext.reshape(-1, *facet_bubbles.shape[1:])


def ChristiansenHuSpace(ref_el, degree, reduced=False):
    """{v in C0 P1(WF)^d : div v = 0} + P0 x (+ rotated facet bubbles)."""
    sd = ref_el.get_spatial_dimension()
    ref_complex = WorseyFarinSplit(ref_el)
    C0 = CkPolynomialSet(ref_complex, degree, order=0, shape=(sd,), scale=1,
                         variant="bubble")
    verts = np.asarray(ref_complex.get_vertices())

    # div-free block, then the radial mode x - (cell split point)
    coeffs = _div_free_coeffs(C0, degree)
    radial = (verts - verts[-1]).T
    coeffs = np.concatenate((coeffs, radial[None]), axis=0)

    if not reduced:
        # nodalise against the reduced Bernardi-Raugel dual so the last
        # sd+1 members become the facet bubbles, then append their
        # tangential rotations
        dual = BernardiRaugelDualSet(ref_el, degree, degree=degree,
                                     ref_complex=ref_complex, reduced=True)
        V = np.tensordot(dual.to_riesz(C0), coeffs,
                         axes=((1, 2), (1, 2)))
        coeffs = np.linalg.solve(
            V.T, coeffs.reshape(len(coeffs), -1)).reshape(coeffs.shape)
        ext = _rotated_facet_bubbles(ref_el, verts, coeffs[-(sd + 1):])
        coeffs = np.concatenate((coeffs, ext), axis=0)

    return polyset.PolynomialSet(ref_complex, degree, degree,
                                 C0.get_expansion_set(), coeffs)


class ChristiansenHu(finite_element.CiarletElement):
    """Christiansen-Hu linear macroelement (paired with unsplit DG0)."""

    def __init__(self, ref_el, degree=1):
        if degree != 1:
            raise ValueError("Christiansen-Hu only defined for degree = 1")
        poly_set = ChristiansenHuSpace(ref_el, degree)
        dual = BernardiRaugelDualSet(
            ref_el, degree, degree=degree,
            ref_complex=poly_set.get_reference_element())
        super().__init__(poly_set, dual, degree,
                         ref_el.get_spatial_dimension() - 1,
                         mapping="contravariant piola")
