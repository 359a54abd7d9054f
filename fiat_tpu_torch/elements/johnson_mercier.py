"""Johnson-Mercier: H(div;S)-conforming symmetric tensors on the Alfeld
split with facet nn/nt moments.  Counterpart of
``fiat_tpu/elements/johnson_mercier.py``, on the declarative dual
builder."""

import numpy as np

from ..core import finite_element, polyset
from ..core.dual_builder import DualBuilder
from ..core.functionals import TensorBidirectionalIntegralMoment
from ..core.macro import AlfeldSplit, HDivSymPolynomialSet
from ..core.variants import parse_quadrature_scheme


def jm_duals(ref_complex, degree, scheme):
    ref_el = ref_complex.get_parent()
    sd = ref_el.get_spatial_dimension()
    b = DualBuilder(ref_el)

    Q_ref, phis = b.facet_basis(sd - 1, degree, 2 * degree, scheme)
    for f in b.entities(sd - 1):
        ts = ref_el.compute_tangents(sd - 1, f)
        if sd == 2:
            nh = np.array([ts[0][1], -ts[0][0]])
            frame = (nh, *ts)
        else:
            nh = np.cross(*ts)
            frame = (nh, *np.cross(nh[None, :], ts, axis=1))
        Q = b.map_rule(sd - 1, f, Q_ref)
        b.tag(sd - 1, f, (TensorBidirectionalIntegralMoment(
            ref_el, nh, comp, Q, phi) for phi in phis for comp in frame))

    normals = [ref_el.compute_scaled_normal(f)
               for f in b.entities(sd - 1)]
    Q = parse_quadrature_scheme(ref_complex, 2 * degree - 1, scheme)
    tests = polyset.ONPolynomialSet(ref_el, degree - 1, scale="L2 piola")
    cell_phis = tests.tabulate(Q.get_points())[(0,) * sd]
    b.tag(sd, 0, (TensorBidirectionalIntegralMoment(
        ref_el, normals[i + 1], normals[j + 1], Q, phi)
        for phi in cell_phis
        for i in range(sd) for j in range(i, sd)))
    return b.dual_set()


class JohnsonMercier(finite_element.CiarletElement):
    """The Johnson-Mercier element."""

    def __init__(self, ref_el, degree=1, variant=None, quad_scheme=None):
        if degree != 1:
            raise ValueError("Johnson-Mercier only defined for degree=1")
        if variant is not None:
            raise ValueError(
                f"Johnson-Mercier does not have the {variant} variant")
        ref_complex = AlfeldSplit(ref_el)
        poly_set = HDivSymPolynomialSet(ref_complex, degree)
        dual = jm_duals(ref_complex, degree, quad_scheme)
        super().__init__(poly_set, dual, degree,
                         ref_el.get_spatial_dimension() - 1,
                         mapping="double contravariant piola")
