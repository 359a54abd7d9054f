"""Alfeld-Sorokina: C0 quadratic vector macroelement on the Alfeld split
whose divergence is also C0.  Counterpart of
``fiat_tpu/elements/alfeld_sorokina.py``, on the declarative dual
builder."""

import numpy as np

from ..core import finite_element, polyset
from ..core.dual_builder import DualBuilder
from ..core.functionals import ComponentPointEvaluation, PointDivergence
from ..core.macro import AlfeldSplit, CkPolynomialSet
from ..core.quadrature_schemes import create_quadrature


def AlfeldSorokinaSpace(ref_el, degree):
    """Vector C0 polynomials on the Alfeld split constrained to have
    continuous divergence: the null space of the divergence-jump moments
    over the interior facets."""
    ref_complex = AlfeldSplit(ref_el)
    sd = ref_complex.get_spatial_dimension()
    C0 = CkPolynomialSet(ref_complex, degree, order=0, shape=(sd,),
                         variant="bubble")
    es = C0.get_expansion_set()

    facet = ref_complex.construct_subelement(sd - 1)
    tests = polyset.ONPolynomialSet(facet, 0 if sd == 1 else degree - 1)
    Q = create_quadrature(facet, 2 * tests.degree)
    wphi = tests.tabulate(Q.get_points())[(0,) * (sd - 1)] * Q.get_weights()

    constraints = []
    for facet_id in ref_complex.get_interior_facets(sd - 1):
        n = ref_complex.compute_normal(facet_id)
        jumps = es.tabulate_normal_jumps(degree, Q.get_points(), facet_id,
                                         order=1)
        # div jump moment rows: one per (test fn), columns (member, comp)
        moments = np.tensordot(n[:, None, None] * jumps[1][None],
                               wphi, axes=(-1, -1))
        constraints.append(
            moments.reshape(C0.get_num_members(), -1).T)

    coeffs = C0.get_coeffs()
    if constraints:
        nsp = polyset.spanning_basis(np.vstack(constraints), nullspace=True)
        coeffs = np.tensordot(nsp, coeffs, axes=(-1, 0))
    return polyset.PolynomialSet(ref_complex, degree, degree, es, coeffs)


class AlfeldSorokina(finite_element.CiarletElement):
    """Divergence dofs at the degree-1 lattice plus vector point values
    at the degree-2 lattice, on every subentity."""

    def __init__(self, ref_el, degree=2):
        if degree != 2:
            raise NotImplementedError(
                "AlfeldSorokina only defined for degree = 2")
        sd = ref_el.get_spatial_dimension()
        b = DualBuilder(ref_el)
        for dim in sorted(b.top):
            for e in b.entities(dim):
                b.tag(dim, e, [PointDivergence(ref_el, p)
                               for p in b.lattice(dim, e, degree - 1)]
                              + [ComponentPointEvaluation(ref_el, k, (sd,), p)
                                 for p in b.lattice(dim, e, degree)
                                 for k in range(sd)])
        super().__init__(AlfeldSorokinaSpace(ref_el, degree), b.dual_set(),
                         degree, sd - 1, mapping="contravariant piola")
