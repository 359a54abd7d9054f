"""Host construction of the port (fiat_tpu_torch) against fiat_tpu: the
same numpy f64 algorithm on both sides, so nodal coefficients and host
tabulations agree to round-off."""

import numpy as np
import pytest

from fiat_tpu import elements as jfe
from fiat_tpu.core import cells as jcl
from fiat_tpu_torch import elements as tfe
from fiat_tpu_torch.core import cells as tcl

CASES = ([("Lagrange", p) for p in range(1, 7)]
         + [("DiscontinuousLagrange", p) for p in range(0, 6)])
TOL = 1e-12


@pytest.mark.parametrize("family,degree", CASES)
def test_element_matches_fiat_tpu(family, degree):
    ref = getattr(jfe, family)(jcl.ufc_simplex(2), degree)
    el = getattr(tfe, family)(tcl.ufc_simplex(2), degree)
    assert type(el).__name__ == type(ref).__name__
    assert el.space_dimension() == ref.space_dimension()
    assert el.entity_dofs() == ref.entity_dofs()
    assert np.abs(el.get_coeffs() - np.asarray(ref.get_coeffs())).max() <= TOL

    pts = np.random.default_rng(degree).random((50, 2)) * 0.5
    want = ref.tabulate(1, pts)
    got = el.tabulate(1, pts)
    assert set(got) == set(want)
    for alpha in want:
        assert np.abs(got[alpha] - np.asarray(want[alpha])).max() <= TOL, alpha


def test_element_permutations_and_dual_points_match():
    T, Tj = tcl.ufc_simplex(2), jcl.ufc_simplex(2)
    for el, ref in ((tfe.Lagrange(T, 4), jfe.Lagrange(Tj, 4)),
                    (tfe.DiscontinuousLagrange(T, 3), jfe.DiscontinuousLagrange(Tj, 3))):
        assert el.entity_permutations() == ref.entity_permutations()
        pts = [n.points[0] for n in el.dual_basis()]
        pts_ref = [n.points[0] for n in ref.dual_basis()]
        assert np.array_equal(np.asarray(pts), np.asarray(pts_ref))


def test_variants_and_unported_splits():
    T = tcl.ufc_simplex(2)
    ref = jfe.Lagrange(jcl.ufc_simplex(2), 4, variant="gll")
    el = tfe.Lagrange(T, 4, variant="gll")
    assert np.abs(el.get_coeffs() - np.asarray(ref.get_coeffs())).max() <= TOL
    with pytest.raises(NotImplementedError):
        tfe.Lagrange(T, 2, variant="alfeld")
    with pytest.raises(ValueError):
        tfe.Lagrange(T, 2, variant="nonsense")
