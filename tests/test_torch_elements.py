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
#: the moment, derivative and macro elements of full_zoo (bench.py:840-862),
#: plus PS12: (family, args)
FULL_ZOO_REST = ([("RaviartThomas", (k,)) for k in range(1, 7)]
                 + [("Nedelec", (k,)) for k in range(1, 7)]
                 + [("BrezziDouglasMarini", (k,)) for k in range(1, 7)]
                 + [("CubicHermite", ()), ("Morley", ()), ("Argyris", (5,)), ("Bell", ()),
                    ("HsiehCloughTocher", (3,)), ("QuadraticPowellSabin6", ()),
                    ("QuadraticPowellSabin12", ())])
TAB_TOL = 1e-10     # the BASELINE.json bar for tabulations


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
    ref = jfe.Lagrange(jcl.ufc_simplex(2), 2, variant="alfeld")
    el = tfe.Lagrange(T, 2, variant="alfeld")
    assert el.is_macroelement() and el.entity_dofs() == ref.entity_dofs()
    assert np.abs(el.get_coeffs() - np.asarray(ref.get_coeffs())).max() <= TOL
    ref = jfe.Lagrange(jcl.ufc_simplex(2), 2, variant="iso(2)")
    el = tfe.Lagrange(T, 2, variant="iso(2)")
    assert el.is_macroelement() and el.entity_dofs() == ref.entity_dofs()
    assert np.array_equal(el.get_coeffs(), np.asarray(ref.get_coeffs()))
    with pytest.raises(ValueError):
        tfe.Lagrange(T, 2, variant="nonsense")


@pytest.mark.parametrize("family,args", FULL_ZOO_REST)
def test_full_zoo_element_matches_fiat_tpu(family, args):
    """Same duals on the same quadrature points, same nodal solve: the
    coefficients agree to round-off and the tabulations to the bar."""
    ref = getattr(jfe, family)(jcl.ufc_simplex(2), *args)
    el = getattr(tfe, family)(tcl.ufc_simplex(2), *args)
    assert el.space_dimension() == ref.space_dimension()
    assert el.entity_dofs() == ref.entity_dofs()
    assert el.value_shape() == ref.value_shape()
    assert el.mapping() == ref.mapping()
    assert el.is_macroelement() == ref.is_macroelement()
    assert np.abs(el.get_coeffs() - np.asarray(ref.get_coeffs())).max() <= TOL

    rng = np.random.default_rng(len(family) + sum(args))
    pts = rng.random((60, 2))
    pts = pts / (pts.sum(axis=1)[:, None] + 1e-9) * rng.random((60, 1))
    want = ref.tabulate(1, pts)
    got = el.tabulate(1, pts)
    assert set(got) == set(want)
    for alpha in want:
        assert got[alpha].shape == np.asarray(want[alpha]).shape
        assert np.abs(got[alpha] - np.asarray(want[alpha])).max() <= TAB_TOL, alpha


def test_moment_duals_sit_on_fiat_tpus_points():
    """The 'default' quadrature dispatch picks the same rules: every
    functional has the same points, weights and derivative terms."""
    T, J = tcl.ufc_simplex(2), jcl.ufc_simplex(2)
    for el, ref in ((tfe.RaviartThomas(T, 4), jfe.RaviartThomas(J, 4)),
                    (tfe.Argyris(T, 5), jfe.Argyris(J, 5)),
                    (tfe.HsiehCloughTocher(T, 3), jfe.HsiehCloughTocher(J, 3))):
        for n, m in zip(el.dual_basis(), ref.dual_basis()):
            assert np.array_equal(n.points, m.points)
            assert np.array_equal(n.weights, m.weights)
            assert np.array_equal(n.alphas, m.alphas) and np.array_equal(n.comps, m.comps)


def test_moment_variants_and_unported_splits():
    T = tcl.ufc_simplex(2)
    ref = jfe.Nedelec(jcl.ufc_simplex(2), 3, variant="point")
    el = tfe.Nedelec(T, 3, variant="point")
    assert np.abs(el.get_coeffs() - np.asarray(ref.get_coeffs())).max() <= TOL
    ref = jfe.RaviartThomas(jcl.ufc_simplex(2), 2, variant="integral(1)")
    el = tfe.RaviartThomas(T, 2, variant="integral(1)")
    assert np.abs(el.get_coeffs() - np.asarray(ref.get_coeffs())).max() <= TOL
    ref = jfe.RaviartThomas(jcl.ufc_simplex(2), 2, variant="integral,alfeld")
    el = tfe.RaviartThomas(T, 2, variant="integral,alfeld")
    assert el.is_macroelement() and el.entity_dofs() == ref.entity_dofs()
    assert np.array_equal(el.get_coeffs(), np.asarray(ref.get_coeffs()))
    with pytest.raises(ValueError):
        tfe.Nedelec(T, 2, variant="nonsense")



def test_dual_builder_helpers_match_fiat_tpu():
    """The jet, moment and bookkeeping helpers of the dual builder build the
    same functionals and entity ids as fiat_tpu's."""
    from fiat_tpu.core.dual_builder import DualBuilder as JDualBuilder
    from fiat_tpu_torch.core.dual_builder import DualBuilder

    duals = []
    for builder, cell in ((DualBuilder, tcl.ufc_simplex(2)), (JDualBuilder, jcl.ufc_simplex(2))):
        b = builder(cell)
        b.vertex_jets(1)
        b.midpoint_jet(1, 2)
        b.moments(1, 1, 3)
        b.interior_moments(0, 2)
        b.also_tag(2, 0, b.ids_of(1, 0))
        duals.append(b.dual_set())
    got, want = duals
    assert got.get_entity_ids() == want.get_entity_ids()
    assert len(got.get_nodes()) == len(want.get_nodes()) == 3 * 3 + 5 + 3 * 2 + 1
    for n, m in zip(got.get_nodes(), want.get_nodes()):
        assert type(n).__name__ == type(m).__name__
        for attr in ("points", "weights", "alphas", "comps", "pt_ids"):
            assert np.array_equal(getattr(n, attr), getattr(m, attr)), attr
