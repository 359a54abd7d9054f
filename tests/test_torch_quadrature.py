"""Quadrature and Jacobi evaluation of the port (fiat_tpu_torch) against
fiat_tpu: the same rule must be chosen by the 'default' dispatch and the
same points and weights come out, or the moment duals of the elements land
on other points and their coefficients drift."""

import numpy as np
import pytest

from fiat_tpu.core import cells as jcl
from fiat_tpu.core import jacobi as jjac
from fiat_tpu.core import macro as jmacro
from fiat_tpu.core import quadrature as jquad
from fiat_tpu.core.quadrature_schemes import create_quadrature as jcreate
from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.core import jacobi as tjac
from fiat_tpu_torch.core import macro as tmacro
from fiat_tpu_torch.core import quadrature as tquad
from fiat_tpu_torch.core.quadrature_schemes import create_quadrature as tcreate

TOL = 1e-15     # the same numpy algorithm on both sides: identical up to round-off


def _same_rule(got, want):
    assert got.get_points().shape == np.asarray(want.get_points()).shape
    assert np.abs(got.get_points() - np.asarray(want.get_points())).max(initial=0.0) <= TOL
    assert np.abs(got.get_weights() - np.asarray(want.get_weights())).max() <= TOL


@pytest.mark.parametrize("dim", [0, 1, 2, 3])
@pytest.mark.parametrize("degree", range(0, 13))
def test_default_rule_matches_fiat_tpu(dim, degree):
    """Points and intervals take collapsed Gauss; triangles (degrees 2-12 in
    full_zoo) and tetrahedra the cheapest of symmetric, elimination and
    collapsed rules."""
    _same_rule(tcreate(tcl.ufc_simplex(dim), degree), jcreate(jcl.ufc_simplex(dim), degree))


@pytest.mark.parametrize("degree", [1, 4, 7, 15, 20])
def test_canonical_and_symmetric_schemes_match(degree):
    T, J = tcl.ufc_simplex(2), jcl.ufc_simplex(2)
    for scheme in ("canonical", "symmetric"):
        _same_rule(tcreate(T, degree, scheme), jcreate(J, degree, scheme))


@pytest.mark.parametrize("split", ["AlfeldSplit", "PowellSabinSplit", "PowellSabin12Split"])
@pytest.mark.parametrize("degree", [2, 4, 6])
def test_composite_rule_on_split_complexes_matches(split, degree):
    got = tcreate(getattr(tmacro, split)(tcl.ufc_simplex(2)), degree)
    want = jcreate(getattr(jmacro, split)(jcl.ufc_simplex(2)), degree)
    _same_rule(got, want)
    assert abs(got.get_weights().sum() - 0.5) <= 1e-14


def test_composite_rule_on_a_split_interval_matches():
    got = tcreate(tmacro.AlfeldSplit(tcl.ufc_simplex(1)), 3)
    _same_rule(got, jcreate(jmacro.AlfeldSplit(jcl.ufc_simplex(1)), 3))


@pytest.mark.parametrize("dim,entity", [(2, (1, 0)), (2, (1, 2)), (3, (2, 1)), (3, (1, 4))])
def test_facet_rules_match(dim, entity):
    got = tcreate(tcl.ufc_simplex(dim), 5, entity=entity)
    want = jcreate(jcl.ufc_simplex(dim), 5, entity=entity)
    _same_rule(got, want)
    assert np.abs(got.jacobian() - want.jacobian()).max() <= TOL


@pytest.mark.parametrize("m,a,b", [(1, 0, 0), (5, 1, 0), (7, 2, 0)])
def test_gauss_jacobi_line_rules_match(m, a, b):
    _same_rule(tquad.GaussJacobiQuadratureLineRule(tcl.ufc_simplex(1), m, a, b),
               jquad.GaussJacobiQuadratureLineRule(jcl.ufc_simplex(1), m, a, b))


def test_unported_schemes_raise():
    """The "gm" scheme, once refused, now gives fiat_tpu's rule; an unknown
    scheme still raises ValueError."""
    _same_rule(tcreate(tcl.ufc_simplex(2), 3, "gm"), jcreate(jcl.ufc_simplex(2), 3, "gm"))
    with pytest.raises(ValueError):
        tcreate(tcl.ufc_simplex(2), 3, "nonsense")


@pytest.mark.parametrize("a,b", [(0, 0), (1, 1), (2, 2), (1, 0)])
def test_jacobi_batches_match(a, b):
    x = np.random.default_rng(a + 3 * b).uniform(-1, 1, (17, 1))
    assert np.abs(tjac.eval_jacobi_batch(a, b, 6, x)
                  - jjac.eval_jacobi_batch(a, b, 6, x)).max() <= TOL
    assert np.abs(tjac.eval_jacobi_deriv_batch(a, b, 6, x)
                  - jjac.eval_jacobi_deriv_batch(a, b, 6, x)).max() <= TOL
    assert np.abs(tjac.eval_jacobi(a, b, 4, x[:, 0])
                  - jjac.eval_jacobi(a, b, 4, x[:, 0])).max() <= TOL


@pytest.mark.parametrize("name,tables", [("triquad_data", ["TRIANGLE"]),
                                         ("tetquad_data", ["TETRAHEDRON"]),
                                         ("symquad_data", ["TRIANGLE", "TETRAHEDRON"])])
def test_quadrature_data_copies_equal_fiat_tpu_tables(name, tables):
    """The port's copies of the generated data modules hold fiat_tpu's
    tables exactly, degree by degree (the copy is loaded as the port's own
    module, never from fiat_tpu's directory)."""
    import importlib
    from fiat_tpu_torch.core.quad_tables import load_table
    got = load_table(name)
    want = importlib.import_module(f"fiat_tpu.core.{name}")
    assert got.__name__ == f"fiat_tpu_torch.core.{name}"
    for table in tables:
        g, w = getattr(got, table), getattr(want, table)
        assert sorted(g) == sorted(w)
        for degree in w:
            assert g[degree] == w[degree], (table, degree)
