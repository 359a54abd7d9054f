"""The Bernstein-feature route of the port (ops/bernstein.py, K8's plain
version, and FusedZooTabulator(features="bernstein") on the CPU) against
fiat_tpu's ops/pallas_bernstein.py.

Inputs are numpy arrays made from seeds and handed to both packages.
fiat_tpu's interpreted feature kernel is only f32-accurate on the CPU
(tests/test_device_ops.py:700-723), so the plain features are held against
its f64 reference ``xla_f64``."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fiat_tpu.core import cells as jcl
from fiat_tpu.core.expansions import ExpansionSet as JExpansionSet
from fiat_tpu.ops import pallas_bernstein as jb
from fiat_tpu_torch import elements as tfe
from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.core.expansions import ExpansionSet
from fiat_tpu_torch.ops import bernstein as tb
from fiat_tpu_torch.ops.fused_zoo import FusedZooTabulator
from fiat_tpu_torch.ops.tabulate import BatchedTabulator

RTOL_CONVERSION = 1e-13  # the same longdouble Gram projection on the same rule
RTOL_FEATURES = 1e-13    # the same products, in the same order
ATOL_HOST = 1e-10        # the engine vs host el.tabulate (BASELINE.json's bar)


def _points(cell, n, seed):
    lam = np.random.default_rng(seed).dirichlet(np.ones(cell.get_spatial_dimension() + 1), n)
    return lam @ np.asarray(cell.get_vertices())


@pytest.mark.parametrize("sd", [1, 2, 3])
def test_multiindices_and_multinomials_match_fiat_tpu(sd):
    for degree in range(0, 11):
        mis = tb.bernstein_multiindices(sd, degree)
        assert mis == jb.bernstein_multiindices(sd, degree)
        assert [tb.multinomial(degree, mi) for mi in mis] == \
            [jb.multinomial(degree, mi) for mi in mis]
    with pytest.raises(NotImplementedError):
        tb.bernstein_multiindices(4, 2)


@pytest.mark.parametrize("sd,degree", [(2, 10), (3, 8)])
def test_conversion_matches_fiat_tpu_and_reproduces_dubiner(sd, degree):
    M = tb.bernstein_conversion(ExpansionSet(tcl.ufc_simplex(sd)), degree)
    want = jb.bernstein_conversion(JExpansionSet(jcl.ufc_simplex(sd)), degree)
    assert M.dtype == np.longdouble
    assert np.abs(np.asarray(M - want, np.float64)).max() <= \
        RTOL_CONVERSION * float(np.abs(want).max())
    cell = tcl.ufc_simplex(sd)
    pts = _points(cell, 300, degree)
    B = tb._bernstein_host(cell, degree, pts)
    Phi = ExpansionSet(cell).tabulate(degree, pts)
    assert np.abs(np.asarray(M, np.float64) @ B - Phi).max() <= 1e-11


@pytest.mark.parametrize("sd,degree", [(1, 6), (2, 7), (3, 4), (3, 8)])
def test_plain_features_match_fiat_tpu_xla_f64(sd, degree):
    jcell, tcell = jcl.ufc_simplex(sd), tcl.ufc_simplex(sd)
    pts = _points(tcell, 300, sd + degree)
    want = np.asarray(jb.PallasBernsteinFeatures(JExpansionSet(jcell), degree, interpret=True)
                      .xla_f64(jnp.asarray(pts)))
    feat = tb.BernsteinFeatures(sd, degree, tb._bary_map(tcell), device="cpu")
    got = feat(torch.as_tensor(pts))
    assert feat.launches == 0 and tuple(got.shape) == want.shape == (feat.nexp, 300)
    assert np.abs(got.numpy() - want).max() <= RTOL_FEATURES * np.abs(want).max()
    host = tb._bernstein_host(tcell, degree, pts)
    assert np.abs(got.numpy() - host).max() <= RTOL_FEATURES * np.abs(host).max()


def test_operand_on_the_default_simplex_is_the_cells():
    """The engine builds the conversion and the barycentric map on the
    default simplex and composes the cell map: the same features and
    Dubiner basis as on the UFC cell itself."""
    cell = tcl.ufc_simplex(3)
    es = ExpansionSet(cell)
    M, bary = tb.bernstein_operand(3, 5, es.get_scale(5), es.affine_mappings[0])
    pts = _points(cell, 200, 9)
    B = tb.BernsteinFeatures(3, 5, bary, device="cpu")(torch.as_tensor(pts)).numpy()
    assert np.abs(B - tb._bernstein_host(cell, 5, pts)).max() <= 1e-13
    assert np.abs(np.asarray(M, np.float64) @ B - es.tabulate(5, pts)).max() <= 1e-11


@pytest.mark.parametrize("degree", [4, 8])
def test_bernstein_engine_matches_host(degree):
    """fiat_tpu's own case (tests/test_device_ops.py:748-773) and
    tet_lagrange8: the folded rows times the features are the tables."""
    cell = tcl.ufc_simplex(3)
    el = tfe.Lagrange(cell, degree)
    fz = FusedZooTabulator(BatchedTabulator([el], order=1, device="cpu"), device="cpu",
                           features="bernstein")
    assert fz.recurrence is None and fz.features.degree == degree
    pts = _points(cell, 240, degree)
    got = fz.unpack(fz.block_tables(pts))[0]
    assert (fz.features.launches, fz.matmul.launches) == (0, 0)
    host = el.tabulate(1, pts)
    assert set(got) == set(host)
    for a in host:
        assert np.abs(got[a].numpy() - host[a]).max() <= ATOL_HOST, a


def test_bernstein_route_refuses_multi_width_and_macro_zoos():
    tri, tet = tcl.ufc_simplex(2), tcl.ufc_simplex(3)
    for zoo in ([tfe.Lagrange(tet, 2), tfe.Lagrange(tet, 3)],
                [tfe.Lagrange(tri, 3), tfe.HsiehCloughTocher(tri, 3)]):
        bt = BatchedTabulator(zoo, order=1, device="cpu")
        with pytest.raises(ValueError, match="one contraction width and no macro"):
            FusedZooTabulator(bt, device="cpu", features="bernstein")
        FusedZooTabulator(bt, device="cpu", features="dubiner")
    bt = BatchedTabulator([tfe.Lagrange(tet, 2)], order=0, device="cpu")
    with pytest.raises(ValueError, match="features"):
        FusedZooTabulator(bt, device="cpu", features="monomial")
    fz = FusedZooTabulator.from_arrays(**bt.state(), features="bernstein", device="cpu")
    assert fz.features is not None and fz.alphas == [(0, 0, 0)]


def test_features_wrapper_checks():
    feat = tb.BernsteinFeatures(2, 3, tb._bary_map(tcl.ufc_simplex(2)), device="cpu")
    pts = torch.as_tensor(_points(tcl.ufc_simplex(2), 20, 1))
    with pytest.raises(TypeError, match="float64"):
        feat(pts.float())
    with pytest.raises(ValueError, match="shape"):
        feat(torch.zeros((4, 3), dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        feat(torch.zeros((2, 4), dtype=torch.float64).T)
    with pytest.raises(NotImplementedError, match="outside 0..15"):
        tb.BernsteinFeatures(3, 16, tb._bary_map(tcl.ufc_simplex(3)), device="cpu")
    with pytest.raises(NotImplementedError, match="sd 1-3"):
        tb.BernsteinFeatures(4, 1, (np.zeros((5, 4)), np.zeros(5)), device="cpu")
