"""The Stokes, elasticity and C2 families of fiat_tpu's nodality sweep on the
port against fiat_tpu: each element of the sweep's instance list
(tests/test_nodality_sweep.py ``SPECS`` of BernardiRaugel, MardalTaiWinther,
ArnoldWinther(NC), HuZhang, JohnsonMercier, AlfeldSorokina, ArnoldQin,
ChristiansenHu, GuzmanNeilan first and second kind, WuXu, BrambleZlamalC2
and AlfeldC2, its ``NodalEnriched-GN`` composite) and Walkington (fiat_tpu's
parity tests, tests/test_elements_wave2.py:238) built by both packages
(coefficients, entity dofs and permutations, dual points and weights, host
tables), the core pieces they need (the divergence and Legendre
functionals, the H(div) sets, the C^k sets' vertex-order and bubble paths,
subcomplexes of the splits), and chip_smoke.py's two zoos
(``stokes_elasticity_tri``, ``stokes_elasticity_tet``) through every engine
of the port on the CPU (the kernels' plain versions) against fiat_tpu's
engines, its Pallas kernels in interpret mode as its own tests run them.

Inputs are numpy arrays made from seeds and handed to both packages."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiat_tpu import elements as jfe
from fiat_tpu.core import cells as jcl
from fiat_tpu.core import functionals as jfl
from fiat_tpu.core import macro as jma
from fiat_tpu.core import polyset as jps
from fiat_tpu.core import quadrature_schemes as jqs
from fiat_tpu.ops import moments as jmo
from fiat_tpu.ops.pallas_multiword import FusedZooTabulator as JFusedZooTabulator
from fiat_tpu.ops.pallas_tabulate import PallasZooTabulator
from fiat_tpu.ops.tabulate import BatchedTabulator as JBatchedTabulator
import fiat_tpu_torch as ft
from fiat_tpu_torch import device_tabulator
from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.core import functionals as tfl
from fiat_tpu_torch.core import macro as tma
from fiat_tpu_torch.core import polyset as tps
from fiat_tpu_torch.core import quadrature_schemes as tqs
from fiat_tpu_torch.ops import moments as tmo
from fiat_tpu_torch.ops.f32_zoo import F32ZooTabulator
from fiat_tpu_torch.ops.fused_zoo import FusedZooTabulator
from fiat_tpu_torch.ops.moments import MomentEngine
from fiat_tpu_torch.ops.tabulate import BatchedTabulator

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))
import chip_smoke  # noqa: E402
from chip_smoke import merged_macro
from test_nodality_sweep import COMPOSITES, SPECS, _label  # noqa: E402
from test_torch_families import _permutations, _points  # noqa: E402
from test_torch_many_subcells import (  # noqa: E402
    _host_bar, _tie_points, dual_bars)

ATOL_HOST = 1e-14       # host tables of one element, port vs fiat_tpu
RTOL_PLAIN = 1e-13      # the same arithmetic on arrays carried across
RTOL_F32 = 5e-6         # fiat_tpu's f32 bar (tests/test_device_ops.py:143-144)
MACRO_TOL = 5e-5        # its macro bar, relative to max abs + 1 (:586-589)

#: the slice's families: the sweep's Stokes, elasticity and C2 elements
FAMILIES = {"WuXuH3NC", "WuXuRobustH3NC", "BrambleZlamalC2", "AlfeldC2", "BernardiRaugel",
            "MardalTaiWinther", "ArnoldWintherNC", "ArnoldWinther", "HuZhang",
            "JohnsonMercier", "AlfeldSorokina", "ArnoldQin", "ChristiansenHu",
            "GuzmanNeilanFirstKindH1", "GuzmanNeilanSecondKindH1"}
SLICE_SPECS = [s for s in SPECS if s[0] in FAMILIES]
CELLS = {"UFCTriangle": 2, "UFCTetrahedron": 3}


def _build_port(spec):
    family, args, kw = spec
    return getattr(ft, family)(tcl.ufc_simplex(CELLS[type(args[0]).__name__]), *args[1:], **kw)


def _same_element(jel, tel):
    """Coefficients, entity dofs and permutations and every dual node's
    terms bit for bit, and host tables to ATOL_HOST."""
    assert type(tel).__name__ == type(jel).__name__
    assert np.array_equal(np.asarray(tel.get_coeffs()), np.asarray(jel.get_coeffs()))
    assert tel.entity_dofs() == jel.entity_dofs()
    assert tel.entity_closure_dofs() == jel.entity_closure_dofs()
    assert _permutations(tel) == _permutations(jel)
    assert tel.value_shape() == jel.value_shape() and tel.degree() == jel.degree()
    assert tel.mapping() == jel.mapping() and tel.get_formdegree() == jel.get_formdegree()
    tnodes, jnodes = tel.dual_basis(), jel.dual_basis()
    assert len(tnodes) == len(jnodes)
    for tn, jn in zip(tnodes, jnodes):
        assert type(tn).__name__ == type(jn).__name__
        assert tn.target_shape == jn.target_shape
        for field in ("points", "weights", "pt_ids", "comps", "alphas"):
            assert np.array_equal(getattr(tn, field), getattr(jn, field)), field
    sd = tel.get_reference_element().get_spatial_dimension()
    X = _points(9, sd, 1)
    want, got = jel.tabulate(1, X), tel.tabulate(1, X)
    assert set(got) == set(want)
    for a in want:
        assert np.abs(np.asarray(got[a]) - np.asarray(want[a])).max() <= ATOL_HOST, a


@pytest.mark.parametrize("spec", SLICE_SPECS, ids=map(_label, SLICE_SPECS))
def test_sweep_element_matches_fiat_tpu(spec):
    family, args, kw = spec
    _same_element(getattr(jfe, family)(*args, **kw), _build_port(spec))


def test_nodal_enriched_gn_matches_fiat_tpu():
    _same_element(dict(COMPOSITES)["NodalEnriched-GN"](),
                  chip_smoke.composite("NodalEnriched-GN", tcl.ufc_simplex(3)))


def test_walkington_matches_fiat_tpu_with_its_nodal_completion():
    jel, tel = jfe.Walkington(jcl.ufc_simplex(3)), ft.Walkington(tcl.ufc_simplex(3))
    _same_element(jel, tel)
    jc, tc = jel.dual.nodal_completion, tel.dual.nodal_completion
    assert tc.entity_ids == jc.entity_ids
    for tn, jn in zip(tc.nodes, jc.nodes):
        for field in ("points", "weights", "pt_ids", "comps", "alphas"):
            assert np.array_equal(getattr(tn, field), getattr(jn, field)), field


@pytest.mark.parametrize("sd", [2, 3])
def test_guzman_neilan_h1div_matches_fiat_tpu(sd):
    """GuzmanNeilanH1div: Alfeld-Sorokina (restricted to its divergence
    dofs on triangles) enriched with the Guzman-Neilan bubbles."""
    _same_element(jfe.GuzmanNeilanH1div(jcl.ufc_simplex(sd)),
                  ft.GuzmanNeilanH1div(tcl.ufc_simplex(sd)))


# -- core pieces ---------------------------------------------------------------

def _same_terms(jn, tn):
    assert type(tn).__name__ == type(jn).__name__ and tn.target_shape == jn.target_shape
    for field in ("points", "weights", "pt_ids", "comps", "alphas"):
        assert np.array_equal(getattr(tn, field), getattr(jn, field)), field
    for view in ("pt_dict", "deriv_dict"):
        jd, td = getattr(jn, view), getattr(tn, view)
        assert list(td) == list(jd)
        for pt in jd:
            assert [tuple(map(float, t[:1])) + t[1:] for t in td[pt]] \
                == [tuple(map(float, t[:1])) + t[1:] for t in jd[pt]]


def _functional(mod, qs, cells, kind, sd):
    c = cells.ufc_simplex(sd)
    rng = np.random.default_rng(50 + sd)
    if kind == "PointDivergence":
        return mod.PointDivergence(c, tuple(_points(1, sd, 51)[0]))
    if kind == "IntegralMomentOfTensorDivergence":
        Q = qs.create_quadrature(c, 3)
        return mod.IntegralMomentOfTensorDivergence(c, Q, rng.random((sd, len(Q.get_weights()))))
    if kind == "IntegralLegendreDirectionalMoment":
        return mod.IntegralLegendreDirectionalMoment(c, rng.random(2) - 0.5, 1, 3, 5)
    if kind == "IntegralLegendreBidirectionalMoment":
        return mod.IntegralLegendreBidirectionalMoment(c, rng.random(2), rng.random(2), 2, 2, 4)
    return getattr(mod, kind)(c, 0, 2, 4)


FUNCTIONALS = ([("PointDivergence", sd) for sd in (2, 3)]
               + [("IntegralMomentOfTensorDivergence", sd) for sd in (2, 3)]
               + [(k, 2) for k in ("IntegralLegendreDirectionalMoment",
                                   "IntegralLegendreBidirectionalMoment",
                                   "IntegralLegendreNormalNormalMoment",
                                   "IntegralLegendreNormalTangentialMoment")])


@pytest.mark.parametrize("kind,sd", FUNCTIONALS)
def test_new_functionals_match_fiat_tpu(kind, sd):
    _same_terms(_functional(jfl, jqs, jcl, kind, sd), _functional(tfl, tqs, tcl, kind, sd))


@pytest.mark.parametrize("n", [0, 1, 2, 5])
def test_legendre_and_facet_trace_arguments_match_fiat_tpu(n):
    x = np.linspace(-1, 1, 11)
    assert np.array_equal(tfl._legendre(n, x), jfl._legendre(n, x))
    jc, tc = jcl.ufc_simplex(3), tcl.ufc_simplex(3)
    jQ = jqs.create_quadrature(jc.construct_subelement(2), n + 1)
    tQ = tqs.create_quadrature(tc.construct_subelement(2), n + 1)
    p = np.random.default_rng(n).random(len(tQ.get_weights()))
    d = np.array([0.3, -0.2, 0.9])
    want = jfl._facet_trace_moment_args(jc, jQ, p, 2, 1, d, "m")
    got = tfl._facet_trace_moment_args(tc, tQ, p, 2, 1, d, "m")
    assert got[1:3] == want[1:3]
    for g, w in zip(got[3:], want[3:]):
        assert np.array_equal(g, w)


HDIV = [(kind, sd, d) for kind in ("HDivPolynomialSet", "HDivSymPolynomialSet")
        for sd in (2, 3) for d in (1, 2)]


@pytest.mark.parametrize("kind,sd,degree", HDIV)
def test_hdiv_sets_match_fiat_tpu(kind, sd, degree):
    """The H(div) vector and symmetric-tensor sets on the Alfeld split and
    the coefficients under them, with and without the C0 bubble basis."""
    jA, tA = jma.AlfeldSplit(jcl.ufc_simplex(sd)), tma.AlfeldSplit(tcl.ufc_simplex(sd))
    jp, tp = getattr(jma, kind)(jA, degree), getattr(tma, kind)(tA, degree)
    assert np.array_equal(tp.get_coeffs(), jp.get_coeffs())
    X = _points(7, sd, 52)
    want, got = jp.tabulate(X, 1), tp.tabulate(X, 1)
    for a in want:
        assert np.abs(got[a] - want[a]).max() <= ATOL_HOST
    jU = jps.ONPolynomialSet(jA, degree, shape=(sd,), variant="bubble")
    tU = tps.ONPolynomialSet(tA, degree, shape=(sd,), variant="bubble")
    assert np.array_equal(tma.hdiv_conforming_coefficients(tU, order=1),
                          jma.hdiv_conforming_coefficients(jU, order=1))


CK = [(sd, split, degree, kw) for sd, split, degree, kw in [
    (2, "alfeld2", 5, {"order": 2, "variant": "bubble"}),
    (2, "alfeld", 3, {"order": 1, "vorder": 2, "variant": "bubble"}),
    (2, "alfeld", 2, {"order": 0, "shape": (2,), "variant": "bubble"}),
    (2, "worsey-farin", 1, {"order": 0, "shape": (2,), "scale": 1, "variant": "bubble"}),
    (3, "alfeld", 5, {"order": 1, "vorder": 4, "variant": "bubble"}),
    (3, "worsey-farin", 1, {"order": 0, "shape": (3,), "scale": 1, "variant": "bubble"})]]


@pytest.mark.parametrize("sd,split,degree,kw", CK)
def test_ck_sets_vorder_and_bubble_paths_match_fiat_tpu(sd, split, degree, kw):
    """CkPolynomialSet's vertex-order (``vorder``) and C0-bubble paths, as
    Walkington, AlfeldC2 (double Alfeld), Alfeld-Sorokina, Christiansen-Hu
    and Guzman-Neilan use them."""
    def complex_(ma, cl):
        T = cl.ufc_simplex(sd)
        if split == "worsey-farin":
            return ma.WorseyFarinSplit(T)
        A = ma.AlfeldSplit(T)
        return ma.AlfeldSplit(A) if split == "alfeld2" else A
    jp = jma.CkPolynomialSet(complex_(jma, jcl), degree, **kw)
    tp = tma.CkPolynomialSet(complex_(tma, tcl), degree, **kw)
    assert np.array_equal(tp.get_coeffs(), jp.get_coeffs())
    X = _points(7, sd, 53)
    want, got = jp.tabulate(X, 1), tp.tabulate(X, 1)
    for a in want:
        assert np.abs(got[a] - want[a]).max() <= ATOL_HOST


@pytest.mark.parametrize("split", ["alfeld", "alfeld2", "worsey-farin", "ps12"])
@pytest.mark.parametrize("dim", [0, 1])
def test_split_subcomplexes_match_fiat_tpu(split, dim):
    """construct_subcomplex of the splits (the facet complex the
    Bernardi-Raugel dual integrates on); a double Alfeld split reports the
    triangle as its parent and has 9 subcells."""
    def complex_(ma, cl):
        T = cl.ufc_simplex(2)
        if split == "worsey-farin":
            return ma.WorseyFarinSplit(T)
        if split == "ps12":
            return ma.PowellSabin12Split(T)
        A = ma.AlfeldSplit(T)
        return ma.AlfeldSplit(A) if split == "alfeld2" else A
    jc, tc = complex_(jma, jcl), complex_(tma, tcl)
    js, ts = jc.construct_subcomplex(dim), tc.construct_subcomplex(dim)
    assert type(ts).__name__ == type(js).__name__
    assert np.array_equal(np.asarray(ts.get_vertices()), np.asarray(js.get_vertices()))
    assert ts.get_topology() == js.get_topology()
    assert ts.is_macrocell() == js.is_macrocell() and tc.is_simplex() == jc.is_simplex()
    if split == "alfeld2":
        assert type(tc.get_parent()).__name__ == "UFCTriangle"
        assert len(tc.get_topology()[2]) == 9


# -- the two zoos through the engines ----------------------------------------------

ZOOS = {"stokes_elasticity_tri": 2, "stokes_elasticity_tet": 3}


def test_chip_smoke_zoo_lists_equal_the_sweep():
    for sd, specs in ((2, chip_smoke.STOKES_TRI), (3, chip_smoke.STOKES_TET)):
        cell = {2: "UFCTriangle", 3: "UFCTetrahedron"}[sd]
        derived = [(f, a[1] if len(a) > 1 else None, kw) for f, a, kw in SLICE_SPECS
                   if type(a[0]).__name__ == cell]
        assert list(specs) == derived
    assert [type(el).__name__ for el in chip_smoke.stokes_zoo(3)[-2:]] == [
        "NodalEnrichedElement", "Walkington"]
    assert "NodalEnriched-GN" in dict(COMPOSITES)


def _jzoo(sd):
    T = jcl.ufc_simplex(sd)
    zoo = [getattr(jfe, f)(T, *(() if d is None else (d,)), **kw)
           for f, d, kw in (chip_smoke.STOKES_TRI if sd == 2 else chip_smoke.STOKES_TET)]
    if sd == 3:
        zoo += [dict(COMPOSITES)["NodalEnriched-GN"](), jfe.Walkington(T)]
    return zoo


@pytest.fixture(scope="module")
def zoos():
    return {name: (sd, _jzoo(sd), chip_smoke.stokes_zoo(sd)) for name, sd in ZOOS.items()}


@pytest.mark.parametrize("zoo", sorted(ZOOS))
def test_zoo_shapes(zoos, zoo):
    """The widths and macro programs the kernels take from these zoos: the
    plain rows on K2, the macro rows over more than 32 subcells on K7 in
    the f64 engine."""
    sd, _, tzoo = zoos[zoo]
    tab = device_tabulator(tzoo, order=1, device="cpu")
    want = {2: ([6, 10, 15, 36, 55, 66], 982, 834, 558, 42, 9, 21),
            3: ([20, 35], 270, 4820, 728, 44, 9, 12)}[sd]
    k7 = merged_macro(tab)
    assert (tab.widths, tab.matmul.total_rows // len(tab.alphas), k7.rows, k7.K,
            len(k7.nexp), len(k7.geom), len(tzoo)) == want
    assert k7.name == "K7"


@pytest.mark.parametrize("zoo", sorted(ZOOS))
def test_f64_engine_matches_fiat_tpu_interpret_and_host(zoos, zoo):
    """device_tabulator(zoo, order=1) against fiat_tpu's interpreted
    FusedZooTabulator and host: 1e-10, AlfeldC2 1e-9 of max(1, max
    |table|)."""
    sd, jzoo, tzoo = zoos[zoo]
    pts = np.vstack([_points(300, sd, 17), _tie_points(sd)])
    bt = JBatchedTabulator(jzoo, order=1)
    jfz = JFusedZooTabulator(bt, interpret=True, row_block=256, point_tile=256)
    ref = bt.unpack(jfz(jnp.asarray(pts)))
    tab = device_tabulator(tzoo, order=1, device="cpu")
    got = tab.unpack(tab.block_tables(pts))
    assert (tab.recurrence.launches, tab.matmul.launches, merged_macro(tab).launches) == (0, 0, 0)
    for r, g, el in zip(ref, got, tzoo):
        host = el.tabulate(1, pts)
        for a in r:
            bar = _host_bar(el, host[a])
            assert np.abs(np.asarray(r[a]) - g[a].numpy()).max() <= bar, (type(el).__name__, a)
            assert np.abs(host[a] - g[a].numpy()).max() <= bar, (type(el).__name__, a)


@pytest.mark.parametrize("zoo", sorted(ZOOS))
def test_moments_and_interpolation_match_fiat_tpu(zoos, zoo):
    """moment_rows (K45) and interpolate_rows (K1 + K3 one row per
    program) against fiat_tpu's CPU path: plain elements to 1e-12, macro
    elements to what their table bar gives the sums (``dual_bars``)."""
    sd, jzoo, tzoo = zoos[zoo]
    pts = np.vstack([_points(300, sd, 18), _tie_points(sd)])
    rng = np.random.default_rng(19)
    wf = rng.random(len(pts))
    bt = JBatchedTabulator(jzoo, order=0)
    want = np.asarray(jmo.moment_rows(bt, jnp.asarray(pts), jnp.asarray(wf)))
    tb = BatchedTabulator(tzoo, order=0, device="cpu")
    got = tmo.moment_rows(tb, pts, wf)
    assert tuple(got.shape) == want.shape
    c = rng.random(len(want)) - 0.5
    wi = np.asarray(jmo.interpolate_rows(bt, jnp.asarray(pts), jnp.asarray(c)))
    u = tmo.interpolate_rows(tb, pts, c).numpy()
    mbar, ubar = dual_bars(tb, tzoo, pts, wf, c)
    assert (np.abs(got.numpy() - want) <= mbar).all()
    assert np.abs(u - wi).max() <= ubar
    eng = tb._moment_engine
    assert eng.moments.launches == eng.recurrence.launches == merged_macro(eng).launches == 0


@pytest.mark.parametrize("zoo", sorted(ZOOS))
def test_f32_engine_matches_fiat_tpu_pallas_interpret(zoos, zoo):
    """The f32 engine (K6, and K3 float32 past 32 subcells) against
    fiat_tpu's PallasZooTabulator in interpret mode: plain rows to 5e-6 of
    each alpha's max, each macro element's rows to 5e-5 of its max abs + 1,
    or to its own bar (chip_smoke.F32_OWN_BARS: AlfeldC2's change of basis
    cancels far below the float32 rounding of its sums)."""
    sd, jzoo, tzoo = zoos[zoo]
    pts = _points(300, sd, 20)
    want = PallasZooTabulator(JBatchedTabulator(jzoo, order=1), tile=256,
                              interpret=True).tables(pts)
    tab = device_tabulator(tzoo, order=1, f64=False, device="cpu")
    got = tab.tables(pts)
    mo = merged_macro(tab)
    assert (tab.kernel.launches, mo.launches) == (0, 0) and mo.name == "K3"
    pr = tab.plain_rows
    for a in want:
        w, g = np.asarray(want[a]), got[a].numpy()
        assert np.abs(g[:pr] - w[:pr]).max() <= RTOL_F32 * np.abs(w[:pr]).max(), a
        for el, (lo, hi, _) in zip(tzoo, tab.slices):
            if lo >= pr:
                tol = chip_smoke.F32_OWN_BARS.get(chip_smoke.element_label(el), MACRO_TOL)
                bar = tol * (np.abs(w[lo:hi]).max() + 1.0)
                assert np.abs(g[lo:hi] - w[lo:hi]).max() <= bar, (type(el).__name__, a)


@pytest.mark.parametrize("zoo", sorted(ZOOS))
def test_engines_from_fiat_tpu_arrays_match_the_ports(zoos, zoo):
    """The host state carried across: the port's engines rebuilt from
    fiat_tpu's BatchedTabulator arrays of the same zoo (its macro programs
    included) give the port's own tables, moments and interpolation."""
    sd, jzoo, tzoo = zoos[zoo]
    pts = _points(200, sd, 21)
    rng = np.random.default_rng(22)
    bt = JBatchedTabulator(jzoo, order=1, matmul="native")
    common = dict(stacked=bt.stacked, slices=bt.slices, max_degree=bt.max_degree,
                  scale=float(bt.target_es.get_scale(bt.max_degree)),
                  affine_map=bt.target_es.affine_mappings[0], macro_programs=bt.macro_programs,
                  device="cpu")
    fz = FusedZooTabulator.from_arrays(alpha_mats=bt.alpha_mats, plain_nexp=bt.plain_nexp,
                                       **common)
    want = device_tabulator(tzoo, order=1, device="cpu")(pts)
    for a, t in fz(pts).items():
        assert np.abs(t.numpy() - want[a].numpy()).max() <= RTOL_PLAIN * want[a].abs().max()
    f32 = F32ZooTabulator.from_arrays(alpha_mats=bt.alpha_mats, plain_nexp=bt.plain_nexp,
                                      **common).tables(pts)
    f32_mine = device_tabulator(tzoo, order=1, f64=False, device="cpu").tables(pts)
    for a in f32_mine:
        assert torch.equal(f32[a], f32_mine[a])
    bt0 = JBatchedTabulator(jzoo, order=0)
    meng = MomentEngine.from_arrays(**dict(common, stacked=bt0.stacked, slices=bt0.slices,
                                           macro_programs=bt0.macro_programs))
    teng = MomentEngine(BatchedTabulator(tzoo, order=0, device="cpu"), device="cpu")
    wf = rng.random(len(pts))
    m_want = teng.moment_rows(pts, wf).numpy()
    assert np.abs(meng.moment_rows(pts, wf).numpy() - m_want).max() \
        <= RTOL_PLAIN * np.abs(m_want).max()
    c = rng.random(teng.rows) - 0.5
    u_want = teng.interpolate_rows(pts, c).numpy()
    assert np.abs(meng.interpolate_rows(pts, c).numpy() - u_want).max() \
        <= RTOL_PLAIN * np.abs(u_want).max()
