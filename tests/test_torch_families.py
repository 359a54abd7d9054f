"""The nodal simplicial families of fiat_tpu's nodality sweep that need no
macro polynomial set, no pointwise dual and no tensor-product cell, on the
port against fiat_tpu: each element of the sweep's instance list
(tests/test_nodality_sweep.py, ``SPECS`` and ``COMPOSITES``) built by both
packages (coefficients, entity dofs and permutations, dual points and
weights, host tables), the core pieces they need (the line rules, the KMV
scheme, the symmetric and traceless tensor sets, bubbles, the two tensor
functionals), and the two zoos of chip_smoke.py (``families_tri``,
``families_tet``) through every engine of the port on the CPU (the
kernels' plain versions) against fiat_tpu's engines, its Pallas kernels in
interpret mode as its own tests run them (tests/test_device_ops.py).

Inputs are numpy arrays made from seeds and handed to both packages."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fiat_tpu import elements as jfe
from fiat_tpu.core import cells as jcl
from fiat_tpu.core import functionals as jfl
from fiat_tpu.core import polyset as jps
from fiat_tpu.core import quadrature as jq
from fiat_tpu.core import quadrature_schemes as jqs
from fiat_tpu.core import recursive_nodes as jrn
from fiat_tpu.core import variants as jva
from fiat_tpu.elements.kong_mulder_veldhuizen import kmv_quadrature as j_kmv_quadrature
from fiat_tpu.ops import moments as jmo
from fiat_tpu.ops.pallas_multiword import FusedZooTabulator as JFusedZooTabulator
from fiat_tpu.ops.pallas_tabulate import PallasZooTabulator
from fiat_tpu.ops.tabulate import BatchedTabulator as JBatchedTabulator
import fiat_tpu_torch as ft
from fiat_tpu_torch import device_tabulator
from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.core import functionals as tfl
from fiat_tpu_torch.core import polyset as tps
from fiat_tpu_torch.core import quadrature as tq
from fiat_tpu_torch.core import quadrature_schemes as tqs
from fiat_tpu_torch.core import recursive_nodes as trn
from fiat_tpu_torch.core import variants as tva
from fiat_tpu_torch.elements.kong_mulder_veldhuizen import kmv_quadrature as t_kmv_quadrature
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

ATOL_HOST = 1e-14       # host tables of one element, port vs fiat_tpu
ATOL_FIAT = 1e-10       # engine vs fiat_tpu's engines (fiat_tpu's own bar)
ATOL_DUAL = 1e-12       # moments and interpolation vs fiat_tpu's CPU path
RTOL_F32 = 5e-6         # fiat_tpu's f32 bar (tests/test_device_ops.py:143-144)
RTOL_PLAIN = 1e-13      # the same arithmetic on arrays carried across

#: the slice's families: every one the sweep builds that needs no macro
#: polynomial set, no pointwise dual and no tensor-product cell
FAMILIES = {"CrouzeixRaviart", "DiscontinuousTaylor", "DiscontinuousRaviartThomas",
            "NedelecSecondKind", "BrezziDouglasFortinMarini", "Regge",
            "HellanHerrmannJohnson", "GopalakrishnanLedererSchoberlFirstKind",
            "GopalakrishnanLedererSchoberlSecondKind", "GaussLegendre",
            "GaussLobattoLegendre", "Bubble", "FacetBubble", "KongMulderVeldhuizen"}
#: the sweep's composites that need nothing outside the slice
SLICE_COMPOSITES = [c for c in COMPOSITES if c[0] != "NodalEnriched-GN"]
CELLS = {"UFCInterval": 1, "UFCTriangle": 2, "UFCTetrahedron": 3}
SLICE_SPECS = [s for s in SPECS if s[0] in FAMILIES]


def _tcell(jcell):
    return tcl.ufc_simplex(CELLS[type(jcell).__name__])


def _build_port(spec):
    family, args, kw = spec
    return getattr(ft, family)(_tcell(args[0]), *args[1:], **kw)


def _build_fiat(spec):
    family, args, kw = spec
    return getattr(jfe, family)(*args, **kw)


def _points(n, sd, seed):
    """Uniform points in the UFC simplex (bench.py's pts2 / pts3 construction)."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, sd))
    return pts / (pts.sum(axis=1)[:, None] + 1e-9) * rng.random((n, 1))


def _permutations(el):
    try:
        return el.entity_permutations()
    except NotImplementedError:
        return "not implemented"


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
    X = _points(9, sd, 1) if sd > 1 else np.linspace(0.05, 0.95, 9)[:, None]
    want, got = jel.tabulate(1, X), tel.tabulate(1, X)
    assert set(got) == set(want)
    for a in want:
        assert np.abs(np.asarray(got[a]) - np.asarray(want[a])).max() <= ATOL_HOST, a


@pytest.mark.parametrize("spec", SLICE_SPECS, ids=map(_label, SLICE_SPECS))
def test_sweep_element_matches_fiat_tpu(spec):
    _same_element(_build_fiat(spec), _build_port(spec))


def _port_composite(name):
    T = {"I": tcl.ufc_simplex(1), "T": tcl.ufc_simplex(2), "S": tcl.ufc_simplex(3)}
    if name in ("RestrictedElement", "NodalEnriched-I"):
        cell = T["I"]
    elif name in ("NodalEnriched-S", "NodalEnriched-Regge"):
        cell = T["S"]
    else:
        cell = T["T"]
    if name == "RestrictedElement":
        return ft.RestrictedElement(ft.Lagrange(cell, 2), restriction_domain="facet")
    if name == "NodalEnriched-I":
        return ft.NodalEnrichedElement(ft.Lagrange(cell, 1), ft.Bubble(cell, 2))
    return chip_smoke.composite(name, cell)


@pytest.mark.parametrize("name,build", SLICE_COMPOSITES, ids=[c[0] for c in SLICE_COMPOSITES])
def test_sweep_composite_matches_fiat_tpu(name, build):
    _same_element(build(), _port_composite(name))


OTHERS = ([("GaussRadau", 1, d, {"right": r}) for d in range(4) for r in (True, False)]
          + [("Legendre", sd, d, {}) for sd in (1, 2, 3) for d in (0, 1, 3)]
          + [("IntegratedLegendre", sd, d, {}) for sd in (1, 2, 3) for d in (1, 2, 4)]
          + [("IntegratedLegendre", 2, 3, {"variant": "integral(1)"})])


@pytest.mark.parametrize("family,sd,degree,kw", OTHERS,
                         ids=[f"{f}-{sd}-{d}-{kw}" for f, sd, d, kw in OTHERS])
def test_other_new_classes_match_fiat_tpu(family, sd, degree, kw):
    """The classes the sweep reaches only inside others (IntegratedLegendre
    under the integral bubbles) or not at all."""
    _same_element(getattr(jfe, family)(jcl.ufc_simplex(sd), degree, **kw),
                  getattr(ft, family)(tcl.ufc_simplex(sd), degree, **kw))


@pytest.mark.parametrize("make", ["lagrange", "rt"])
def test_discontinuous_element_matches_fiat_tpu(make):
    def wrap(fe, T):
        inner = fe.Lagrange(T, 2) if make == "lagrange" else fe.RaviartThomas(T, 2)
        return fe.DiscontinuousElement(inner)
    jel, tel = wrap(jfe, jcl.ufc_simplex(2)), wrap(ft, tcl.ufc_simplex(2))
    assert tel.entity_dofs() == jel.entity_dofs()
    assert np.array_equal(np.asarray(tel.get_coeffs()), np.asarray(jel.get_coeffs()))
    X = _points(9, 2, 2)
    want, got = jel.tabulate(1, X), tel.tabulate(1, X)
    for a in want:
        assert np.abs(np.asarray(got[a]) - np.asarray(want[a])).max() <= ATOL_HOST
    assert tel.num_sub_elements() == 1 and tel.get_formdegree() == 2


# -- core pieces ---------------------------------------------------------------

def _same_rule(jr, tr):
    assert np.array_equal(tr.get_points(), jr.get_points())
    assert np.array_equal(tr.get_weights(), jr.get_weights())


LINE_RULES = ([("GaussLegendreQuadratureLineRule", m, {}) for m in (1, 2, 5, 12)]
              + [("GaussLobattoLegendreQuadratureLineRule", m, {}) for m in (2, 3, 6, 13)]
              + [("RadauQuadratureLineRule", m, {"right": r}) for m in (1, 2, 5, 9)
                 for r in (True, False)])


@pytest.mark.parametrize("rule,m,kw", LINE_RULES, ids=[f"{r}-{m}-{kw}" for r, m, kw in LINE_RULES])
def test_line_rules_match_fiat_tpu(rule, m, kw):
    _same_rule(getattr(jq, rule)(jcl.ufc_simplex(1), m, **kw),
               getattr(tq, rule)(tcl.ufc_simplex(1), m, **kw))


@pytest.mark.parametrize("m", [2, 3, 7])
@pytest.mark.parametrize("ab", [(0.0, 0.0), (1.0, 0.0), (2.0, 1.0)])
def test_gauss_lobatto_jacobi_rule_matches_fiat_tpu(m, ab):
    x, w = trn.gauss_lobatto_jacobi_rule(m, *ab)
    xr, wr = jrn.gauss_lobatto_jacobi_rule(m, *ab)
    assert np.array_equal(x, xr) and np.array_equal(w, wr)


KMV_RULES = ([(1, d) for d in (1, 2, 5)] + [(2, d) for d in range(1, 7)]
             + [(3, d) for d in (1, 2, 3)])


@pytest.mark.parametrize("sd,degree", KMV_RULES)
def test_kmv_scheme_matches_fiat_tpu(sd, degree):
    jc, tc = jcl.ufc_simplex(sd), tcl.ufc_simplex(sd)
    _same_rule(jqs.create_quadrature(jc, degree, scheme="KMV"),
               tqs.create_quadrature(tc, degree, scheme="KMV"))
    _same_rule(jva.parse_quadrature_scheme(jc, 1, f"KMV({degree})"),
               tva.parse_quadrature_scheme(tc, 1, f"KMV({degree})"))
    if sd > 1:
        _same_rule(j_kmv_quadrature(jc, degree), t_kmv_quadrature(tc, degree))


TENSOR_SETS = [(s, sd, d) for s in ("ONSymTensorPolynomialSet", "TracelessTensorPolynomialSet")
               for sd in (2, 3) for d in (0, 1, 3)]


@pytest.mark.parametrize("kind,sd,degree", TENSOR_SETS)
def test_tensor_polynomial_sets_match_fiat_tpu(kind, sd, degree):
    jp = getattr(jps, kind)(jcl.ufc_simplex(sd), degree)
    tp = getattr(tps, kind)(tcl.ufc_simplex(sd), degree)
    assert np.array_equal(tp.get_coeffs(), jp.get_coeffs())
    assert tp.get_shape() == jp.get_shape() == (sd, sd)
    X = _points(7, sd, 3)
    want, got = jp.tabulate(X, 1), tp.tabulate(X, 1)
    for a in want:
        assert np.abs(got[a] - want[a]).max() <= ATOL_HOST


BUBBLES = [(sd, d, codim, shape) for sd, d, codim, shape in
           [(1, 3, 0, ()), (2, 3, 0, ()), (2, 4, 1, ()), (2, 5, 0, (2,)), (3, 4, 0, ()),
            (3, 3, 1, ()), (3, 5, 0, (3,))]]


@pytest.mark.parametrize("sd,degree,codim,shape", BUBBLES)
def test_make_bubbles_matches_fiat_tpu(sd, degree, codim, shape):
    jb = jps.make_bubbles(jcl.ufc_simplex(sd), degree, codim=codim, shape=shape)
    tb = tps.make_bubbles(tcl.ufc_simplex(sd), degree, codim=codim, shape=shape)
    assert np.array_equal(tb.get_coeffs(), jb.get_coeffs())
    X = _points(7, sd, 4) if sd > 1 else np.linspace(0.1, 0.9, 7)[:, None]
    assert np.abs(tb.tabulate(X)[(0,) * sd] - jb.tabulate(X)[(0,) * sd]).max() <= ATOL_HOST


def test_project_and_form_matrix_product_match_fiat_tpu():
    f = lambda x: np.sin(x[0]) * np.exp(x[1])  # noqa: E731
    jT, tT = jcl.ufc_simplex(2), tcl.ufc_simplex(2)
    jU, tU = jps.ONPolynomialSet(jT, 3), tps.ONPolynomialSet(tT, 3)
    got = tps.project(f, tU, tqs.create_quadrature(tT, 8))
    want = jps.project(f, jU, jqs.create_quadrature(jT, 8))
    assert np.array_equal(got, want)
    mats = tU.get_dmats()
    for alpha in [(0, 0), (1, 0), (2, 1), (0, 3)]:
        assert np.array_equal(tps.form_matrix_product(mats, alpha),
                              jps.form_matrix_product(jU.get_dmats(), alpha))


@pytest.mark.parametrize("sd", [1, 2, 3])
def test_symmetric_simplex_and_cell_queries_match_fiat_tpu(sd):
    jc, tc = jcl.symmetric_simplex(sd), tcl.symmetric_simplex(sd)
    assert np.array_equal(np.asarray(tc.get_vertices()), np.asarray(jc.get_vertices()))
    assert type(tc.construct_subelement(sd - 1)).__name__ == "SymmetricSimplex"
    ju, tu = jcl.ufc_simplex(sd), tcl.ufc_simplex(sd)
    for dim in range(sd + 1):
        for e in ju.get_topology()[dim]:
            assert np.array_equal(tu.compute_face_edge_tangents(dim, e),
                                  ju.compute_face_edge_tangents(dim, e))
    pts = np.vstack([np.asarray(ju.get_vertices()), _points(20, sd, 5),
                     np.asarray(ju.make_points(sd, 0, sd + 2))])
    assert tu.point_entity_ids(pts) == ju.point_entity_ids(pts)
    assert tu <= tu and tu >= tu and not tu < tu and not tu > tu


def test_cell_order_follows_the_parent_chain():
    from fiat_tpu_torch.core.macro import AlfeldSplit
    T = tcl.ufc_simplex(2)
    A = AlfeldSplit(T)
    from fiat_tpu.core.macro import AlfeldSplit as JAlfeldSplit
    jT = jcl.ufc_simplex(2)
    jA = JAlfeldSplit(jT)
    pairs = [(A, T), (T, A), (A, A), (T, T)]
    jpairs = [(jA, jT), (jT, jA), (jA, jA), (jT, jT)]
    for (x, y), (jx, jy) in zip(pairs, jpairs):
        assert ((x >= y, x > y, x <= y, x < y, x == y, x != y)
                == (jx >= jy, jx > jy, jx <= jy, jx < jy, jx == jy, jx != jy))
    assert A > T and T < A


TENSOR_FUNCTIONALS = [(sd, kind) for sd in (2, 3) for kind in ("point", "moment")]


@pytest.mark.parametrize("sd,kind", TENSOR_FUNCTIONALS)
def test_tensor_functionals_pt_dicts_match_fiat_tpu(sd, kind):
    jc, tc = jcl.ufc_simplex(sd), tcl.ufc_simplex(sd)
    rng = np.random.default_rng(6 + sd)
    v, w = rng.random(sd) - 0.5, rng.random(sd) - 0.5
    if kind == "point":
        p = tuple(_points(1, sd, 7)[0])
        jn = jfl.PointwiseInnerProductEvaluation(jc, v, w, p)
        tn = tfl.PointwiseInnerProductEvaluation(tc, v, w, p)
    else:
        jQ, tQ = jqs.create_quadrature(jc, 3), tqs.create_quadrature(tc, 3)
        f = rng.random(len(tQ.get_weights()))
        jn = jfl.TensorBidirectionalIntegralMoment(jc, v, w, jQ, f)
        tn = tfl.TensorBidirectionalIntegralMoment(tc, v, w, tQ, f)
    assert tn.target_shape == jn.target_shape == (sd, sd)
    jd, td = jn.pt_dict, tn.pt_dict
    assert list(td) == list(jd)
    for pt in jd:
        assert [(float(a), c) for a, c in td[pt]] == [(float(a), c) for a, c in jd[pt]]
    for field in ("points", "weights", "pt_ids", "comps", "alphas"):
        assert np.array_equal(getattr(tn, field), getattr(jn, field))


SPLITS = [(fam, sd, deg) for fam, deg in
          [("CrouzeixRaviart", 1), ("NedelecSecondKind", 1), ("Regge", 0),
           ("HellanHerrmannJohnson", 0), ("GopalakrishnanLedererSchoberlSecondKind", 1),
           ("GopalakrishnanLedererSchoberlFirstKind", 1), ("BrezziDouglasFortinMarini", 2)]
          for sd in (2, 3) if not (fam == "BrezziDouglasFortinMarini" and sd == 3)]


@pytest.mark.parametrize("family,sd,degree", SPLITS)
@pytest.mark.parametrize("split", ["alfeld", "worsey-farin", "powell-sabin"])
def test_split_variants_raise_naming_macro_polynomial_set(family, sd, degree, split):
    """A split variant builds the element on the split complex through
    MacroPolynomialSet (BDFM through BDM), as fiat_tpu's does: bit for bit
    (tests/test_torch_split_variants.py covers every split and degree)."""
    variant = split if family == "CrouzeixRaviart" else f"integral,{split}"
    want = getattr(jfe, family)(jcl.ufc_simplex(sd), degree, variant=variant)
    got = getattr(ft, family)(tcl.ufc_simplex(sd), degree, variant=variant)
    assert got.is_macroelement() and want.is_macroelement()
    _same_element(want, got)


@pytest.mark.parametrize("family", ["GaussRadau", "GaussLegendre", "CrouzeixRaviart"])
def test_interval_elements_run_on_the_engines(family):
    """The engines take sd = 1 (K1, K2; K45 and K1 for moments and
    interpolation; K6 in float32): each element's tables, moments and
    interpolated values on the CPU (the kernels' plain versions) against
    host el.tabulate."""
    I = tcl.ufc_simplex(1)
    el = getattr(ft, family)(I, 1)
    pts = np.random.default_rng(23).random((40, 1))
    host = el.tabulate(1, pts)
    tab = device_tabulator([el], order=1, device="cpu")
    got, = tab.unpack(tab.block_tables(pts))
    assert tab.recurrence.sd == 1 and set(got) == set(host)
    for a in host:
        assert np.abs(got[a].numpy() - host[a]).max() <= ATOL_FIAT
    f32 = device_tabulator([el], order=1, f64=False, device="cpu").tables(pts)
    for a in host:
        assert np.abs(f32[a].numpy() - host[a]).max() <= RTOL_F32 * max(1.0, np.abs(host[a]).max())
    bt = BatchedTabulator([el], order=0, device="cpu")
    wf = np.random.default_rng(24).random(len(pts))
    assert np.abs(tmo.moment_rows(bt, pts, wf).numpy() - host[(0,)] @ wf).max() <= ATOL_DUAL
    c = np.random.default_rng(25).random(el.space_dimension()) - 0.5
    assert np.abs(tmo.interpolate_rows(bt, pts, c).numpy() - c @ host[(0,)]).max() <= ATOL_DUAL


# -- the two zoos through the engines ----------------------------------------------

ZOOS = {"families_tri": (2, chip_smoke.FAMILIES_TRI, chip_smoke.COMPOSITES_TRI),
        "families_tet": (3, chip_smoke.FAMILIES_TET, chip_smoke.COMPOSITES_TET)}
CELL_OF = {2: "UFCTriangle", 3: "UFCTetrahedron"}
COMPOSITE_CELL = {"RestrictedElement-vertex": 2, "RestrictedElement-facet": 2,
                  "NodalEnriched-T": 2, "NodalEnriched-RT": 2, "NodalEnriched-S": 3,
                  "NodalEnriched-Regge": 3}


@pytest.mark.parametrize("zoo", sorted(ZOOS))
def test_chip_smoke_zoo_lists_equal_the_sweep(zoo):
    sd, specs, comps = ZOOS[zoo]
    derived = [(f, a[1] if len(a) > 1 else None, kw.get("variant"))
               for f, a, kw in SLICE_SPECS if type(a[0]).__name__ == CELL_OF[sd]]
    assert list(specs) == derived
    sweep_names = [c[0] for c in COMPOSITES]
    assert list(comps) == [c for c in sweep_names if COMPOSITE_CELL.get(c) == sd]


def _zoos(zoo):
    sd, specs, comps = ZOOS[zoo]
    sweep = dict(COMPOSITES)
    jzoo = ([getattr(jfe, f)(jcl.ufc_simplex(sd), d, **({} if v is None else {"variant": v}))
             for f, d, v in specs] + [sweep[c]() for c in comps])
    tzoo = chip_smoke.families_zoo(specs, comps, tcl.ufc_simplex(sd))
    return sd, jzoo, tzoo


@pytest.fixture(scope="module")
def zoos():
    return {name: _zoos(name) for name in ZOOS}


@pytest.mark.parametrize("zoo", sorted(ZOOS))
def test_zoo_shapes(zoos, zoo):
    """The contraction widths the kernels take from these zoos: width 1
    (the degree-0 rows) and tensor-valued rows among them."""
    sd, _, tzoo = zoos[zoo]
    tab = device_tabulator(tzoo, order=1, device="cpu")
    want = {2: ([1, 3, 6, 10, 15, 21, 36, 45], 1325, 63),
            3: ([1, 4, 10, 20, 35], 6732, 47)}[sd]
    assert (tab.widths, tab.rows, len(tzoo)) == want
    assert any(len(el.value_shape()) == 2 for el in tzoo)


@pytest.mark.parametrize("zoo", sorted(ZOOS))
def test_f64_engine_matches_fiat_tpu_interpret_and_host(zoos, zoo):
    sd, jzoo, tzoo = zoos[zoo]
    pts = _points(300, sd, 17)
    bt = JBatchedTabulator(jzoo, order=1)
    jfz = JFusedZooTabulator(bt, interpret=True, row_block=256, point_tile=256)
    ref = bt.unpack(jfz(jnp.asarray(pts)))
    tab = device_tabulator(tzoo, order=1, device="cpu")
    got = tab.unpack(tab.block_tables(pts))
    assert (tab.recurrence.launches, tab.matmul.launches) == (0, 0)
    for r, g, el in zip(ref, got, tzoo):
        host = el.tabulate(1, pts)
        for a in r:
            assert np.abs(np.asarray(r[a]) - g[a].numpy()).max() <= ATOL_FIAT
            assert np.abs(host[a] - g[a].numpy()).max() <= ATOL_FIAT


@pytest.mark.parametrize("zoo", sorted(ZOOS))
def test_moments_and_interpolation_match_fiat_tpu(zoos, zoo):
    sd, jzoo, tzoo = zoos[zoo]
    pts = _points(300, sd, 18)
    rng = np.random.default_rng(19)
    wf = rng.random(len(pts))
    bt = JBatchedTabulator(jzoo, order=0)
    want = np.asarray(jmo.moment_rows(bt, jnp.asarray(pts), jnp.asarray(wf)))
    tb = BatchedTabulator(tzoo, order=0, device="cpu")
    got = tmo.moment_rows(tb, pts, wf)
    assert tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= ATOL_DUAL
    c = rng.random(len(want)) - 0.5
    wi = np.asarray(jmo.interpolate_rows(bt, jnp.asarray(pts), jnp.asarray(c)))
    assert np.abs(tmo.interpolate_rows(tb, pts, c).numpy() - wi).max() <= ATOL_DUAL
    eng = tb._moment_engine
    assert eng.moments.launches == eng.recurrence.launches == 0


@pytest.mark.parametrize("zoo", sorted(ZOOS))
def test_f32_engine_matches_fiat_tpu_pallas_interpret(zoos, zoo):
    sd, jzoo, tzoo = zoos[zoo]
    pts = _points(300, sd, 20)
    bt = JBatchedTabulator(jzoo, order=1)
    want = np.asarray(PallasZooTabulator(bt, tile=256, interpret=True)(pts))
    tab = device_tabulator(tzoo, order=1, f64=False, device="cpu")
    got = tab(pts).numpy()
    assert got.shape == want.shape and tab.kernel.launches == 0 and merged_macro(tab) is None
    rows = tab.rows
    for k, a in enumerate(tab.alphas):
        blk = slice(k * rows, (k + 1) * rows)
        assert np.abs(got[blk] - want[blk]).max() <= RTOL_F32 * np.abs(want[blk]).max(), a


@pytest.mark.parametrize("zoo", sorted(ZOOS))
def test_engines_from_fiat_tpu_arrays_match_the_ports(zoos, zoo):
    """The host state carried across: the port's engines rebuilt from
    fiat_tpu's BatchedTabulator arrays of the same zoo give the port's own
    tables, moments and interpolation."""
    sd, jzoo, tzoo = zoos[zoo]
    pts = _points(200, sd, 21)
    rng = np.random.default_rng(22)
    bt = JBatchedTabulator(jzoo, order=1, matmul="native")
    arrays = dict(stacked=bt.stacked, alpha_mats=bt.alpha_mats, slices=bt.slices,
                  plain_nexp=bt.plain_nexp, max_degree=bt.max_degree,
                  scale=float(bt.target_es.get_scale(bt.max_degree)),
                  affine_map=bt.target_es.affine_mappings[0])
    fz = FusedZooTabulator.from_arrays(**arrays, device="cpu")
    mine = device_tabulator(tzoo, order=1, device="cpu")
    want = mine(pts)
    for a, t in fz(pts).items():
        assert np.abs(t.numpy() - want[a].numpy()).max() <= RTOL_PLAIN * want[a].abs().max()
    f32 = F32ZooTabulator.from_arrays(**arrays, device="cpu").tables(pts)
    f32_mine = device_tabulator(tzoo, order=1, f64=False, device="cpu").tables(pts)
    for a in f32_mine:
        assert np.abs(f32[a].numpy() - f32_mine[a].numpy()).max() \
            <= 1e-6 * f32_mine[a].abs().max()
    meng = MomentEngine.from_arrays(**arrays, device="cpu")
    teng = MomentEngine(BatchedTabulator(tzoo, order=0, device="cpu"), device="cpu")
    wf = rng.random(len(pts))
    assert np.abs(meng.moment_rows(pts, wf).numpy()
                  - teng.moment_rows(pts, wf).numpy()).max() <= ATOL_DUAL
    c = rng.random(teng.rows) - 0.5
    assert np.abs(meng.interpolate_rows(pts, c).numpy()
                  - teng.interpolate_rows(pts, c).numpy()).max() <= ATOL_DUAL


# -- hex_gll_sumfact -------------------------------------------------------------

@pytest.mark.parametrize("degree,m", [(3, 5), (8, 10)])
def test_hex_gll_sumfact_matches_fiat_tpu_dense_hex_table(degree, m):
    """chip_smoke.py's sum-factorised moments (three einsums on torch
    tensors) and its dense reference, the port's hexahedral element
    (FlattenedDimensions of a TensorProductElement of its GLL element)
    tabulated at the tensor grid and contracted by one torch.matmul,
    against fiat_tpu's dense hexahedral table times the tensor-product
    weights; the two dense tables bit for bit."""
    from fiat_tpu.elements.tensor_product import FlattenedDimensions, TensorProductElement
    I, jI = tcl.ufc_simplex(1), jcl.ufc_simplex(1)
    gll, jgll = ft.GaussLobattoLegendre(I, degree), jfe.GaussLobattoLegendre(jI, degree)
    rule = tq.GaussJacobiQuadratureLineRule(I, m)
    jrule = jq.GaussJacobiQuadratureLineRule(jI, m)
    _same_rule(jrule, rule)
    x1, w1 = rule.get_points(), rule.get_weights()
    phi1 = np.asarray(gll.tabulate(0, x1)[(0,)])
    assert np.abs(phi1 - np.asarray(jgll.tabulate(0, x1)[(0,)])).max() <= ATOL_HOST
    F = np.random.default_rng(0).random((m, m, m))
    got = chip_smoke.gll_sumfact(torch.as_tensor(phi1 * w1), torch.as_tensor(F), torch).numpy()
    hexel = FlattenedDimensions(TensorProductElement(TensorProductElement(jgll, jgll), jgll))
    xg = x1.ravel()
    grid = np.stack(np.meshgrid(xg, xg, xg, indexing="ij"), axis=-1).reshape(-1, 3)
    w3f = (np.einsum("p,q,r->pqr", w1, w1, w1) * F).ravel()
    jdense = np.asarray(hexel.tabulate(0, grid)[(0, 0, 0)])
    want = (jdense @ w3f).reshape(got.shape)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= chip_smoke.HEX_RTOL * scale
    dense = chip_smoke.dense_hex_table(gll, x1, np)
    assert np.array_equal(dense, jdense)
    mine = torch.matmul(torch.as_tensor(dense), torch.as_tensor(w3f)).numpy().reshape(got.shape)
    assert np.abs(mine - want).max() <= chip_smoke.HEX_RTOL * scale
    assert np.abs(got - mine).max() <= chip_smoke.HEX_RTOL * scale
