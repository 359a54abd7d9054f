"""The interval on the port against fiat_tpu on the CPU: the split interval
elements (``LagrangeLineExpansionSet`` on a split complex: nodes binned per
subcell, a differentiation matrix and weights per subcell), Histopolation
and the six FDM classes bit for bit (coefficients, entity dofs and
permutations, dual terms) at every degree fiat_tpu builds, fiat_tpu's FDM
cases of ``tests/test_hierarchical_fdm.py`` run on the port, the interval
entries of the nodality sweep, and the engines at sd = 1 (K1, K3, K45 and
K6's plain versions) on ``1d_mix`` (``tests/test_engine_sweep.py``), a
small FDM / Histopolation zoo and a small split zoo against fiat_tpu's
``BatchedTabulator``, its interpreted ``FusedZooTabulator`` and
``PallasZooTabulator`` and its ``ops.moments``; numpy replays of the sd = 1
layouts (``pack_stages``, K3's slice tables, K45's schedule, K6's tiles)
against the plain versions.  On the card (marker ``cuda``, skipped without
one): each sd = 1 stage against its plain version and the entry points with
one launch of each kernel a pass.

Inputs are numpy arrays made from seeds and handed to both packages."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import fiat_tpu_torch as ft
from fiat_tpu_torch import device_tabulator
from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.core import expansions as texp
from fiat_tpu_torch.core.quadrature import make_quadrature
from fiat_tpu_torch.ops import moments as tmo
from fiat_tpu_torch.ops.bernstein import BernsteinFeatures
from fiat_tpu_torch.ops.f32_zoo import ZooF32Kernel
from fiat_tpu_torch.ops.fused_zoo import FusedZooTabulator, _merge_macro_programs
from fiat_tpu_torch.ops.macro_oneshot import MacroOneShot, one_shot_applies
from fiat_tpu_torch.ops.masked_matmul import MaskedMatmul
from fiat_tpu_torch.ops.moment_kernel import PairMoments
from fiat_tpu_torch.ops.recurrence import UNROLLED_DEGREE, DubinerRecurrence, pack_stages
from fiat_tpu_torch.ops.tabulate import BatchedTabulator

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))
import chip_smoke  # noqa: E402
from chip_smoke import merged_macro
from test_torch_iso_refined import _one_row_A  # noqa: E402

try:    # fiat_tpu and JAX, the CPU tests' oracle; the card's cases need neither
    import jax.numpy as jnp

    from fiat_tpu import elements as jfe
    from fiat_tpu.core import cells as jcl
    from fiat_tpu.core.expansions import ExpansionSet as JExpansionSet
    from fiat_tpu.ops import moments as jmo
    from fiat_tpu.ops.pallas_multiword import FusedZooTabulator as JFusedZooTabulator
    from fiat_tpu.ops.pallas_tabulate import PallasZooTabulator
    from fiat_tpu.ops.tabulate import BatchedTabulator as JBatchedTabulator
    from test_nodality_sweep import SPECS, _label
    from test_torch_f32_zoo import _replay_check
    from test_torch_families import _same_element
    from test_torch_k3_tri import _replay_k3
    from test_torch_recurrence import _dubiner1_point
    from test_torch_tet_dual import K45_GRIDS, _replay_k45
except ImportError:
    jfe = None
    SPECS, K45_GRIDS = [], {"one_block": None}

RTOL_TABLES = 1e-11     # f64 tables vs fiat_tpu's engine, of max(1, max |table|)
ATOL_DUAL = 1e-12       # moments and interpolation vs fiat_tpu's CPU path
ATOL_HOST = 1e-10       # f64 tables vs host (the BASELINE.json metric)
RTOL_F32 = 5e-6         # f32 engine vs fiat_tpu's f32 engine (tests/test_device_ops.py:143)
MACRO_TOL = 5e-5        # its macro bar, relative to max abs + 1 (:586-589)
RTOL_PLAIN = 1e-13      # a replay or a kernel vs the plain version
RTOL_F32_KERNEL = 1e-5  # a float32 kernel vs its plain version

#: the split interval elements fiat_tpu builds and the port used to refuse
#: (IndexError in the old single-interval LagrangeLineExpansionSet), with
#: the GLL / GL variants that take a split suffix
SPLIT = [("Lagrange", 2, "iso(2)"), ("Lagrange", 2, "iso(4)"), ("Lagrange", 2, "alfeld"),
         ("DiscontinuousLagrange", 2, "iso(2)"), ("Lagrange", 3, "iso(3)"),
         ("Lagrange", 1, "iso(64)"), ("Lagrange", 6, "alfeld"),
         ("DiscontinuousLagrange", 3, "iso(4)"), ("DiscontinuousLagrange", 3, "alfeld"),
         ("DiscontinuousLagrange", 0, "iso(2)"), ("Lagrange", 3, "gll,iso(2)"),
         ("Lagrange", 3, "iso(2),gll"), ("DiscontinuousLagrange", 3, "gl,alfeld")]
#: every degree fiat_tpu builds (FDMHermite: degree 3 alone, fiat_tpu's limit)
HOST_FAMILIES = ([("Histopolation", d) for d in range(16)]
                 + [(f, d) for f in ("FDMLagrange", "FDMQuadrature", "FDMBrokenH1")
                    for d in range(1, 16)]
                 + [(f, d) for f in ("FDMDiscontinuousLagrange", "FDMBrokenL2")
                    for d in range(16)]
                 + [("FDMHermite", 3)])
#: the nodality sweep's interval entries (tests/test_nodality_sweep.py)
INTERVAL_SPECS = [s for s in SPECS if type(s[1][0]).__name__ == "UFCInterval"]

ZOOS = {
    "1d_mix": [("Lagrange", 1, None), ("GaussLobattoLegendre", 4, None), ("Legendre", 3, None),
               ("CubicHermite", None, None)],
    "fdm": [("FDMLagrange", 3, None), ("FDMQuadrature", 4, None), ("FDMBrokenH1", 2, None),
            ("FDMDiscontinuousLagrange", 3, None), ("FDMBrokenL2", 0, None),
            ("FDMBrokenL2", 4, None), ("FDMHermite", 3, None), ("Histopolation", 2, None),
            ("Histopolation", 0, None)],
    "split": [("Lagrange", 3, None), ("Lagrange", 1, "iso(2)"), ("Lagrange", 1, "iso(64)"),
              ("Lagrange", 3, "iso(4)"), ("DiscontinuousLagrange", 3, "alfeld"),
              ("Lagrange", 6, "alfeld")],
}


def _build(fe, I, family, degree, variant=None):
    return getattr(fe, family)(I, *(() if degree is None else (degree,)),
                               **({} if variant is None else {"variant": variant}))


def _zoo(fe, name):
    I = (tcl if fe is ft else jcl).ufc_simplex(1)
    return [_build(fe, I, *spec) for spec in ZOOS[name]]


def _points(n, seed):
    return np.random.default_rng(seed).random((n, 1))


def _tie_points(zoo):
    """The split elements' subcell vertices: every interior one is shared by
    two subcells (averaged at order 1, first hit at order 0)."""
    out = [np.asarray(el.get_nodal_basis().get_reference_element().get_vertices())
           for el in zoo if el.is_macroelement()]
    return np.vstack(out) if out else np.zeros((0, 1))


def _scaled(got, want):
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


# -- host construction -----------------------------------------------------------

@pytest.mark.parametrize("spec", SPLIT, ids=lambda s: f"{s[0]}-{s[1]}-{s[2]}")
def test_split_interval_elements_match_fiat_tpu(spec):
    """The split complexes' nodal bases: every case builds on the port as
    fiat_tpu builds it, bit for bit, and is a macro element."""
    want = _build(jfe, jcl.ufc_simplex(1), *spec)
    got = _build(ft, tcl.ufc_simplex(1), *spec)
    assert got.is_macroelement() and want.is_macroelement()
    _same_element(want, got)


def test_split_line_expansion_set_bins_nodes_per_subcell():
    """Lagrange 2 on iso(2): five nodes, three a subcell sharing the middle
    one (C0), a differentiation matrix per subcell that differentiates its
    quadratics exactly; DG 2 on iso(2) shares none (continuity None)."""
    I = tcl.ufc_simplex(1)
    es = ft.Lagrange(I, 2, variant="iso(2)").get_nodal_basis().get_expansion_set()
    jes = jfe.Lagrange(jcl.ufc_simplex(1), 2, variant="iso(2)").get_nodal_basis() \
        .get_expansion_set()
    assert es.continuity == jes.continuity == "C0" and es.degree == 2
    assert {c: list(v) for c, v in es.get_cell_node_map(2).items()} == \
        {c: list(v) for c, v in jes.get_cell_node_map(2).items()}
    for c in (0, 1):
        x = es.nodes[c]
        D = es.get_dmats(2, cell=c)[0]        # nodal values -> derivative values
        assert np.abs(D @ x ** 2 - 2 * x).max() <= 1e-12
        assert np.array_equal(es.get_dmats(2, cell=c)[0], jes.get_dmats(2, cell=c)[0])
    dg = ft.DiscontinuousLagrange(I, 2, variant="iso(2)").get_nodal_basis().get_expansion_set()
    assert dg.continuity is None


@pytest.mark.parametrize("family,degree", HOST_FAMILIES, ids=lambda v: str(v))
def test_histopolation_and_fdm_match_fiat_tpu(family, degree):
    """Bit for bit, eigenvector signs included (``_canonical_signs`` after
    fiat_tpu's combined solve)."""
    _same_element(_build(jfe, jcl.ufc_simplex(1), family, degree),
                  _build(ft, tcl.ufc_simplex(1), family, degree))


@pytest.mark.parametrize("degree", [4, 5])
def test_fdm_hermite_past_degree_3_raises_as_fiat_tpu(degree):
    """fiat_tpu's own limit: its biharmonic eigenproblem is singular from
    degree 4; the port reproduces it."""
    with pytest.raises(np.linalg.LinAlgError, match="Singular"):
        jfe.FDMHermite(jcl.ufc_simplex(1), degree)
    with pytest.raises(np.linalg.LinAlgError, match="Singular"):
        ft.FDMHermite(tcl.ufc_simplex(1), degree)


def test_fdm_degree0_and_refusals():
    """The DG FDM families at degree 0 are P0, the CG ones refuse it, and
    every FDM family and Histopolation refuse a cell other than the interval,
    as fiat_tpu's do."""
    I, T = tcl.ufc_simplex(1), tcl.ufc_simplex(2)
    assert type(ft.FDMDiscontinuousLagrange(I, 0)).__name__ == "P0"
    assert type(ft.FDMBrokenL2(I, 0)).__name__ == "P0"
    with pytest.raises(ValueError):
        ft.FDMLagrange(I, 0)
    for fam in ("FDMLagrange", "FDMBrokenH1", "Histopolation"):
        with pytest.raises(ValueError, match="one dimension|only defined in 1D"):
            getattr(ft, fam)(T, 2)


def _nnz(A):
    return A.size - np.sum(np.isclose(A, 0.0, rtol=1e-14))


def _moments(v, u, q):
    return np.dot(np.asarray(v) * np.asarray(q.get_weights()), np.asarray(u).T)


FDM = {"CG": "FDMLagrange", "DG": "FDMDiscontinuousLagrange", "BrokenH1": "FDMBrokenH1",
       "BrokenL2": "FDMBrokenL2", "Quadrature": "FDMQuadrature"}


@pytest.mark.parametrize("family", sorted(FDM))
@pytest.mark.parametrize("deg", (1, 3, 6))
def test_fdm_interpolation_exactness(family, deg):
    """fiat_tpu's case (tests/test_hierarchical_fdm.py) on the port."""
    degree = deg - 1 if family in ("DG", "BrokenL2") else deg
    s = tcl.ufc_simplex(1)
    q = make_quadrature(s, degree + 1)
    el = getattr(ft, FDM[family])(s, degree)
    tab = np.asarray(el.tabulate(0, q.get_points())[(0,)])
    qpts, qwts = np.asarray(q.get_points()), np.asarray(q.get_weights())
    for test_degree in range(degree + 1):
        coefs = [float(n(lambda x: x[0] ** test_degree)) for n in el.get_dual_set().get_nodes()]
        integral = np.dot(coefs, tab @ qwts)
        assert np.allclose(integral, np.dot(qpts[:, 0] ** test_degree, qwts), rtol=1e-13)


@pytest.mark.parametrize("family", sorted(FDM))
@pytest.mark.parametrize("deg", (1, 2, 3, 4, 5, 6))
def test_fdm_sparsity(family, deg):
    """fiat_tpu's case on the port: the mass and stiffness moment matrices
    of the FDM bases have the documented sparsity."""
    degree = deg - 1 if family in ("DG", "BrokenL2") else deg
    s = tcl.ufc_simplex(1)
    q = make_quadrature(s, degree + 1)
    el = getattr(ft, FDM[family])(s, degree)
    expected = {"CG": [degree + 3, 5 * degree - 1], "DG": [degree + 1],
                "BrokenH1": [degree + 1, degree], "BrokenL2": [degree + 1],
                "Quadrature": [degree + 1, 3 * degree - 1 - (degree == 1)]}[family]
    tab = el.tabulate(len(expected) - 1, q.get_points())
    for k, ennz in enumerate(expected):
        assert _nnz(_moments(tab[(k,)], tab[(k,)], q)) == ennz, (k, ennz)


@pytest.mark.parametrize("spec", INTERVAL_SPECS, ids=map(_label, INTERVAL_SPECS)
                         if INTERVAL_SPECS else None)
def test_nodality_sweep_interval_entries(spec):
    """Every interval entry of fiat_tpu's sweep: the port's element equals
    fiat_tpu's bit for bit and is nodal (ell_i(phi_j) = delta_ij)."""
    family, args, kw = spec
    got = getattr(ft, family)(tcl.ufc_simplex(1), *args[1:], **kw)
    _same_element(getattr(jfe, family)(*args, **kw), got)
    poly, dual = got.get_nodal_basis(), got.get_dual_set()
    c = np.asarray(poly.get_coeffs())
    n = c.shape[0]
    G = np.asarray(dual.to_riesz(poly)).reshape(n, -1) @ c.reshape(n, -1).T
    assert np.allclose(G, np.eye(n), atol=5e-10)


def test_package_exports_the_interval_families():
    from fiat_tpu_torch import elements
    for name in ("Histopolation", "FDMLagrange", "FDMDiscontinuousLagrange", "FDMQuadrature",
                 "FDMBrokenH1", "FDMBrokenL2", "FDMHermite"):
        assert getattr(ft, name) is getattr(elements, name)


# -- K1's sd = 1 stage -----------------------------------------------------------

@pytest.mark.parametrize("degree", range(0, 16))
def test_plain_interval_recurrence_matches_fiat_tpu(degree):
    pts = _points(300, degree)
    want = np.asarray(JExpansionSet(jcl.ufc_simplex(1)).tabulate(degree, pts))
    es = texp.ExpansionSet(tcl.ufc_simplex(1))
    rec = DubinerRecurrence(1, degree, es.get_scale(degree), es.affine_mappings[0],
                            device="cpu")
    got = rec(torch.as_tensor(pts))
    assert tuple(got.shape) == want.shape == (degree + 1, 300)
    assert np.abs(got.numpy() - want).max() <= RTOL_PLAIN * np.abs(want).max()
    assert rec.launches == 0 and UNROLLED_DEGREE[1] == 15


@pytest.mark.parametrize("variant", [None, "bubble", "dual"])
@pytest.mark.parametrize("degree", [0, 1, 2, 7, 15])
def test_packed_sd1_constants_run_the_recurrence(variant, degree):
    """csrc/dubiner1.cuh's loop on pack_stages(sd=1)'s constants is
    dubiner_tabulate's raw recurrence, for every variant; the members are
    the levels (slots the identity)."""
    consts, slots = pack_stages(degree, variant, sd=1)
    assert consts.shape == (4 * (degree + 1),) and slots.tolist() == list(range(degree + 1))
    x = _points(200, degree)[:, 0] * 2.0 - 1.0
    got = _dubiner1_point(x, consts, degree, 1.25)
    want = texp.dubiner_tabulate(1, degree, [x], 1.25, variant=variant, raw=True)
    assert np.abs(got - want).max() <= RTOL_PLAIN * np.abs(want).max()


# -- the engines on the interval ---------------------------------------------------

@pytest.fixture(scope="module")
def zoos():
    return {name: (_zoo(jfe, name), _zoo(ft, name)) for name in ZOOS}


def _f64_points(name, zoo, seed):
    return np.vstack([_points(200, seed), _tie_points(zoo)])


@pytest.mark.parametrize("name", sorted(ZOOS))
def test_f64_engine_matches_fiat_tpu_engines_and_host(zoos, name):
    """The f64 engine's plain path (K1, K2, and K3 for the split elements:
    the interval's macro programs take K3, whatever their subcells) against
    fiat_tpu's ``BatchedTabulator`` and interpreted ``FusedZooTabulator``
    (as tests/test_engine_sweep.py runs them), at RTOL_TABLES of max(1, max
    |table|) plus fiat_tpu's own distance from host; against host at 1e-10
    of it."""
    jzoo, tzoo = zoos[name]
    pts = _f64_points(name, tzoo, 31)
    bt = JBatchedTabulator(jzoo, order=1)
    batched = bt.unpack({a: np.asarray(v) for a, v in bt(jnp.asarray(pts)).items()})
    jfz = JFusedZooTabulator(bt, interpret=True, row_block=256, point_tile=128)
    fused = jfz.unpack({a: [np.asarray(x) for x in v]
                        for a, v in jfz.block_tables(jnp.asarray(pts)).items()})
    tab = device_tabulator(tzoo, order=1, device="cpu")
    got = tab.unpack(tab.block_tables(pts))
    if any(el.is_macroelement() for el in tzoo):
        assert merged_macro(tab).name == "K3" and merged_macro(tab).sd == 1
    for el, b, f, g in zip(tzoo, batched, fused, got):
        host = el.tabulate(1, pts)
        for a, h in host.items():
            mine = g[a].numpy().reshape(h.shape)
            for ref in (np.asarray(b[a]).reshape(h.shape), np.asarray(f[a]).reshape(h.shape)):
                assert _scaled(mine, ref) <= RTOL_TABLES + _scaled(ref, h), (name, el, a)
            assert _scaled(mine, h) <= chip_smoke.INTERVAL_HOST_RTOL, (name, el, a)


@pytest.mark.parametrize("name", sorted(ZOOS))
def test_moments_and_interpolation_match_fiat_tpu(zoos, name):
    """``moment_rows`` (K45's plain version at sd = 1) and
    ``interpolate_rows`` (K1, and K3 one row a program) against fiat_tpu's
    ``ops.moments`` on the CPU: to ATOL_DUAL, but the split elements' rows
    to ATOL_HOST times the sum of |wf| (and their share of the interpolated
    values to it times the sum of |c| over their rows), as
    tests/test_torch_many_subcells.py's DUAL_WIDE elements: the port's dual
    route goes through the parent-basis collocation, as fiat_tpu's device
    route does, while fiat_tpu's CPU path tabulates the split basis
    (Lagrange 6 on Alfeld reads 2.7e-10 on 202 points)."""
    jzoo, tzoo = zoos[name]
    pts = _f64_points(name, tzoo, 32)
    rng = np.random.default_rng(33)
    wf = rng.random(len(pts))
    bt = JBatchedTabulator(jzoo, order=0)
    want = np.asarray(jmo.moment_rows(bt, jnp.asarray(pts), jnp.asarray(wf)))
    tb = BatchedTabulator(tzoo, order=0, device="cpu")
    got = tmo.moment_rows(tb, pts, wf).numpy()
    assert got.shape == want.shape
    c = rng.random(len(want)) - 0.5
    bar, u_bar = np.full(len(want), ATOL_DUAL), ATOL_DUAL
    for el, (lo, hi, _) in zip(tzoo, tb.slices):
        if el.is_macroelement():
            bar[lo:hi] = ATOL_HOST * np.abs(wf).sum()
            u_bar += ATOL_HOST * np.abs(c[lo:hi]).sum()
    assert (np.abs(got - want) <= bar).all()
    wi = np.asarray(jmo.interpolate_rows(bt, jnp.asarray(pts), jnp.asarray(c)))
    assert np.abs(tmo.interpolate_rows(tb, pts, c).numpy() - wi).max() <= u_bar
    eng = tb._moment_engine
    assert eng.moments.sd == 1 and eng.moments.launches == eng.recurrence.launches == 0


@pytest.mark.parametrize("name", sorted(ZOOS))
def test_f32_engine_matches_fiat_tpu_pallas_interpret(zoos, name):
    """The f32 engine (K6 at sd = 1, K3 float32) against fiat_tpu's
    ``PallasZooTabulator`` in interpret mode: plain rows to RTOL_F32 of each
    alpha's max, macro rows to MACRO_TOL of max abs + 1 (chip_smoke.py's
    INTERVAL_F32_BARS for the elements whose float32 rows cancel below
    their rounding: Lagrange 6 on Alfeld reads 9.5e-5 against fiat_tpu),
    both binnings alike (neither is given a tie point)."""
    jzoo, tzoo = zoos[name]
    pts = _points(300, 34)
    bt = JBatchedTabulator(jzoo, order=1)
    want = PallasZooTabulator(bt, tile=256, interpret=True).tables(pts)
    tab = device_tabulator(tzoo, order=1, f64=False, device="cpu")
    got = tab.tables(pts)
    assert tab.kernel.sd == 1 and tab.kernel.launches == 0
    pr = tab.plain_rows
    for a in got:
        w = np.asarray(want[a])
        g = got[a].numpy()
        assert np.abs(g[:pr] - w[:pr]).max() <= RTOL_F32 * np.abs(w[:pr]).max(), a
        for el, (lo, hi, _) in zip(tzoo, tab.slices):
            if lo >= pr:
                bar = chip_smoke.INTERVAL_F32_BARS.get(chip_smoke.split_label(el), MACRO_TOL)
                assert np.abs(g[lo:hi] - w[lo:hi]).max() <= bar * (
                    np.abs(w[lo:hi]).max() + 1), (el, a)


def test_chip_smoke_interval_zoo_builds_and_routes():
    """chip_smoke.py's phase 20 zoo: 220 elements and 1937 rows, every
    macro program on K3 (82 subcells in 6 programs, iso(64)'s 64 in one,
    two mask words), K2's widths 1 to 16, K1 and K45 at degree 15; its
    Bernstein sub-zoo of one width on K8."""
    I = tcl.ufc_simplex(1)
    zoo = chip_smoke.families_zoo(chip_smoke.INTERVAL_ZOO, (), I)
    tab = device_tabulator(zoo, order=1, device="cpu")
    assert (len(zoo), tab.rows, tab.widths) == (220, 1937, list(range(1, 17)))
    assert (tab.recurrence.sd, tab.recurrence.degree) == (1, 15)
    mo = merged_macro(tab)
    assert (mo.name, len(mo.nexp), len(mo.geom), mo.words) == ("K3", 82, 6, 2)
    bern = FusedZooTabulator(BatchedTabulator(chip_smoke.families_zoo(
        chip_smoke.INTERVAL_BERNSTEIN, (), I), order=1, device="cpu"), device="cpu",
        features="bernstein")
    assert bern.recurrence is None and (bern.features.sd, bern.features.degree) == (1, 15)
    pts = chip_smoke.make_points(5, 42, np, sd=1)
    assert np.array_equal(pts, np.random.default_rng(42).random((5, 1)))


def test_k7_refuses_the_interval_by_name(zoos):
    """Nothing on the interval goes to K7: ``one_shot_applies`` takes every
    interval program set, and K7 itself raises naming K3."""
    _, tzoo = zoos["split"]
    st = BatchedTabulator(tzoo, order=1, device="cpu").state()
    merged = _merge_macro_programs(st["macro_programs"], st["scale"], st["affine_map"], 1)
    assert one_shot_applies(merged)
    with pytest.raises(NotImplementedError, match="take K3"):
        MaskedMatmul(merged["A"], merged["pieces"], merged["geom"], merged["parent_map"],
                     device="cpu")


# -- replays of the sd = 1 layouts ----------------------------------------------------

def _k3(tzoo, order, dtype=torch.float64, device="cpu"):
    st = BatchedTabulator(tzoo, order=order, device="cpu").state()
    merged = _merge_macro_programs(st["macro_programs"], st["scale"], st["affine_map"], order)
    return MacroOneShot(**merged, device=device, dtype=dtype)


@pytest.mark.parametrize("order", [0, 1])
def test_k3_sd1_loop_on_its_tables_matches_plain(zoos, order):
    """K3's loop replayed in numpy on its sd = 1 slice tables (binning at
    SD = 1, the interval recurrence, two mask words for iso(64)), tables and
    one row a program, against its plain version, on random and tie points
    under the unique rule (order 0) and the averaged one."""
    _, tzoo = zoos["split"]
    mo = _k3(tzoo, order)
    pts = np.vstack([_points(300, 35), _tie_points(tzoo)])
    want = mo.plain(torch.as_tensor(pts)).numpy()
    got = _replay_k3(mo, pts)
    scale = np.abs(mo.A.numpy()) @ np.abs(mo.operand(torch.as_tensor(pts))[0].numpy())
    assert np.all(np.abs(got - want) <= RTOL_PLAIN * scale.max(axis=1, keepdims=True))
    W = _one_row_A(mo, 36)
    got = _replay_k3(mo, pts, A=W.numpy())
    want = mo.plain(torch.as_tensor(pts), A=W).numpy()
    assert np.abs(got - want).max() <= RTOL_PLAIN * np.abs(want).max()


@pytest.mark.parametrize("grid", sorted(K45_GRIDS))
def test_k45_sd1_schedule_on_its_tables_matches_plain(zoos, grid):
    """K45's schedule replayed in numpy on its sd = 1 tables (plain sums of
    degree 3 and the masked sums of every subcell) against its plain
    version, on random and tie points."""
    _, tzoo = zoos["split"]
    pm = tmo.MomentEngine(BatchedTabulator(tzoo, order=0, device="cpu"), device="cpu").moments
    assert pm.sd == 1
    pts = np.vstack([_points(500, 37), _tie_points(tzoo)])
    wf = np.random.default_rng(38).random(len(pts)) - 0.5
    nblocks, warps = K45_GRIDS[grid](len(pts), pm)
    got = _replay_k45(pm, pts, wf, nblocks, warps)
    want = pm.plain(torch.as_tensor(pts), torch.as_tensor(wf)).numpy()
    assert np.abs(got - want).max() <= RTOL_PLAIN * np.abs(want).max()


@pytest.mark.parametrize("degree,shapes", [(15, ((70, 16), (9, 3), (200, 1))),
                                           (3, ((130, 4),)), (0, ((5, 1),))])
@pytest.mark.parametrize("npts", [1, 300, 517])
def test_k6_sd1_schedule_matches_plain(degree, shapes, npts):
    """K6's schedule replayed on its sd = 1 tile table and ring (the Phi
    tile from the interval recurrence, widths 1 to 16) against its plain
    product."""
    rng = np.random.default_rng(npts + degree)
    es = texp.ExpansionSet(tcl.ufc_simplex(1))
    k6 = ZooF32Kernel([rng.standard_normal(s) for s in shapes], degree,
                      float(es.get_scale(degree)), es.affine_mappings[0], device="cpu")
    assert k6.sd == 1 and k6.plan is not None
    phi = k6.phi(torch.as_tensor(_points(npts, 39), dtype=torch.float32)).numpy()
    _replay_check(k6, phi, seed=npts)


def test_wrappers_take_sd1_and_refuse_past_their_degrees():
    """K1, K6 and K45 take degree 16 on the interval, past their unrolled
    15 (their generic instantiations): K1's plain version matches
    fiat_tpu's recurrence, K6's plan and its plain product and K45's plain
    sums are the plain tables'; K8 keeps its own 15 and refuses past it."""
    es = texp.ExpansionSet(tcl.ufc_simplex(1))
    amap = es.affine_mappings[0]
    pts = _points(40, 16)
    rec = DubinerRecurrence(1, 16, float(es.get_scale(16)), amap, device="cpu")
    phi = rec(torch.as_tensor(pts))
    want = np.asarray(JExpansionSet(jcl.ufc_simplex(1))._tabulate_on_cell(16, pts)[(0,)])
    assert rec.generic and np.abs(phi.numpy() - want).max() <= 1e-13 * np.abs(want).max()
    A = np.random.default_rng(16).standard_normal((5, 17))
    k6 = ZooF32Kernel([A], 16, float(es.get_scale(16)), amap, device="cpu")
    out = torch.zeros((5, 40), dtype=torch.float32)
    k6(torch.as_tensor(pts, dtype=torch.float32), torch.arange(5, dtype=torch.int32), out)
    assert k6.generic and k6.plan is not None
    assert np.abs(out.numpy() - A @ want).max() <= RTOL_F32_KERNEL * np.abs(A @ want).max()
    wf = np.random.default_rng(17).random(40)
    pm = PairMoments(16, 17, float(es.get_scale(16)), amap, device="cpu")
    got = pm(torch.as_tensor(pts), torch.as_tensor(wf)).numpy()
    assert pm.generic and np.abs(got - want @ wf).max() <= 1e-13 * np.abs(want @ wf).max()
    assert PairMoments(15, 16, 1.0, amap, device="cpu").nexp == 16
    bary = (np.array([[-1.0], [1.0]]), np.array([1.0, 0.0]))
    assert BernsteinFeatures(1, 15, bary, device="cpu").nexp == 16
    assert BernsteinFeatures(1, 26, bary, device="cpu").generic
    with pytest.raises(NotImplementedError, match="outside 0..26 for sd = 1"):
        BernsteinFeatures(1, 27, bary, device="cpu")


# -- on the card ------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _card_points(cuda, zoo, n=30_001):
    return torch.as_tensor(np.vstack([_points(n, 40), _tie_points(zoo)]), device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("degree", [0, 1, 7, 15])
def test_k1_sd1_on_card_matches_plain(degree, cuda):
    es = texp.ExpansionSet(tcl.ufc_simplex(1))
    rec = DubinerRecurrence(1, degree, es.get_scale(degree), es.affine_mappings[0],
                            device=cuda)
    P = torch.as_tensor(_points(100_003, degree), device=cuda)
    got, want = rec(P), rec.plain(P)
    torch.cuda.synchronize()
    assert rec.launches == 1
    assert (got - want).abs().max().item() <= RTOL_PLAIN * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("order", [0, 1])
def test_k3_sd1_on_card_matches_plain(order, dtype, cuda):
    """K3's sd = 1 stage, tables and one row a program, against its plain
    version of each row's own max |A_r| |B|, one launch each."""
    tzoo = _zoo(ft, "split")
    mo = _k3(tzoo, order, dtype, cuda)
    P = _card_points(cuda, tzoo).to(dtype)
    rtol = RTOL_PLAIN if dtype == torch.float64 else RTOL_F32_KERNEL
    got, want = mo(P), mo.plain(P)
    torch.cuda.synchronize()
    assert mo.launches == 1 and mo.words == 2
    scale = (mo.A.abs().double() @ mo.operand(P)[0].abs().double()).amax(dim=1, keepdim=True)
    assert bool(((got - want).abs() <= rtol * scale).all())
    W = _one_row_A(mo, 41)
    got, want = mo(P, A=W), mo.plain(P, A=W)
    torch.cuda.synchronize()
    assert mo.launches == 2
    scale = (W.abs().double() @ mo.operand(P)[0].abs().double()).amax(dim=1, keepdim=True)
    assert bool(((got - want).abs() <= rtol * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["1d_mix", "split"])
def test_k45_sd1_on_card_matches_plain(name, cuda):
    """K45 at sd = 1 against its plain version (1e-13 relative), one launch,
    two calls bit for bit."""
    tzoo = _zoo(ft, name)
    pm = tmo.MomentEngine(BatchedTabulator(tzoo, order=0, device=cuda), device=cuda).moments
    P = _card_points(cuda, tzoo, 100_001)
    wf = torch.as_tensor(np.random.default_rng(42).random(P.shape[0]) - 0.5, device=cuda)
    got, again, want = pm(P, wf), pm(P, wf), pm.plain(P, wf)
    torch.cuda.synchronize()
    assert pm.launches == 2 and torch.equal(got, again)
    assert ((got - want).abs().max() / want.abs().max()).item() <= RTOL_PLAIN


@pytest.mark.cuda
@pytest.mark.parametrize("degree,width", [(15, 16), (3, 4), (0, 1)])
def test_k6_sd1_on_card_matches_plain(degree, width, cuda):
    """K6 at sd = 1 under every candidate plan against its plain version,
    1e-5 of max |plain|; rows outside dst keep their values."""
    es = texp.ExpansionSet(tcl.ufc_simplex(1))
    rng = np.random.default_rng(width)
    k6 = ZooF32Kernel([rng.standard_normal((300, width)), rng.standard_normal((7, 1))], degree,
                      float(es.get_scale(degree)), es.affine_mappings[0], device=cuda)
    P = torch.as_tensor(_points(20_003, degree), device=cuda).float()
    dst = torch.arange(k6.total_rows, dtype=torch.int32, device=cuda)
    want = k6.plain(P, dst, torch.zeros((k6.total_rows, P.shape[0]), device=cuda))
    for plan in k6.candidates(k6.kpad):
        k6.plan = plan
        got = k6(P, dst, torch.full((k6.total_rows, P.shape[0]), float("nan"), device=cuda))
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= RTOL_F32_KERNEL * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ZOOS))
def test_entry_points_on_card_launch_each_kernel_once_and_match_cpu(name, cuda):
    """Each interval zoo through the four entry points on the card (f64
    tables: K1, K2, and K3 for the split elements; moments: K45;
    interpolation: K1, and K3 one row a program; f32 tables: K6, and K3
    float32), one launch each, against the same entry points on the CPU,
    and the Bernstein route (K8 + K2) on a one-width zoo."""
    tzoo = _zoo(ft, name)
    macro = any(el.is_macroelement() for el in tzoo)
    P = _card_points(cuda, tzoo, 3000)
    pts = P.cpu().numpy()
    tab = device_tabulator(tzoo, order=1, device=cuda)
    got = tab(P)
    assert (tab.recurrence.launches, tab.matmul.launches) == (1, 1)
    mo = merged_macro(tab)
    assert mo is None or (mo.name, mo.launches) == ("K3", 1)
    want = device_tabulator(tzoo, order=1, device="cpu")(pts)
    for a in want:
        assert (got[a].cpu() - want[a]).abs().max().item() <= 1e-12 * max(
            1.0, want[a].abs().max().item())
    gpu0 = BatchedTabulator(tzoo, order=0, device=cuda)
    cpu0 = BatchedTabulator(tzoo, order=0, device="cpu")
    rng = np.random.default_rng(43)
    wf = rng.random(len(pts))
    M = tmo.moment_rows(gpu0, P, torch.as_tensor(wf, device=cuda))
    eng = gpu0._moment_engine
    assert eng.moments.launches == 1
    Mc = tmo.moment_rows(cpu0, pts, wf).numpy()
    assert np.abs(M.cpu().numpy() - Mc).max() <= 1e-12 * max(1.0, np.abs(Mc).max())
    c = rng.random(len(Mc)) - 0.5
    u = tmo.interpolate_rows(gpu0, P, torch.as_tensor(c, device=cuda))
    assert eng.recurrence.launches == 1 and (merged_macro(eng) is None) == (not macro)
    assert merged_macro(eng) is None or merged_macro(eng).launches == 1
    uc = tmo.interpolate_rows(cpu0, pts, c).numpy()
    assert np.abs(u.cpu().numpy() - uc).max() <= 1e-12 * max(1.0, np.abs(uc).max())
    f32 = device_tabulator(tzoo, order=1, f64=False, device=cuda)
    t32 = f32.tables(P)
    mo = merged_macro(f32)
    assert f32.kernel.launches == 1 and (mo is None or mo.launches == 1)
    ref = device_tabulator(tzoo, order=1, f64=False, device="cpu").tables(pts)
    pr = f32.plain_rows
    for a in ref:
        assert bool(torch.isfinite(t32[a]).all())
        assert (t32[a][:pr].cpu() - ref[a][:pr]).abs().max().item() <= RTOL_F32_KERNEL * (
            ref[a][:pr].abs().max().item() + 1.0)
    if name == "1d_mix":
        bzoo = [ft.Lagrange(tcl.ufc_simplex(1), 4), ft.GaussLobattoLegendre(tcl.ufc_simplex(1), 4)]
        bern = FusedZooTabulator(BatchedTabulator(bzoo, order=1, device="cpu"), device=cuda,
                                 features="bernstein")
        bt = bern(P)
        assert (bern.features.launches, bern.matmul.launches) == (1, 1)
        ref = device_tabulator(bzoo, order=1, device="cpu")(pts)
        for a in ref:
            assert (bt[a].cpu() - ref[a]).abs().max().item() <= 1e-11 * max(
                1.0, ref[a].abs().max().item())
