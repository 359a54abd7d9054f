"""The iso(k) refinements and the wide split elements (chip_smoke.py's
phases 18 and 19, ``ISO_TRI`` and ``K3_WIDE``) on the port against fiat_tpu
on the CPU: macro programs of 36, 64 and 100 subcells, and a synthetic one
of 258, past one 32-bit mask word, in K3, K7 and K45 (a program's masks are
as many words as it needs), and K3's tables chunks past a block's shared
memory, streamed through its ring of slices.

Here: the f64 engine's plain path on the iso zoo against fiat_tpu's
interpreted ``FusedZooTabulator`` and host, moments and interpolation
against fiat_tpu's CPU path, the f32 engine against fiat_tpu's
``PallasZooTabulator`` in interpret mode, on random points and on tie
points (the lattice vertices of iso(6) and iso(8), which six subcells
share, some with hits both sides of the word boundary, below 32 and from
32 on), under the unique rule (order 0, C0 bases) and the averaged one; numpy
replays of K3's, K7's and K45's loops on the wrappers' tables against their
plain versions; the wide zoos through every entry point.  On the card
(marker ``cuda``, skipped without one): each kernel against its plain
version at 36, 64, 100 and 258 subcells a program, and the entry points
with one launch of each kernel a pass.

Inputs are numpy arrays made from seeds and handed to both packages."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import fiat_tpu_torch as ft
from fiat_tpu_torch import device_tabulator
from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.ops import moments as tmo
from fiat_tpu_torch.ops.fused_zoo import _merge_macro_programs
from fiat_tpu_torch.ops.macro_oneshot import (CHUNK_ROWS, MAX_SMEM, MacroOneShot, ceil16,
                                              column_stride)
from fiat_tpu_torch.ops.masked_matmul import MaskedMatmul
from fiat_tpu_torch.ops.moment_kernel import PairMoments
from fiat_tpu_torch.ops.moments import MomentEngine
from fiat_tpu_torch.ops.tabulate import BatchedTabulator

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))
import chip_smoke  # noqa: E402
from chip_smoke import merged_macro

try:    # fiat_tpu and JAX, the CPU tests' oracle; the card's cases need neither
    import jax.numpy as jnp

    from fiat_tpu import elements as jfe
    from fiat_tpu.core import cells as jcl
    from fiat_tpu.ops import moments as jmo
    from fiat_tpu.ops.pallas_multiword import FusedZooTabulator as JFusedZooTabulator
    from fiat_tpu.ops.pallas_tabulate import PallasZooTabulator
    from fiat_tpu.ops.tabulate import BatchedTabulator as JBatchedTabulator
    from test_torch_k3_tri import _replay_k3
    from test_torch_macro_tet import _bin_as_the_kernel, _replay_k7
    from test_torch_tet_dual import K45_GRIDS, _replay_k45
except ImportError:
    jfe = None
    K45_GRIDS = {"one_block": None}

RTOL_TABLES = 1e-11     # f64 tables vs fiat_tpu's engine, of max(1, max |table|)
ATOL_HOST = 1e-10       # f64 tables vs host el.tabulate (the BASELINE.json metric)
ATOL_DUAL = 1e-12       # moments and interpolation vs fiat_tpu's CPU path
RTOL_F32 = 5e-6         # fiat_tpu's f32 bar (tests/test_device_ops.py:143-144)
MACRO_TOL = 5e-5        # its macro bar, relative to max abs + 1 (:586-589)
RTOL_PLAIN = 1e-13      # a replay or a kernel vs the plain version, of the rows' rounding scale
RTOL_F32_KERNEL = 1e-5  # a float32 kernel vs its plain version, of the same scale
#: elements whose moments and interpolated values are held to their table
#: bar (ATOL_HOST) times the sum of |wf| or |c| over their rows, as
#: tests/test_torch_many_subcells.py's DUAL_WIDE: the port's dual route goes
#: through the parent-basis collocation, as fiat_tpu's device route does,
#: while fiat_tpu's CPU path tabulates the split basis; on 200 points
#: Lagrange 2 on iso(6) reads 1.2e-12 (the ill-conditioned elements are
#: held to their own bars, chip_smoke.ILL_CONDITIONED)
DUAL_WIDE = ("Lagrange 2 IsoSplit",)


def _zoo(fe, specs, sd=2):
    """The elements of a (family, degree, variant) list, built by ``fe``."""
    T = (tcl if fe is ft else jcl).ufc_simplex(sd)
    return [getattr(fe, fam)(T, deg, **({} if v is None else {"variant": v}))
            for fam, deg, v in specs]


#: chip_smoke.py's zoos: phase 18's, and phase 19's three (P1 beside the element)
ZOOS = {"iso_refined_tri": (2, chip_smoke.ISO_TRI),
        **{name: (sd, (("Lagrange", 1, None), spec)) for name, sd, spec in chip_smoke.K3_WIDE}}


def _points(n, sd, seed):
    rng = np.random.default_rng(seed)
    pts = rng.random((n, sd))
    return pts / (pts.sum(axis=1)[:, None] + 1e-9) * rng.random((n, 1))


def _k3(zoo, order, dtype=torch.float64, device="cpu"):
    """K3 on the merged macro programs of a port zoo."""
    st = BatchedTabulator(zoo, order=order, device="cpu").state()
    merged = _merge_macro_programs(st["macro_programs"], st["scale"], st["affine_map"], order)
    return MacroOneShot(**merged, device=device, dtype=dtype)


def _iso_vertices(k):
    """The vertices of the Lagrange iso(k) split of the triangle: its
    interior ones are shared by six subcells, its edges' by three, and
    some lie on subcells both sides of 32 (three of iso(6)'s, eight of
    iso(8)'s)."""
    split = ft.Lagrange(tcl.ufc_simplex(2), 1, variant=f"iso({k})").get_nodal_basis() \
        .get_reference_element()
    return np.asarray(split.get_vertices())


def _tie_points():
    """iso(6)'s and iso(8)'s lattice vertices."""
    return np.vstack([_iso_vertices(6), _iso_vertices(8)])


def _alfeld_ties():
    """The Alfeld split's tie points: its vertices, the barycentre, points
    along its interior edges."""
    V = np.eye(3, 2, -1)
    c = V.mean(axis=0)
    return np.vstack([V, c[None]] + [c + t * (v - c) for v in V for t in (0.25, 0.5)])


def _straddling(mo, pts):
    """The points whose hits in some program of ``mo`` lie on both sides of
    a word boundary (a piece below 32 and one from 32 on)."""
    out = np.zeros(len(pts), bool)
    for _, _, c0, c1, _ in mo.progs.cpu().numpy():
        if c1 - c0 > 32:
            hits = _bin_as_the_kernel(mo.maps.cpu().numpy(), pts, c0, c1)
            out |= hits[:, :32].any(axis=1) & hits[:, 32:].any(axis=1)
    return out


def _rounding_scale(mo, P, A=None):
    """Per row of K3's product, max over the points of |A_r| |B|."""
    B = mo.operand(P)[0]
    return ((mo.A if A is None else A).abs() @ B.abs()).amax(dim=1, keepdim=True)


def _one_row_A(mo, seed):
    """A random change of basis of one row per program, each row zero off
    its program's columns (as interpolation folds its coefficients)."""
    rng = np.random.default_rng(seed)
    W = np.zeros((len(mo.geom), mo.K))
    for g, (_, _, c0, c1, _) in enumerate(mo.progs.cpu().numpy()):
        lo, hi = int(mo.pieces[c0, 0]), int(mo.pieces[c1 - 1].sum())
        W[g, lo:hi] = rng.standard_normal(hi - lo)
    return torch.as_tensor(W, device=mo.device).to(mo.dtype)


def _synthetic(npieces=258, order=1):
    """A program of ``npieces`` subcells that repeat HCT's three Alfeld maps
    (so a point inside one subcell hits npieces / 3 pieces, past 32 and
    across words), averaged, and the same pieces unique, beside P1: the
    merged arrays (A random) as the engines build them."""
    T = tcl.ufc_simplex(2)
    st = BatchedTabulator([ft.Lagrange(T, 1), ft.HsiehCloughTocher(T, 3)], order=order,
                          device="cpu").state()
    merged = _merge_macro_programs(st["macro_programs"], st["scale"], st["affine_map"], order)
    g, n = merged["geom"][0], merged["pieces"][0][1]
    rows = g["rows"][1] - g["rows"][0]
    reps = npieces // len(g["maps"])
    merged["geom"] = [dict(g, maps=g["maps"] * reps, unique=u, rows=(r * rows, (r + 1) * rows))
                      for r, u in enumerate((False, True))]
    merged["pieces"] = [(i, n) for i in range(2 * npieces)]
    # each program's rows on its own pieces' columns alone, as merged A is
    A = np.random.default_rng(npieces).standard_normal((2 * rows, 2 * npieces * n))
    A[:rows, npieces * n:] = A[rows:, :npieces * n] = 0.0
    merged["A"] = A
    return merged


def _phi(mo, P):
    """The parent Dubiner basis of K3 ``mo`` at ``P`` (K7's Phi)."""
    from fiat_tpu_torch.core.expansions import dubiner_tabulate
    sd = mo.sd
    ref = P @ P.new_tensor(mo.affine[:sd * sd].reshape(sd, sd)).T + P.new_tensor(
        mo.affine[sd * sd:])
    return dubiner_tabulate(sd, mo.degree, [ref[:, i] for i in range(sd)], mo.scale).contiguous()


@pytest.fixture(scope="module")
def zoos():
    """Each zoo built by fiat_tpu (None where it is not installed) and by
    the port."""
    return {name: (sd, jfe and _zoo(jfe, specs, sd), _zoo(ft, specs, sd))
            for name, (sd, specs) in ZOOS.items()}


def test_iso_zoo_programs_past_one_mask_word(zoos):
    """The iso zoo's macro programs: 36, 64, 100 and five of 36 subcells,
    380 in all; K7 (the f64 engine), K3 (the f32 engine, one row a
    program) and K45 keep four mask words a point, and the tie points hold
    iso(6) and iso(8) vertices in six subcells and points whose hits cross
    a word boundary."""
    _, _, tzoo = zoos["iso_refined_tri"]
    tab = device_tabulator(tzoo, order=1, device="cpu")
    k7 = merged_macro(tab)
    progs = k7._progs
    assert k7.name == "K7" and (progs[:, 3] - progs[:, 2]).tolist() == [36, 64, 100] + [36] * 5
    assert k7.words == 4 and k7.plan[1] >= 100
    k3 = merged_macro(device_tabulator(tzoo, order=1, f64=False, device="cpu"))
    assert k3.name == "K3" and k3.words == 4 and len(k3.nexp) == 380
    pm = MomentEngine(BatchedTabulator(tzoo, order=0, device="cpu"), device="cpu").moments
    assert len(pm.piece_nexp) == 380
    pts = _tie_points()
    hits = _bin_as_the_kernel(k7.maps.numpy(), pts, 0, 36).sum(axis=1)
    assert hits.max() == 6
    assert _straddling(k7, pts).sum() >= 2


def _tables_bar(el, want):
    """An element's bar against fiat_tpu's tables: RTOL_TABLES of max(1,
    max |table|), or for the ill-conditioned elements their own bar
    (chip_smoke.ILL_CONDITIONED) of it."""
    scale = max(1.0, float(np.abs(want).max()))
    return chip_smoke.ILL_CONDITIONED.get(chip_smoke.split_label(el), RTOL_TABLES) * scale


def _held_to_host(name, el, got, want_fiat, host):
    """The port's table against host: ATOL_HOST, or for an ill-conditioned
    element its own bar and no further from host than fiat_tpu's engine
    (within 5% of its distance: on Lagrange 7 on Worsey-Farin both read
    4.2e-9 of max(1, max |table|), host tabulation itself being that far
    from either)."""
    err = float(np.abs(got - host).max())
    if chip_smoke.split_label(el) in chip_smoke.ILL_CONDITIONED:
        assert err <= _tables_bar(el, host), name
        assert err <= 1.05 * float(np.abs(want_fiat - host).max()), name
    else:
        assert err <= ATOL_HOST, name


def test_iso_f64_engine_matches_fiat_tpu_interpret_and_host(zoos):
    """The f64 engine (K1, K2, K7 past 32 subcells in all, plain here) on
    the iso zoo against fiat_tpu's interpreted FusedZooTabulator and host,
    on random and tie points, at order 1 (averaged) and order 0 (the C0
    programs keep their first hit)."""
    _, jzoo, tzoo = zoos["iso_refined_tri"]
    pts = np.vstack([_points(150, 2, 61), _tie_points()])
    for order in (0, 1):
        bt = JBatchedTabulator(jzoo, order=order)
        ref = bt.unpack(JFusedZooTabulator(bt, interpret=True, row_block=256,
                                           point_tile=256)(jnp.asarray(pts)))
        tab = device_tabulator(tzoo, order=order, device="cpu")
        got = tab.unpack(tab.block_tables(pts))
        assert merged_macro(tab).launches == 0
        for r, g, el in zip(ref, got, tzoo):
            host = el.tabulate(order, pts)
            for a in r:
                want, mine = np.asarray(r[a]), g[a].numpy()
                name = (chip_smoke.split_label(el), order, a)
                if chip_smoke.split_label(el) not in chip_smoke.ILL_CONDITIONED:
                    # fiat_tpu's df32 engine is itself up to 4.2e-12 of
                    # max(1, max |table|) from host here (Lagrange 2 on iso(6))
                    bar = _tables_bar(el, host[a]) + np.abs(want - host[a]).max()
                    assert np.abs(mine - want).max() <= bar, name
                _held_to_host(name, el, mine, want, host[a])


def _dual_bars(tb, zoo, pts, wf, c):
    """Bars of the moments (per row) and the interpolated values against
    fiat_tpu's CPU path: ATOL_DUAL, but for the DUAL_WIDE and the
    ill-conditioned elements their table bar times sum |wf|, and times sum
    |c| over their rows."""
    mbar, ubar = np.full(len(c), ATOL_DUAL), ATOL_DUAL
    for el, (lo, hi, _) in zip(zoo, tb.slices):
        label = chip_smoke.split_label(el)
        if label in chip_smoke.ILL_CONDITIONED or label in DUAL_WIDE:
            bar = (ATOL_HOST if label in DUAL_WIDE
                   else _tables_bar(el, el.tabulate(0, pts)[(0,) * pts.shape[1]]))
            mbar[lo:hi] = bar * np.abs(wf).sum()
            ubar += bar * np.abs(c[lo:hi]).sum()
    return mbar, ubar


@pytest.mark.parametrize("zoo", sorted(ZOOS))
def test_moments_and_interpolation_match_fiat_tpu(zoos, zoo):
    """moment_rows (K45 plain) and interpolate_rows (K1 + K3 one row a
    program, plain) on each zoo against fiat_tpu's CPU path."""
    sd, jzoo, tzoo = zoos[zoo]
    pts = np.vstack([_points(200, sd, 62)] + ([_tie_points()] if sd == 2 else []))
    rng = np.random.default_rng(63)
    wf = rng.random(len(pts))
    bt = JBatchedTabulator(jzoo, order=0)
    want = np.asarray(jmo.moment_rows(bt, jnp.asarray(pts), jnp.asarray(wf)))
    tb = BatchedTabulator(tzoo, order=0, device="cpu")
    got = tmo.moment_rows(tb, pts, wf).numpy()
    c = rng.random(len(want)) - 0.5
    wi = np.asarray(jmo.interpolate_rows(bt, jnp.asarray(pts), jnp.asarray(c)))
    u = tmo.interpolate_rows(tb, pts, c).numpy()
    mbar, ubar = _dual_bars(tb, tzoo, pts, wf, c)
    assert (np.abs(got - want) <= mbar).all()
    assert np.abs(u - wi).max() <= ubar
    eng = tb._moment_engine
    assert eng.moments.launches == merged_macro(eng).launches == 0


@pytest.mark.parametrize("zoo", sorted(ZOOS))
def test_f32_engine_matches_fiat_tpu_pallas_interpret(zoos, zoo):
    """The f32 engine (K6, and K3 float32 for the macro rows) against
    fiat_tpu's PallasZooTabulator in interpret mode: plain rows to 5e-6 of
    each alpha's max, macro rows to 5e-5 of max abs + 1 at the points both
    binnings put in the same subcells; the ill-conditioned elements'
    float32 rows carry no digit (chip_smoke.F32_NO_DIGITS) and are held to
    be finite only."""
    sd, jzoo, tzoo = zoos[zoo]
    pts = _points(150, sd, 64)
    want = PallasZooTabulator(JBatchedTabulator(jzoo, order=1), tile=256,
                              interpret=True).tables(pts)
    tab = device_tabulator(tzoo, order=1, f64=False, device="cpu")
    assert merged_macro(tab).name == "K3" and merged_macro(tab).dtype == torch.float32
    got = tab.tables(pts)
    assert (tab.kernel.launches, merged_macro(tab).launches) == (0, 0)
    same = merged_macro(tab).same_subcells(torch.as_tensor(pts)).numpy()
    pr = tab.plain_rows
    for a in want:
        w, g = np.asarray(want[a]), got[a].numpy()
        assert np.isfinite(g).all()
        assert np.abs(g[:pr] - w[:pr]).max() <= RTOL_F32 * np.abs(w[:pr]).max(), a
        for el, (lo, hi, _) in zip(tzoo, tab.slices):
            if lo >= pr and chip_smoke.split_label(el) not in chip_smoke.F32_NO_DIGITS:
                err = np.abs(g[lo:hi] - w[lo:hi])[:, same].max()
                assert err <= MACRO_TOL * (np.abs(w[lo:hi]).max() + 1.0), (type(el).__name__, a)


# -- the kernels' loops, replayed on the wrappers' tables --------------------------

def _iso_k3(zoos, order):
    _, _, tzoo = zoos["iso_refined_tri"]
    return _k3(tzoo, order)


@pytest.mark.parametrize("mode", ["tables", "one_row"])
@pytest.mark.parametrize("order", [0, 1])
def test_k3_loop_on_the_iso_zoo_matches_plain(zoos, order, mode):
    """K3's loop (csrc/macro_oneshot.cuh) on the iso zoo's merged programs
    (four words a point) under the wrapper's plan and a streaming ring of
    narrow slices, on random and tie points, unique (order 0) and
    averaged."""
    mo = _iso_k3(zoos, order)
    pts = np.vstack([_points(60, 2, 65), _tie_points()])
    P = torch.as_tensor(pts)
    A = None if mode == "tables" else _one_row_A(mo, 66)
    want = mo(P, A)
    scale = _rounding_scale(mo, P, A).numpy()
    An = None if A is None else A.numpy()
    plans = [mo.plan if A is None else mo.plan_one, (mo.tp, 100, 2, False),
             (mo.tp, 200, 4, False)]
    for plan in plans:
        if A is None:
            mo.plan = plan
        else:
            mo.plan_one = plan
        got = _replay_k3(mo, pts, An, sub=2)
        assert (np.abs(got - want.numpy()) <= RTOL_PLAIN * scale).all(), plan


def test_k7_loop_on_the_iso_zoo_matches_plain(zoos):
    """K7's loop (csrc/masked_matmul.cu) on the iso zoo's f64 engine (four
    words a point, programs past 32 pieces) under the wrapper's plan and a
    plan of one k of the widest program a slice."""
    _, _, tzoo = zoos["iso_refined_tri"]
    tab = device_tabulator(tzoo, order=1, device="cpu")
    mm = merged_macro(tab)
    pts = np.vstack([_points(70, 2, 67), _tie_points()])
    phi = tab.recurrence(torch.as_tensor(pts))
    want = mm(torch.as_tensor(pts), phi).numpy()
    scale = (mm.A.abs() @ mm.masked_basis(mm.masks(torch.as_tensor(pts))[0], phi).abs()).amax(
        dim=1, keepdim=True).numpy()
    for plan in (mm.plan, (64, 100, 3, 1)):
        mm.plan = plan
        got = _replay_k7(mm, pts, phi.numpy())
        assert (np.abs(got - want) <= RTOL_PLAIN * scale).all(), plan


@pytest.mark.parametrize("grid", sorted(K45_GRIDS))
def test_k45_schedule_on_the_iso_zoo_matches_plain(zoos, grid):
    """K45's schedule (csrc/moments.cuh) on the iso zoo's 380 pieces: per
    tile each program's words' ballots and hit counts, tie points of up to
    six hits a program."""
    _, _, tzoo = zoos["iso_refined_tri"]
    pm = MomentEngine(BatchedTabulator(tzoo, order=0, device="cpu"), device="cpu").moments
    pts = np.vstack([_points(40, 2, 68), _tie_points()[::3]])
    wf = np.random.default_rng(69).random(len(pts)) - 0.5
    want = pm(torch.as_tensor(pts), torch.as_tensor(wf)).numpy()
    got = _replay_k45(pm, pts, wf, *K45_GRIDS[grid](len(pts), pm))
    assert np.abs(got - want).max() <= RTOL_PLAIN * np.abs(want).max()


@pytest.mark.parametrize("kernel", ["K3 tables", "K3 one_row", "K7", "K45"])
def test_a_program_of_258_subcells_replayed_matches_plain(kernel):
    """A synthetic program of 258 subcells (HCT's maps 86 times: a point in
    one subcell hits 86 pieces, a tie point up to 258, past K45's table of
    1 / hits for 1..32), averaged, beside the same 258 pieces unique: each
    kernel's loop on its wrapper's tables (nine mask words a point)
    against its plain version."""
    merged = _synthetic()
    pts = np.vstack([_points(24, 2, 70), _alfeld_ties()])
    P = torch.as_tensor(pts)
    if kernel.startswith("K3"):
        mo = MacroOneShot(**merged, device="cpu")
        assert mo.words == 9
        A = None if kernel == "K3 tables" else _one_row_A(mo, 71)
        want = mo(P, A).numpy()
        got = _replay_k3(mo, pts, None if A is None else A.numpy(), sub=2)
        assert (np.abs(got - want) <= RTOL_PLAIN * _rounding_scale(mo, P, A).numpy()).all()
    elif kernel == "K7":
        mm = MaskedMatmul(merged["A"], merged["pieces"], merged["geom"], merged["parent_map"],
                          device="cpu")
        assert mm.words == 9 and mm.plan[1] >= 258
        phi = _phi(MacroOneShot(**merged, device="cpu"), P)
        want = mm(P, phi).numpy()
        got = _replay_k7(mm, pts, phi.numpy())
        scale = (mm.A.abs() @ mm.masked_basis(mm.masks(P)[0], phi).abs()).amax(
            dim=1, keepdim=True).numpy()
        assert (np.abs(got - want) <= RTOL_PLAIN * scale).all()
    else:
        mo = MacroOneShot(**merged, device="cpu")
        pm = PairMoments(mo.degree, 3, mo.scale, (mo.affine[:4].reshape(2, 2), mo.affine[4:6]),
                         merged["geom"], merged["parent_map"], merged["pieces"], device="cpu")
        wf = np.random.default_rng(72).random(len(pts)) - 0.5
        want = pm(P, torch.as_tensor(wf)).numpy()
        got = _replay_k45(pm, pts, wf, 1)
        assert np.abs(got - want).max() <= RTOL_PLAIN * np.abs(want).max()


# -- the wide chunks: K3 streams what a block cannot hold ----------------------------

@pytest.mark.parametrize("zoo", [name for name, _, _ in chip_smoke.K3_WIDE])
def test_k3_wide_chunks_stream_and_match_plain(zoos, zoo):
    """Phase 19's zoos: K3's tables chunk and Phi tile pass a block's 227
    KB in f64 (the triangles) and in float32 (Lagrange 10 on iso(5) and
    Lagrange 7 on Worsey-Farin), so the plan streams the chunk through a
    ring of slices at 128 points (as it does every chunk past a quarter of
    an SM's shared memory).  The kernel's loop on the streamed slices
    against the plain version."""
    sd, _, tzoo = zoos[zoo]
    pts = _points(40, sd, 73)
    P = torch.as_tensor(pts)
    for dtype in (torch.float64, torch.float32):
        mo = _k3(tzoo, 1, dtype)
        size = 8 if dtype == torch.float64 else 4
        npieces = int(mo.progs[0, 3] - mo.progs[0, 2])
        whole = ceil16(npieces * mo.nexp[0] * column_stride(CHUNK_ROWS) * size) \
            + mo.nexp_parent * 128 * size
        assert mo.plan[0] == 128 and not mo.plan[3] and mo.smem <= MAX_SMEM
        assert mo.smem_one <= MAX_SMEM
        assert (whole > MAX_SMEM) == ((zoo, dtype) != ("k3_wide_ps12_lagrange9", torch.float32))
        if dtype == torch.float64:
            want = mo(P).numpy()
            got = _replay_k3(mo, pts)
            assert (np.abs(got - want) <= RTOL_PLAIN * _rounding_scale(mo, P).numpy()).all()
    if sd == 2:
        assert merged_macro(device_tabulator(tzoo, order=1, device="cpu")).name == "K3"


@pytest.mark.parametrize("zoo", [name for name, _, _ in chip_smoke.K3_WIDE])
def test_k3_wide_f64_engine_matches_fiat_tpu_and_host(zoos, zoo):
    """Phase 19's f64 tables (K3 on the triangles, K7 on the tetrahedron;
    plain here) against fiat_tpu's engine and host: each element is
    ill-conditioned, so it is held to its own bar of max(1, max |table|)
    and to no further from host than fiat_tpu's engine (on the triangle
    its interpreted FusedZooTabulator, on the tetrahedron its
    BatchedTabulator, as tests/test_torch_macro_tet.py takes it)."""
    sd, jzoo, tzoo = zoos[zoo]
    pts = _points(120, sd, 74)
    bt = JBatchedTabulator(jzoo, order=1)
    if sd == 2:
        ref = bt.unpack(JFusedZooTabulator(bt, interpret=True, row_block=256,
                                           point_tile=256)(jnp.asarray(pts)))
    else:
        ref = bt.unpack(bt(pts))
    tab = device_tabulator(tzoo, order=1, device="cpu")
    assert merged_macro(tab).name == ("K3" if sd == 2 else "K7")
    got = tab.unpack(tab.block_tables(pts))
    for r, g, el in zip(ref, got, tzoo):
        host = el.tabulate(1, pts)
        for a in r:
            _held_to_host((zoo, a), el, g[a].numpy(), np.asarray(r[a]), host[a])


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _card_zoo(subcells):
    """P1 beside Lagrange 1 on iso(k), k * k = ``subcells``; or None for
    the synthetic 258."""
    if subcells == 258:
        return None
    k = int(round(subcells ** 0.5))
    T = tcl.ufc_simplex(2)
    return [ft.Lagrange(T, 1), ft.Lagrange(T, 1, variant=f"iso({k})")]


def _card_k3(subcells, dtype, cuda):
    if subcells == 258:
        return MacroOneShot(**_synthetic(), device=cuda, dtype=dtype)
    return _k3(_card_zoo(subcells), 1, dtype, cuda)


def _card_points(cuda, n=20_001):
    pts = np.vstack([_points(n, 2, 75), _tie_points()])
    return torch.as_tensor(pts, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("subcells", [36, 64, 100, 258])
def test_k3_on_card_matches_plain_past_one_word(subcells, dtype, cuda):
    """K3's tables and one row a program on the card against its plain
    version: 1e-13 in f64, 1e-5 in float32, of each row's own max |A_r|
    |B|; one launch each."""
    mo = _card_k3(subcells, dtype, cuda)
    assert mo.words == -(-subcells // 32)
    P = _card_points(cuda).to(dtype)
    rtol = RTOL_PLAIN if dtype == torch.float64 else RTOL_F32_KERNEL
    got, want = mo(P), mo.plain(P)
    torch.cuda.synchronize()
    assert mo.launches == 1
    scale = _rounding_scale(mo, P)
    assert bool(((got - want).abs() <= rtol * scale).all())
    W = _one_row_A(mo, 76)
    got, want = mo(P, A=W), mo.plain(P, A=W)
    torch.cuda.synchronize()
    assert mo.launches == 2
    assert bool(((got - want).abs() <= rtol * _rounding_scale(mo, P, W)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("subcells", [36, 64, 100, 258])
def test_k7_on_card_matches_plain_past_one_word(subcells, cuda):
    """K7 on the card against its plain version on the same Phi, of each
    row's own max |A_r| |B|, one launch."""
    mo = _card_k3(subcells, torch.float64, cuda)
    mm = MaskedMatmul(mo.A.cpu().numpy(), list(enumerate(mo.nexp)), mo.geom, mo.parent_map,
                      device=cuda)
    P = _card_points(cuda)
    phi = _phi(mo, P)
    got, want = mm(P, phi), mm.plain(P, phi)
    torch.cuda.synchronize()
    assert mm.launches == 1 and mm.words == mo.words
    scale = (mm.A.abs() @ mm.masked_basis(mm.masks(P)[0], phi).abs()).amax(dim=1, keepdim=True)
    assert bool(((got - want).abs() <= RTOL_PLAIN * scale).all())
    # and K3 on the same arrays
    assert bool(((mo(P) - got).abs() <= RTOL_PLAIN * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("subcells", [36, 64, 100, 258])
def test_k45_on_card_matches_plain_past_one_word(subcells, cuda):
    """K45 on the card against its plain version (1e-13 relative), one
    launch, two calls bit for bit."""
    if subcells == 258:
        merged = _synthetic()
        mo = MacroOneShot(**merged, device="cpu")
        pm = PairMoments(mo.degree, 3, mo.scale, (mo.affine[:4].reshape(2, 2), mo.affine[4:6]),
                         merged["geom"], merged["parent_map"], merged["pieces"], device=cuda)
    else:
        pm = MomentEngine(BatchedTabulator(_card_zoo(subcells), order=0, device=cuda),
                          device=cuda).moments
    P = _card_points(cuda, 100_001)
    wf = torch.as_tensor(np.random.default_rng(77).random(P.shape[0]) - 0.5, device=cuda)
    got, again, want = pm(P, wf), pm(P, wf), pm.plain(P, wf)
    torch.cuda.synchronize()
    assert pm.launches == 2 and torch.equal(got, again)
    assert ((got - want).abs().max() / want.abs().max()).item() <= RTOL_PLAIN


@pytest.mark.cuda
@pytest.mark.parametrize("zoo", sorted(ZOOS))
def test_entry_points_on_card_launch_each_kernel_once_and_match_cpu(zoo, cuda):
    """Each zoo through the four entry points on the card (f64 tables: K1,
    K2 and K7 or K3; moments: K45; interpolation: K1 and K3 one row a
    program; f32 tables: K6 and K3 float32), one launch each, against the
    same entry points on the CPU: the f64 tables and the dual values to
    1e-13 of their rounding scale (K3's rows to their own |A_r| |B|), the
    f32 tables to finiteness and, past the ill-conditioned elements, 1e-5
    of each alpha's max plus one."""
    sd, specs = ZOOS[zoo]
    tzoo = _zoo(ft, specs, sd)
    pts = _points(3000, sd, 78)
    P = torch.as_tensor(pts, device=cuda)
    tab = device_tabulator(tzoo, order=1, device=cuda)
    blocks = tab.block_tables(P)
    mac = merged_macro(tab)
    assert (tab.recurrence.launches, tab.matmul.launches, mac.launches) == (1, 1, 1)
    assert all(bool(torch.isfinite(b).all()) for bl in blocks.values() for b in bl)
    if mac.name == "K3":
        got, want, scale = mac(P), mac.plain(P), _rounding_scale(mac, P)
    else:
        phi = tab.recurrence(P)
        got, want = mac(P, phi), mac.plain(P, phi)
        scale = (mac.A.abs() @ mac.masked_basis(mac.masks(P)[0], phi).abs()).amax(
            dim=1, keepdim=True)
    assert bool(((got - want).abs() <= RTOL_PLAIN * scale).all())
    gpu0, cpu0 = BatchedTabulator(tzoo, order=0, device=cuda), BatchedTabulator(
        tzoo, order=0, device="cpu")
    rng = np.random.default_rng(79)
    wf = rng.random(len(pts))
    M = tmo.moment_rows(gpu0, P, torch.as_tensor(wf, device=cuda))
    eng = gpu0._moment_engine
    assert eng.moments.launches == 1
    Mc = tmo.moment_rows(cpu0, pts, wf).numpy()
    c = rng.random(len(Mc)) - 0.5
    # the scales the moments and the interpolated values round at, on the
    # same change of basis M (ill-conditioned here): per row |M| |stack|
    # |wf|, per point |c M| |stack| (stack: K45's plain and masked basis)
    ceng = cpu0._moment_engine
    stack, Mabs = ceng.moments.stack(torch.as_tensor(pts)).abs(), ceng.matrix.abs()
    mscale = (Mabs @ (stack @ torch.as_tensor(wf))).numpy()
    uscale = ((torch.as_tensor(np.abs(c)) @ Mabs) @ stack).numpy()
    assert (np.abs(M.cpu().numpy() - Mc) <= RTOL_PLAIN * mscale).all()
    u = tmo.interpolate_rows(gpu0, P, torch.as_tensor(c, device=cuda))
    assert (eng.recurrence.launches, merged_macro(eng).launches) == (1, 1)
    uc = tmo.interpolate_rows(cpu0, pts, c).numpy()
    assert (np.abs(u.cpu().numpy() - uc) <= RTOL_PLAIN * uscale).all()
    f32 = device_tabulator(tzoo, order=1, f64=False, device=cuda)
    t32 = f32.tables(P)
    assert (f32.kernel.launches, merged_macro(f32).launches) == (1, 1)
    ref = device_tabulator(tzoo, order=1, f64=False, device="cpu").tables(pts)
    pr = f32.plain_rows
    for a in ref:
        assert bool(torch.isfinite(t32[a]).all())
        assert (t32[a][:pr].cpu() - ref[a][:pr]).abs().max().item() <= RTOL_F32_KERNEL * (
            ref[a][:pr].abs().max().item() + 1.0)
