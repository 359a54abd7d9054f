"""K3 and K45 on zoos past 32 subcells in all, on the port against fiat_tpu.

The two kernels bin a point program by program (32 subcells a mask word,
any number of words), so a zoo may have any number of macro programs.  Here: K3's and
K45's plain versions on chip_smoke.py's ``stokes_elasticity_tri`` (42
subcells in 9 programs) and ``stokes_elasticity_tet`` (44 in 9) against
fiat_tpu's interpreted one-shot and masked-moment kernels, the kernels'
schedules replayed on their packed tables, and a triangle zoo of 39
subcells that mixes the PS6, PS12, Alfeld and double Alfeld splits (two
programs on the Alfeld split, two on PS6) through every entry point on the
CPU against fiat_tpu's engines and host; on the card (marker ``cuda``,
skipped without one), each kernel against its plain version and the entry
points with one launch of each kernel a pass.

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
from fiat_tpu_torch.ops.macro_oneshot import MacroOneShot
from fiat_tpu_torch.ops.moment_kernel import PairMoments
from fiat_tpu_torch.ops.moments import MomentEngine
from fiat_tpu_torch.ops.tabulate import BatchedTabulator

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))
import chip_smoke  # noqa: E402
from chip_smoke import merged_macro

try:    # fiat_tpu and JAX, the CPU tests' oracle; the card's cases need neither
    import jax
    import jax.numpy as jnp

    from fiat_tpu import elements as jfe
    from fiat_tpu.core import cells as jcl
    from fiat_tpu.ops import moments as jmo
    from fiat_tpu.ops.pallas_multiword import FusedZooTabulator as JFusedZooTabulator
    from fiat_tpu.ops.pallas_recurrence import PallasMaskedPairMoments
    from fiat_tpu.ops.pallas_tabulate import PallasZooTabulator
    from fiat_tpu.ops.tabulate import BatchedTabulator as JBatchedTabulator
    from test_nodality_sweep import COMPOSITES
    from test_torch_k3_tri import _replay_k3
    from test_torch_tet_dual import K45_GRIDS, _replay_k45
except ImportError:
    jfe = None
    K45_GRIDS = {"one_block": None}

RTOL_INTERPRET = 1e-5   # fiat_tpu's interpreted masked-moment kernel (its CPU bar)
RTOL_PLAIN = 1e-13      # the same sums in another order of operations, of their rounding scale
ATOL_FIAT = 1e-10       # f64 tables vs fiat_tpu's engine and host (fiat_tpu's own bar)
RTOL_ALFELD_C2 = 1e-9   # AlfeldC2's tables, of max(1, max |table|) (PERF.md §2)
ATOL_DUAL = 1e-12       # moments and interpolation of plain elements vs fiat_tpu's CPU path
RTOL_F32 = 5e-6         # fiat_tpu's f32 bar (tests/test_device_ops.py:143-144)
MACRO_TOL = 5e-5        # its macro bar, relative to max abs + 1 (:586-589)
RTOL_F32_KERNEL = 1e-5  # a float32 kernel vs its plain version
#: the elements whose moments and interpolated values are held to what
#: their table bar gives a sum over the points, not ATOL_DUAL: their
#: readings need it (PERF.md §2: on 300 points, AlfeldC2 5 2.1e-11,
#: AlfeldC2 6 1.7e-9, Walkington 2.9e-11, GuzmanNeilanSecondKindH1 on the
#: tetrahedron 1.9e-12 and 1.3e-12, NodalEnriched-GN 1.0e-12, and
#: GuzmanNeilanFirstKindH1 on the tetrahedron at 99% of the bar, 9.9e-13)
DUAL_WIDE = ("AlfeldC2 5", "AlfeldC2 6", "Walkington 5", "GuzmanNeilanFirstKindH1 3",
             "GuzmanNeilanSecondKindH1 3", "NodalEnrichedElement 3")


def _points(n, sd, seed):
    rng = np.random.default_rng(seed)
    pts = rng.random((n, sd))
    return pts / (pts.sum(axis=1)[:, None] + 1e-9) * rng.random((n, 1))


def _stokes(fe, sd):
    """chip_smoke.py's stokes_elasticity_tri / _tet, built by ``fe``."""
    T = (tcl if fe is ft else jcl).ufc_simplex(sd)
    zoo = [getattr(fe, fam)(T, *(() if deg is None else (deg,)), **kw)
           for fam, deg, kw in (chip_smoke.STOKES_TRI if sd == 2 else chip_smoke.STOKES_TET)]
    if sd == 3:
        gn = (chip_smoke.composite("NodalEnriched-GN", T) if fe is ft
              else dict(COMPOSITES)["NodalEnriched-GN"]())
        zoo += [gn, fe.Walkington(T)]
    return zoo


def _mixed_splits(fe):
    """39 triangle subcells in 6 programs on 4 splits: HCT and Lagrange 2
    on the Alfeld split, PS6 and DG 1 on the Powell-Sabin split, PS12, and
    AlfeldC2 on the double Alfeld split, beside Lagrange 3."""
    T = (tcl if fe is ft else jcl).ufc_simplex(2)
    return [fe.Lagrange(T, 3), fe.HsiehCloughTocher(T, 3), fe.Lagrange(T, 2, variant="alfeld"),
            fe.QuadraticPowellSabin6(T), fe.DiscontinuousLagrange(T, 1, variant="powell-sabin"),
            fe.QuadraticPowellSabin12(T), fe.AlfeldC2(T, 5)]


ZOOS = {"stokes_elasticity_tri": (2, lambda fe: _stokes(fe, 2), 42),
        "stokes_elasticity_tet": (3, lambda fe: _stokes(fe, 3), 44),
        "mixed_splits": (2, _mixed_splits, 39)}


def dual_bars(tb, zoo, pts, wf, c):
    """Bars of the moments (per row) and the interpolated values (one)
    against fiat_tpu's CPU path: ATOL_DUAL, but for the DUAL_WIDE macro
    elements.  A macro element reaches its moments through K45's masked
    parent-basis sums and its collocation into the parent basis, as
    fiat_tpu's device route does (its CPU path tabulates the element's own
    split basis instead), and where that change of basis cancels, the sums
    differ by more than ATOL_DUAL: the DUAL_WIDE elements are held to what
    their table bar (``_host_bar``) gives a sum over the points, the bar
    times sum |wf|, and c's share of it times the bar for the interpolated
    values."""
    macro = {int(i) for p in tb.state()["macro_programs"] for i, _, _ in p.row_slices}
    mbar, ubar = np.full(len(c), ATOL_DUAL), ATOL_DUAL
    for i, (el, (lo, hi, _)) in enumerate(zip(zoo, tb.slices)):
        if i in macro and chip_smoke.element_label(el) in DUAL_WIDE:
            bar = _host_bar(el, el.tabulate(0, pts)[(0,) * pts.shape[1]])
            mbar[lo:hi] = bar * np.abs(wf).sum()
            ubar += bar * np.abs(c[lo:hi]).sum()
    return mbar, ubar


def _rounding_scales(eng, pts, wf, c):
    """The scales the port's moments and interpolated values round at, on
    the same change of basis M: per row |M| |stack| |wf|, per point
    |c M| |stack| (stack: K45's plain and masked parent basis)."""
    P = torch.as_tensor(pts)
    stack = eng.moments.stack(P).abs()
    M = eng.matrix.abs()
    return ((M @ (stack @ torch.as_tensor(np.abs(wf)))).numpy(),
            ((torch.as_tensor(np.abs(c)) @ M) @ stack).numpy())


def _tie_points(sd):
    """Points where subcells meet: vertices, barycentre, edge and face
    midpoints and points along the interior edges of the Alfeld and
    Powell-Sabin splits."""
    V = np.eye(sd + 1, sd, -1)
    c = V.mean(axis=0)
    mids = [(V[i] + V[j]) / 2 for i in range(sd + 1) for j in range(i + 1, sd + 1)]
    along = [c + t * (v - c) for v in list(V) + mids for t in (0.25, 0.5)]
    return np.vstack([V, c[None], mids, along])


def _k3(zoo, order, dtype=torch.float64):
    """K3 on the merged macro programs of a port zoo (the CPU: its plain
    version)."""
    st = BatchedTabulator(zoo, order=order, device="cpu").state()
    merged = _merge_macro_programs(st["macro_programs"], st["scale"], st["affine_map"], order)
    return MacroOneShot(**merged, device="cpu", dtype=dtype)


def _fiat_merged(bt, sd):
    """fiat_tpu's merged macro arrays, built by hand from its macro programs
    as tests/test_device_ops.py:776-838 builds them: (A, pieces)."""
    rec_deg = max(p.degree for p in bt.macro_programs)
    t_es = bt.target_es
    A = np.zeros((sum(p.tall.shape[0] for p in bt.macro_programs),
                  sum(p.K for p in bt.macro_programs)))
    pieces, r0, c0 = [], 0, 0
    for p in bt.macro_programs:
        ratio = float(np.asarray(p.parent_es.get_scale(p.degree))
                      / np.asarray(t_es.get_scale(rec_deg)))
        A[r0:r0 + p.tall.shape[0], c0:c0 + p.K] = ratio * p.tall
        pieces += [(len(pieces) + i, p.nexp_parent) for i in range(len(p.cells))]
        r0, c0 = r0 + p.tall.shape[0], c0 + p.K
    return A, pieces


def _one_row_A(mo, seed):
    """A random change of basis of one row per program, each row zero off
    its program's columns (as interpolation folds its coefficients)."""
    rng = np.random.default_rng(seed)
    progs = mo.progs.cpu().numpy()
    W = np.zeros((len(mo.geom), mo.K))
    for g, (_, _, c0, c1, _) in enumerate(progs):
        lo, hi = int(mo.pieces[c0, 0]), int(mo.pieces[c1 - 1].sum())
        W[g, lo:hi] = rng.standard_normal(hi - lo)
    return torch.as_tensor(W, device=mo.device).to(mo.dtype)


def _rounding_scale(mo, P, A=None):
    """Per row r of K3's product, max over the points of |A_r| |B| (B its
    masked parent basis), as a column: the scale row r's sums round at
    (AlfeldC2's change of basis cancels far below it)."""
    B = mo.operand(P)[0]
    return ((mo.A if A is None else A).abs() @ B.abs()).amax(dim=1, keepdim=True)


def _within_rows(got, want, scale, rtol):
    """Every row of ``got`` within rtol of its own rounding scale of
    ``want`` (a row of scale 0 must agree exactly)."""
    return bool(((torch.as_tensor(got) - torch.as_tensor(want)).abs()
                 <= rtol * torch.as_tensor(scale)).all())


@pytest.fixture(scope="module")
def zoos():
    """Each zoo built by fiat_tpu (None where it is not installed) and by
    the port."""
    return {name: (sd, jfe and make(jfe), make(ft)) for name, (sd, make, _) in ZOOS.items()}


@pytest.mark.parametrize("zoo", sorted(ZOOS))
def test_zoo_has_more_than_32_subcells_and_none_past_32_a_program(zoos, zoo):
    sd, _, tzoo = zoos[zoo]
    mo = _k3(tzoo, 1)
    progs = mo.progs.numpy()
    assert len(mo.nexp) == ZOOS[zoo][2] > 32
    assert (progs[:, 3] - progs[:, 2]).max() <= 32
    assert mo.sd == sd and len(mo.geom) >= 2


def _host_bar(el, want):
    """An element's table bar against host and fiat_tpu: absolute
    ATOL_FIAT, or for AlfeldC2 (fiat_tpu's own engine is 4.3e-10 from host
    on AlfeldC2 6) RTOL_ALFELD_C2 of max(1, max |table|)."""
    if type(el).__name__ == "AlfeldC2":
        return RTOL_ALFELD_C2 * max(1.0, float(np.abs(want).max()))
    return ATOL_FIAT


@pytest.mark.parametrize("zoo", sorted(ZOOS))
def test_k3_plain_in_the_f64_engine_matches_fiat_tpu_interpret_and_host(zoos, zoo):
    """K3's plain version on the zoo's merged programs, put in the f64
    engine in K7's place, against fiat_tpu's interpreted FusedZooTabulator
    (its per-program route) and host: the same tables as K7's; the merged A
    is fiat_tpu's bit for bit."""
    sd, jzoo, tzoo = zoos[zoo]
    pts = np.vstack([_points(200, sd, 31), _tie_points(sd)])
    bt = JBatchedTabulator(jzoo, order=1)
    A, _ = _fiat_merged(bt, sd)
    ref = bt.unpack(JFusedZooTabulator(bt, interpret=True, row_block=256,
                                       point_tile=256)(jnp.asarray(pts)))
    tab = device_tabulator(tzoo, order=1, device="cpu")
    assert merged_macro(tab).name == "K7"
    route = tab.macro_routes[0]
    route.engine, route.name = _k3(tzoo, 1), "K3"
    assert merged_macro(tab).name == "K3" and np.array_equal(merged_macro(tab).A.numpy(), A)
    got = tab.unpack(tab.block_tables(pts))
    assert merged_macro(tab).launches == 0
    for r, g, el in zip(ref, got, tzoo):
        host = el.tabulate(1, pts)
        for a in r:
            bar = _host_bar(el, host[a])
            assert np.abs(np.asarray(r[a]) - g[a].numpy()).max() <= bar, (type(el).__name__, a)
            assert np.abs(host[a] - g[a].numpy()).max() <= bar, (type(el).__name__, a)


@pytest.mark.parametrize("zoo", sorted(ZOOS))
def test_k45_plain_matches_fiat_tpu_masked_moments_interpreted(zoos, zoo):
    """K45's plain version: the masked sums against fiat_tpu's
    PallasMaskedPairMoments (K5) in interpret mode at its CPU bar, and
    every sum against the explicit contraction (fiat_tpu's Phi and masked
    parent stacks) to RTOL_PLAIN."""
    sd, jzoo, tzoo = zoos[zoo]
    pts = np.vstack([_points(150, sd, 32), _tie_points(sd)])
    wf = np.random.default_rng(33).random(len(pts)) - 0.5
    pm = MomentEngine(BatchedTabulator(tzoo, order=0, device="cpu"), device="cpu").moments
    assert len(pm.piece_nexp) == ZOOS[zoo][2]
    sums = pm(torch.as_tensor(pts), torch.as_tensor(wf)).numpy()
    assert pm.launches == 0
    bt = JBatchedTabulator(jzoo, order=0)
    progs = bt.macro_programs
    entries = [{"nexp": p.nexp_parent, "unique": p.es.continuity is not None,
                "maps": [p.es.ref_el.barycentric_map(entity=(sd, c), rescale=True)
                         for c in p.cells]} for p in progs]
    parent_map = progs[0].es.ref_el.get_parent().barycentric_map(rescale=True)
    kernel = PallasMaskedPairMoments(progs[0].parent_es, max(p.degree for p in progs), entries,
                                     parent_map, interpret=True, tile=256)
    bws = np.concatenate([np.asarray(b) for b in jax.jit(kernel.moment_rows)(
        jnp.asarray(pts), jnp.asarray(wf))])
    masked = sums[pm.nplain:]
    assert np.abs(masked - bws).max() <= RTOL_INTERPRET * np.abs(bws).max()
    phi = np.asarray(bt._expansion_tables(jnp.asarray(pts))[(0,) * sd])
    want = np.concatenate([phi[:pm.nplain] @ wf]
                          + [np.asarray(p.b_stack(jnp.asarray(pts), 0)) @ wf for p in progs])
    assert np.abs(sums - want).max() <= RTOL_PLAIN * np.abs(want).max()


@pytest.mark.parametrize("mode", ["tables", "one_row"])
@pytest.mark.parametrize("zoo", sorted(ZOOS))
def test_k3_kernel_loop_on_its_chunk_table_matches_plain(zoos, zoo, mode):
    """csrc/macro_oneshot.cuh's loop replayed on the chunk tables of a zoo
    of many programs (each chunk binned against its own program's subcells
    only), for the tables and for one row per program."""
    sd, _, tzoo = zoos[zoo]
    mo = _k3(tzoo, 1)
    pts = torch.as_tensor(np.vstack([_points(40, sd, 34), _tie_points(sd)]))
    A = None if mode == "tables" else _one_row_A(mo, 35)
    want = mo(pts, A)
    got = _replay_k3(mo, pts.numpy(), None if A is None else A.numpy())
    assert _within_rows(got, want, _rounding_scale(mo, pts, A), RTOL_PLAIN)


@pytest.mark.parametrize("grid", sorted(K45_GRIDS))
@pytest.mark.parametrize("zoo", sorted(ZOOS))
def test_k45_schedule_on_its_packed_tables_matches_plain(zoos, zoo, grid):
    """csrc/moments.cuh's schedule replayed on the packed tables of a zoo of
    many programs (per tile, each program's masks and hit counts), on
    random and tie points."""
    sd, _, tzoo = zoos[zoo]
    pm = MomentEngine(BatchedTabulator(tzoo, order=0, device="cpu"), device="cpu").moments
    pts = np.vstack([_points(50, sd, 36), _tie_points(sd)])
    wf = np.random.default_rng(37).random(len(pts)) - 0.5
    want = pm(torch.as_tensor(pts), torch.as_tensor(wf)).numpy()
    got = _replay_k45(pm, pts, wf, *K45_GRIDS[grid](len(pts), pm))
    assert np.abs(got - want).max() <= RTOL_PLAIN * np.abs(want).max()


@pytest.mark.parametrize("zoo", sorted(ZOOS))
def test_k45_shared_memory_layout(zoos, zoo):
    """K45's shared memory: the tables (12 bytes a piece and a program),
    then each warp's slab, piece masks (4 bytes a piece), 16-bit hit counts
    (64 bytes a program) and piece sums, each rounded up to 16 bytes,
    within a block."""
    _, _, tzoo = zoos[zoo]
    pm = MomentEngine(BatchedTabulator(tzoo, order=0, device="cpu"), device="cpu").moments
    npieces, nprogs, rows = len(pm.piece_nexp), len(pm.geom), pm.rows - pm.nplain

    def up16(nbytes):
        return -(-nbytes // 16) * 16

    warp = 32 * 33 * 8 + up16(4 * npieces + 64 * nprogs) + up16(8 * rows)
    assert pm.warp_smem == warp
    assert pm.smem == up16(12 * (npieces + nprogs)) + pm.warps * warp <= 232448 - 1024
    assert pm.warps == 8 or pm.smem + warp > 232448 - 1024


@pytest.mark.parametrize("kernel", ["K3", "K45", "K7"])
def test_program_past_32_subcells_runs_by_words(kernel):
    """A program past 32 subcells (a program's masks are as many words as it
    needs): 33 subcells (HCT's three maps eleven times, so a point of one
    subcell hits eleven pieces in two words), averaged, beside a unique
    program of the same 33, in K3, K45 and K7 alike: each builds, and its
    plain version runs."""
    T = tcl.ufc_simplex(2)
    mo = _k3([ft.Lagrange(T, 1), ft.HsiehCloughTocher(T, 3)], 1)
    n, rows = mo.nexp[0], mo.rows
    geom = [dict(mo.geom[0], maps=mo.geom[0]["maps"] * 11, unique=u,
                 rows=(r * rows, (r + 1) * rows)) for r, u in enumerate((False, True))]
    pieces = [(i, n) for i in range(66)]
    A = np.random.default_rng(47).standard_normal((2 * rows, 66 * n))
    affine = (mo.affine[:4].reshape(2, 2), mo.affine[4:6])
    P = torch.as_tensor(np.vstack([_points(30, 2, 48), _tie_points(2)]))
    if kernel == "K3":
        k = MacroOneShot(A, pieces, geom, mo.parent_map, mo.degree, mo.scale, affine, device="cpu")
        got = k(P)
    elif kernel == "K45":
        k = PairMoments(mo.degree, 1, mo.scale, affine, geom, mo.parent_map, pieces, device="cpu")
        got = k(P, torch.ones(P.shape[0], dtype=torch.float64))
    else:
        from fiat_tpu_torch.ops.masked_matmul import MaskedMatmul
        k = MaskedMatmul(A, pieces, geom, mo.parent_map, device="cpu")
        from fiat_tpu_torch.core.expansions import dubiner_tabulate
        ref = P @ P.new_tensor(affine[0]).T + P.new_tensor(affine[1])
        got = k(P, dubiner_tabulate(2, mo.degree, [ref[:, 0], ref[:, 1]], mo.scale).contiguous())
    assert torch.isfinite(got).all() and k.launches == 0
    if kernel != "K45":
        assert k.words == 2


# -- the mixed-split zoo through every entry point on the CPU --------------------

def test_mixed_splits_f64_engine_matches_fiat_tpu_interpret_and_host(zoos):
    """The f64 engine takes K7 past 32 subcells (one_shot_applies): its
    tables against fiat_tpu's interpreted FusedZooTabulator and host."""
    _, jzoo, tzoo = zoos["mixed_splits"]
    pts = np.vstack([_points(200, 2, 38), _tie_points(2)])
    bt = JBatchedTabulator(jzoo, order=1)
    jfz = JFusedZooTabulator(bt, interpret=True, row_block=256, point_tile=256)
    ref = bt.unpack(jfz(jnp.asarray(pts)))
    tab = device_tabulator(tzoo, order=1, device="cpu")
    assert merged_macro(tab).name == "K7" and len(merged_macro(tab).nexp) == 39
    got = tab.unpack(tab.block_tables(pts))
    for r, g, el in zip(ref, got, tzoo):
        host = el.tabulate(1, pts)
        for a in r:
            assert np.abs(np.asarray(r[a]) - g[a].numpy()).max() <= ATOL_FIAT
            assert np.abs(host[a] - g[a].numpy()).max() <= ATOL_FIAT


def test_mixed_splits_moments_and_interpolation_match_fiat_tpu(zoos):
    """moment_rows on K45 and interpolate_rows on K1 + K3 (one row per
    program), past 32 subcells, against fiat_tpu's CPU path."""
    _, jzoo, tzoo = zoos["mixed_splits"]
    pts = np.vstack([_points(200, 2, 39), _tie_points(2)])
    rng = np.random.default_rng(40)
    wf = rng.random(len(pts))
    bt = JBatchedTabulator(jzoo, order=0)
    want = np.asarray(jmo.moment_rows(bt, jnp.asarray(pts), jnp.asarray(wf)))
    tb = BatchedTabulator(tzoo, order=0, device="cpu")
    got = tmo.moment_rows(tb, pts, wf)
    c = rng.random(len(want)) - 0.5
    wi = np.asarray(jmo.interpolate_rows(bt, jnp.asarray(pts), jnp.asarray(c)))
    u = tmo.interpolate_rows(tb, pts, c).numpy()
    mbar, ubar = dual_bars(tb, tzoo, pts, wf, c)
    assert (np.abs(got.numpy() - want) <= mbar).all()
    assert np.abs(u - wi).max() <= ubar
    eng = tb._moment_engine
    assert len(eng.moments.piece_nexp) == len(merged_macro(eng).nexp) == 39
    assert eng.moments.launches == merged_macro(eng).launches == 0


def test_mixed_splits_f32_engine_matches_fiat_tpu_pallas_interpret(zoos):
    """The f32 engine: K6 for the plain rows, K3 float32 over 39 subcells
    for the macro rows, against fiat_tpu's PallasZooTabulator in interpret
    mode: plain rows to 5e-6 of each alpha's max, each macro element's rows
    to 5e-5 of its max abs + 1, or its own bar (chip_smoke.F32_OWN_BARS)."""
    _, jzoo, tzoo = zoos["mixed_splits"]
    pts = _points(200, 2, 41)
    want = PallasZooTabulator(JBatchedTabulator(jzoo, order=1), tile=256,
                              interpret=True).tables(pts)
    tab = device_tabulator(tzoo, order=1, f64=False, device="cpu")
    assert merged_macro(tab).name == "K3" and merged_macro(tab).dtype == torch.float32
    got = tab.tables(pts)
    assert (tab.kernel.launches, merged_macro(tab).launches) == (0, 0)
    pr = tab.plain_rows
    for a in want:
        w, g = np.asarray(want[a]), got[a].numpy()
        assert np.abs(g[:pr] - w[:pr]).max() <= RTOL_F32 * np.abs(w[:pr]).max(), a
        for el, (lo, hi, _) in zip(tzoo, tab.slices):
            if lo >= pr:
                tol = chip_smoke.F32_OWN_BARS.get(chip_smoke.element_label(el), MACRO_TOL)
                bar = tol * (np.abs(w[lo:hi]).max() + 1.0)
                assert np.abs(g[lo:hi] - w[lo:hi]).max() <= bar, (type(el).__name__, a)


# -- on the card ---------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _card_points(sd, cuda, n=5001):
    return torch.as_tensor(np.vstack([_points(n, sd, 42), _tie_points(sd)]), device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("zoo", sorted(ZOOS))
def test_k3_on_card_matches_plain(zoos, zoo, dtype, cuda):
    """K3's tables and one row per program on the card against its plain
    version on the same points: 1e-13 in f64, 1e-5 in float32, of the scale
    each row's sums round at (max |A_r| |B|)."""
    sd, _, tzoo = zoos[zoo]
    st = BatchedTabulator(tzoo, order=1, device="cpu").state()
    merged = _merge_macro_programs(st["macro_programs"], st["scale"], st["affine_map"], 1)
    mo = MacroOneShot(**merged, device=cuda, dtype=dtype)
    P = _card_points(sd, cuda).to(dtype)
    rtol = RTOL_PLAIN if dtype == torch.float64 else RTOL_F32_KERNEL
    got, want = mo(P), mo.plain(P)
    torch.cuda.synchronize()
    assert mo.launches == 1
    assert _within_rows(got.cpu(), want.cpu(), _rounding_scale(mo, P).cpu(), rtol)
    W = _one_row_A(mo, 43)
    got, want = mo(P, A=W), mo.plain(P, A=W)
    torch.cuda.synchronize()
    assert mo.launches == 2
    assert _within_rows(got.cpu(), want.cpu(), _rounding_scale(mo, P, W).cpu(), rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("zoo", sorted(ZOOS))
def test_k45_on_card_matches_plain(zoos, zoo, cuda):
    """K45 on the card against its plain version (1e-13 relative), one
    launch, and two calls bit for bit."""
    sd, _, tzoo = zoos[zoo]
    pm = MomentEngine(BatchedTabulator(tzoo, order=0, device=cuda), device=cuda).moments
    P = _card_points(sd, cuda, n=100_001)
    wf = torch.as_tensor(np.random.default_rng(44).random(P.shape[0]) - 0.5, device=cuda)
    got = pm(P, wf)
    again = pm(P, wf)
    want = pm.plain(P, wf)
    torch.cuda.synchronize()
    assert pm.launches == 2 and torch.equal(got, again)
    assert ((got - want).abs().max() / want.abs().max()).item() <= RTOL_PLAIN


@pytest.mark.cuda
@pytest.mark.parametrize("zoo", sorted(ZOOS))
def test_entry_points_on_card_launch_each_kernel_once_and_match_cpu(zoos, zoo, cuda):
    """moment_rows (one K45), interpolate_rows (one K1 and one K3) and the
    f32 tables (one K6 and one K3 float32) on the card against the same
    entry points on the CPU."""
    sd, _, tzoo = zoos[zoo]
    pts = np.vstack([_points(3000, sd, 45), _tie_points(sd)])
    rng = np.random.default_rng(46)
    wf = rng.random(len(pts))
    gpu, cpu = BatchedTabulator(tzoo, order=0, device=cuda), BatchedTabulator(tzoo, order=0,
                                                                               device="cpu")
    P, W = torch.as_tensor(pts, device=cuda), torch.as_tensor(wf, device=cuda)
    M = tmo.moment_rows(gpu, P, W)
    eng = gpu._moment_engine
    assert (eng.moments.launches, eng.recurrence.launches) == (1, 0)
    want = tmo.moment_rows(cpu, pts, wf).numpy()
    c = rng.random(len(want)) - 0.5
    mscale, uscale = _rounding_scales(cpu._moment_engine, pts, wf, c)
    assert (np.abs(M.cpu().numpy() - want) <= RTOL_PLAIN * mscale).all()
    u = tmo.interpolate_rows(gpu, P, torch.as_tensor(c, device=cuda))
    assert (eng.moments.launches, eng.recurrence.launches, merged_macro(eng).launches) == (1, 1, 1)
    uc = tmo.interpolate_rows(cpu, pts, c).numpy()
    assert (np.abs(u.cpu().numpy() - uc) <= RTOL_PLAIN * uscale).all()
    tab = device_tabulator(tzoo, order=1, f64=False, device=cuda)
    got = tab.tables(P)
    assert (tab.kernel.launches, merged_macro(tab).launches) == (1, 1)
    cpu32 = device_tabulator(tzoo, order=1, f64=False, device="cpu")
    ref = cpu32.tables(pts)
    # each table row's scale: K3's rounding scale of the row it comes from
    rows = torch.zeros(len(cpu32.alphas) * cpu32.rows, 1, dtype=torch.float64)
    rows[cpu32.dst_macro] = _rounding_scale(merged_macro(cpu32),
                                            torch.as_tensor(pts).float()).double()
    pr = tab.plain_rows
    for k, a in enumerate(ref):
        g = got[a].cpu()
        plain_scale = ref[a][:pr].abs().max().item()
        assert (g[:pr] - ref[a][:pr]).abs().max().item() <= RTOL_F32_KERNEL * plain_scale
        macro_scale = rows[k * cpu32.rows + pr:(k + 1) * cpu32.rows]
        assert _within_rows(g[pr:].double(), ref[a][pr:].double(), macro_scale, RTOL_F32_KERNEL)
