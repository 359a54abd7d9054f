"""The degrees past the kernels' unrolled instantiations: K1, K3, K45 and K6
take every degree fiat_tpu's kernels take, the unrolled instantiations up
to their tops (15 / 15 / 10 for K1 and K6, 15 / 10 / 10 for K3 and K45 on
sd 1 / 2 / 3) and one generic instantiation per kernel and cell past them
(``csrc/dubiner{1,2,3}.cuh``'s ``dubiner*_point_n``: the degree at run
time, the stages streamed).

On the CPU, against fiat_tpu (inputs from seeded numpy generators, 64
points, handed to both packages): GLL Lagrange 16 / 20 / 30 on the
interval, 11 / 16 / 20 on the triangle and 11 / 14 on the tetrahedron
through the f64 engine (vs fiat_tpu's interpreted ``FusedZooTabulator``),
the f32 engine (vs ``PallasZooTabulator`` in interpret mode), moments and
interpolation (vs ``fiat_tpu.ops.moments``) and ``ElementTabulator``; the
Alfeld macro elements (Lagrange 20 on the interval's split, 12 on the
triangle's: K3's generic stage; Lagrange 11 on the tetrahedron's: f32 and
interpolation on K3, f64 on K7), on random rows over their masked parent
bases, handed to both packages, at the f64 and f32 bars, and where the
collocation keeps digits against the host; a numpy replay of the streaming
recurrence's entry order on ``pack_stages``' layout; the refusals that
remain, by name.  On the card (marker ``cuda``, skipped without one):
each generic stage against its plain version, and the entry points one
launch of each kernel.

The fiat_tpu imports are guarded, so the card machine runs the ``cuda``
cases without JAX."""

import math

import numpy as np
import pytest
import torch

import fiat_tpu_torch as ft
from fiat_tpu_torch import device_tabulator
from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.core import expansions as texp
from fiat_tpu_torch.ops import moments as tmo
from fiat_tpu_torch.ops.bernstein import BernsteinFeatures
from fiat_tpu_torch.ops.f32_zoo import F32ZooTabulator, ZooF32Kernel
from fiat_tpu_torch.ops.fused_zoo import BucketMatmul, FusedZooTabulator, merge_group
from fiat_tpu_torch.ops.macro_oneshot import (GENERIC_TILES, MAX_SMEM, MacroOneShot,
                                              one_shot_applies, smem_bytes)
from fiat_tpu_torch.ops.moment_kernel import PairMoments, block_smem, warp_doubles
from fiat_tpu_torch.ops.recurrence import UNROLLED_DEGREE, DubinerRecurrence, pack_stages
from fiat_tpu_torch.ops.tabulate import BatchedTabulator, ElementTabulator
from chip_smoke import merged_macro

try:    # fiat_tpu and JAX, the CPU tests' oracle; the card's cases need neither
    import jax.numpy as jnp

    from fiat_tpu import elements as jfe
    from fiat_tpu.core import cells as jcl
    from fiat_tpu.ops import moments as jmo
    from fiat_tpu.ops.pallas_multiword import FusedZooTabulator as JFusedZooTabulator
    from fiat_tpu.ops.pallas_tabulate import PallasZooTabulator
    from fiat_tpu.ops.tabulate import BatchedTabulator as JBatchedTabulator
    from fiat_tpu.ops.tabulate import ElementTabulator as JElementTabulator
except ImportError:
    jfe = None

RTOL_TABLES = 1e-11     # f64 tables vs fiat_tpu's engine, of max(1, max |table|)
RTOL_HOST = 1e-10       # f64 tables vs host, of max(1, max |table|)
#: f32 engine vs the f64 engine, of each alpha's max: PERF.md section 2's
#: interval bar.  The f32 recurrence's rounding grows with the degree: at
#: triangle 20 / tet 14 the port reads 5.6e-6 / 8.2e-6, fiat_tpu's
#: interpreted engine 3.7e-6 / 3.5e-6, past the 5e-6 of low degrees
RTOL_F32 = 2e-5
RTOL_DUAL = 1e-11       # moments, interpolation: of max(1, max |table|) times sum |weights|
RTOL_PLAIN = 1e-13      # a replay or an f64 kernel vs its plain version
RTOL_F32_KERNEL = 1e-5  # a float32 kernel vs its plain version
NPTS = 64

#: (family, degree, variant) per cell: the plain zoos (GLL Lagrange at the
#: degrees fiat_tpu's kernels take past the port's old caps) and the macro
#: zoos (a plain element beside the Alfeld elements)
PLAIN = {1: [("Lagrange", 16, "gll"), ("Lagrange", 20, "gll"), ("Lagrange", 30, "gll")],
         2: [("Lagrange", 11, "gll"), ("Lagrange", 16, "gll"), ("Lagrange", 20, "gll")],
         3: [("Lagrange", 11, "gll"), ("Lagrange", 14, "gll")]}
MACRO = {1: [("Lagrange", 1, None), ("Lagrange", 20, "alfeld")],
         2: [("Lagrange", 1, None), ("Lagrange", 12, "alfeld")],
         3: [("Lagrange", 1, None), ("Lagrange", 11, "alfeld")]}
#: the degrees of the entry-order replay: the range each cell must reach
DEGREES = {1: (16, 20, 30), 2: (11, 16, 20), 3: (11, 14)}
CELLS = {1: "interval", 2: "triangle", 3: "tetrahedron"}


def _zoo(fe, cells, specs, sd):
    cell = cells.ufc_simplex(sd)
    return [getattr(fe, f)(cell, d, **({} if v is None else {"variant": v})) for f, d, v in specs]


def _points(sd, n, seed):
    return np.random.default_rng(seed).random((n, sd)) / sd


def _scaled(got, want):
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


# -- the streaming recurrence's entry order ----------------------------------------

def _second_rows_n(sd, n):
    """csrc/zoo_f32.cuh second_rows_n: the stage-1 rows of a point's second
    thread (a bit each), the widest rows first to the thread with fewer
    entries so far."""
    mask, load = 0, [0, 0]
    for r in range(n + 1):
        entries = n - r + 1 if sd == 2 else (n - r + 1) * (n - r + 2) // 2
        h = 1 if load[1] < load[0] else 0
        load[h] += entries
        mask |= h << r
    return mask


def _stream(sd, n, consts, x, scale, keep=lambda r: True):
    """csrc/dubiner{1,2,3}.cuh's dubiner*_point_n in numpy, point-vectorised:
    [(entry, stage-1 row, level, value)] in emit order (row and level
    None on the tetrahedron, level None on the interval)."""
    c = consts.reshape(-1, 4)

    def step(o, fa, fb, fc, prev, prev2):
        return (c[o, 0] * fa - c[o, 1] * fb) * prev - (c[o, 2] * fc) * prev2

    out = []
    if n == 0:
        return [(0, 0, 0, np.full(x.shape[0], scale))]
    if sd == 1:
        fb, fa, fc = -1.0, x[:, 0], 1.0
        prev2, prev = 0.0, np.full(x.shape[0], scale)
        out.append((0, None, 0, prev * c[0, 3]))
        for i in range(1, n + 1):
            v = step(i, fa, fb, fc, prev, prev2)
            out.append((i, None, i, v * c[i, 3]))
            prev2, prev = prev, v
        return out
    x0, x1 = x[:, 0], x[:, 1]
    x2 = x[:, 2] if sd == 3 else None
    fb0 = 0.5 * (x1 + (x2 if sd == 3 else -1.0))
    fa0, fc0 = x0 + fb0 + 1.0, fb0 * fb0
    s_prev2, s_prev = 0.0, np.full(x.shape[0], scale)
    c1 = n + 1
    nexp2 = (n + 1) * (n + 2) // 2
    e1 = e = 0
    if sd == 2:
        fb, fa, fc = -1.0, x1, 1.0
    else:
        fb1 = 0.5 * (x2 - 1.0)
        fa1, fc1 = x1 + fb1 + 1.0, fb1 * fb1
        fb2, fa2, fc2 = -1.0, x2, 1.0
        c2 = c1 + nexp2
    for r in range(n + 1):
        if r == 0:
            r0 = s_prev * c[0, 3]
        else:
            v = step(r, fa0, fb0, fc0, s_prev, s_prev2)
            r0 = v * c[r, 3]
            s_prev2, s_prev = s_prev, v
        if not keep(r):
            e1 += n - r + 1
            e += n - r + 1 if sd == 2 else (n - r + 1) * (n - r + 2) // 2
            continue
        prev2, prev = 0.0, r0
        if sd == 2:
            out.append((e, r, 0, prev * c[c1 + e, 3]))
            e += 1
            for i in range(1, n - r + 1):
                v = step(c1 + e, fa, fb, fc, prev, prev2)
                out.append((e, r, i, v * c[c1 + e, 3]))
                prev2, prev = prev, v
                e += 1
            continue
        for q in range(n - r + 1):
            v = prev
            if q > 0:
                v = step(c1 + e1, fa1, fb1, fc1, prev, prev2)
                prev2, prev = prev, v
            s2, s = 0.0, v * c[c1 + e1, 3]
            out.append((e, None, None, s * c[c2 + e, 3]))
            e += 1
            for _ in range(1, n - r - q + 1):
                w = step(c2 + e, fa2, fb2, fc2, s, s2)
                out.append((e, None, None, w * c[c2 + e, 3]))
                s2, s = s, w
                e += 1
            e1 += 1
    return out


@pytest.mark.parametrize("sd,degree", [(sd, d) for sd in DEGREES for d in DEGREES[sd]])
def test_streaming_entry_order_is_pack_stages_layout(sd, degree):
    """The runtime-degree recurrence emits every entry once, in
    ``pack_stages``' order (0, 1, ...), on the triangle with (row, level) as
    its stage-1 table lays them out (the morton row of (r, i) is ``slots``'
    entry, the member K3 and K6 write), its values on ``slots`` equal to
    the plain recurrence's; the two halves of K6's row split cover every
    entry once, with the same values."""
    consts, slots = pack_stages(degree, sd=sd)
    ref = _points(sd, 40, degree) * 2.0 - 0.5
    scale = 1.25
    seq = _stream(sd, degree, consts, ref, scale)
    assert [e for e, *_ in seq] == list(range(math.comb(degree + sd, sd)))
    if sd == 2:
        assert all((r + i) * (r + i + 1) // 2 + i == slots[e] for e, r, i, _ in seq)
    got = np.zeros((len(seq), ref.shape[0]))
    for e, _, _, v in seq:
        got[slots[e]] = v
    want = texp.dubiner_tabulate(sd, degree, [ref[:, i] for i in range(sd)], scale, raw=True)
    assert np.abs(got - want).max() <= RTOL_PLAIN * np.abs(want).max()
    if sd > 1:
        second = _second_rows_n(sd, degree)
        halves = [_stream(sd, degree, consts, ref, scale,
                          keep=lambda r, h=h: ((second >> r) & 1) == h) for h in (0, 1)]
        entries = sorted(e for half in halves for e, *_ in half)
        assert entries == list(range(len(seq))) and all(halves)
        for half in halves:
            for e, _, _, v in half:
                assert np.array_equal(v, seq[e][3])


@pytest.mark.parametrize("variant", ["bubble", "dual"])
def test_streaming_recurrence_takes_the_variants(variant):
    """The expansion variants keep the stage structure: the streaming
    replay on their packed constants is the plain raw recurrence."""
    consts, slots = pack_stages(16, variant, sd=2)
    ref = _points(2, 30, 3) * 2.0 - 0.5
    got = np.zeros((len(slots), 30))
    for e, _, _, v in _stream(2, 16, consts, ref, 1.0):
        got[slots[e]] = v
    want = texp.dubiner_tabulate(2, 16, [ref[:, 0], ref[:, 1]], 1.0, variant=variant, raw=True)
    assert np.abs(got - want).max() <= RTOL_PLAIN * np.abs(want).max()


# -- the engines against fiat_tpu ---------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    """Per (cell, zoo): both packages' zoos, points, and fiat_tpu's
    BatchedTabulators at order 1 and 0 (built once)."""
    if jfe is None:
        pytest.skip("needs fiat_tpu and JAX")
    out = {}
    for sd in (1, 2, 3):
        for name, specs in (("plain", PLAIN[sd]), ("macro", MACRO[sd])):
            jzoo, tzoo = _zoo(jfe, jcl, specs, sd), _zoo(ft, tcl, specs, sd)
            out[sd, name] = dict(jzoo=jzoo, tzoo=tzoo, pts=_points(sd, NPTS, 10 * sd),
                                 bt1=JBatchedTabulator(jzoo, order=1),
                                 bt0=JBatchedTabulator(jzoo, order=0))
    return out


def _f64_check(e):
    """The f64 engine (plain versions) against fiat_tpu's interpreted
    engine at RTOL_TABLES and the host at RTOL_HOST, of max(1, max |table|)
    per alpha.  A macro element of the collocation zoos is held to the
    host at a bar that adds fiat_tpu's own distance from it: both engines
    extend each subcell's polynomials to the parent cell (the collocation
    ``MacroSideProgram`` builds), which at these degrees amplifies rounding
    by the extension's growth, so the port's tables of a macro element are
    held to be no farther from the host's than fiat_tpu's, to RTOL_TABLES
    of fiat_tpu's max(1, max |table|).  Only Lagrange 12 on the Alfeld
    triangle takes that check (fiat_tpu 2.4e-4 from host): Lagrange 20 on
    the Alfeld interval keeps no digit of the host's in either package
    (about T_20(3), 1e15, of growth; ``chip_smoke.NO_DIGITS``), so its
    stage is held on the random rows of ``random_macro`` instead."""
    pts, bt = e["pts"], e["bt1"]
    jfz = JFusedZooTabulator(bt, interpret=True, row_block=256, point_tile=128)
    fused = jfz.unpack({a: [np.asarray(x) for x in v]
                        for a, v in jfz.block_tables(jnp.asarray(pts)).items()})
    tab = device_tabulator(e["tzoo"], order=1, device="cpu")
    got = tab.unpack(tab.block_tables(pts))
    for el, f, g in zip(e["tzoo"], fused, got):
        host = el.tabulate(1, pts)
        for a, h in host.items():
            mine, ref = g[a].numpy().reshape(h.shape), np.asarray(f[a]).reshape(h.shape)
            if el.is_macroelement():    # no farther from the host than fiat_tpu
                assert (np.abs(mine - h).max() <= np.abs(ref - h).max()
                        + RTOL_TABLES * max(1.0, np.abs(ref).max())), (el, a)
                continue
            assert _scaled(mine, ref) <= RTOL_TABLES, (el, a, _scaled(mine, ref))
            assert _scaled(mine, h) <= RTOL_HOST, (el, a, _scaled(mine, h))
    return tab


@pytest.fixture(scope="module")
def random_macro():
    """Per cell: the Alfeld zoos (``MACRO``) of both packages at order 1 and
    0, every macro program's ``tall`` matrix replaced by one seeded
    standard normal matrix of its shape, the same in both packages.  The
    macro stages (K3, K7, K45's masked sums) then compute well-conditioned
    rows of the masked parent basis, which keep the digits the collocation
    matrices of these degrees lose, and so can be held to fiat_tpu at the
    f64 and f32 bars."""
    if jfe is None:
        pytest.skip("needs fiat_tpu and JAX")
    out = {}
    for sd in (1, 2, 3):
        e = {"pts": _points(sd, NPTS, 10 * sd + 1)}
        for order in (1, 0):
            jbt = JBatchedTabulator(_zoo(jfe, jcl, MACRO[sd], sd), order=order)
            tbt = BatchedTabulator(_zoo(ft, tcl, MACRO[sd], sd), order=order, device="cpu")
            rng = np.random.default_rng(100 * sd + order)
            for jp, tp in zip(jbt.macro_programs, tbt.macro_programs, strict=True):
                assert jp.tall.shape == tp.tall.shape
                jp.tall = rng.standard_normal(jp.tall.shape)
                tp.tall = jp.tall.copy()
            e[order] = jbt, tbt
        out[sd] = e
    return out


def _random_f64_check(e):
    """The f64 engine on ``random_macro``'s rows against fiat_tpu's
    interpreted ``FusedZooTabulator`` on the same arrays: every row, each
    alpha at RTOL_TABLES of max(1, max |table|)."""
    jbt, tbt = e[1]
    jfz = JFusedZooTabulator(jbt, interpret=True, row_block=256, point_tile=128)
    want = jfz.unpack({a: [np.asarray(x) for x in v]
                       for a, v in jfz.block_tables(jnp.asarray(e["pts"])).items()})
    tab = FusedZooTabulator(tbt, device="cpu")
    got = tab.unpack(tab.block_tables(e["pts"]))
    assert len(got) == len(want) == 2
    for f, g in zip(want, got):
        assert set(f) == set(g)
        for a in f:
            ref = np.asarray(f[a])
            assert _scaled(g[a].numpy().reshape(ref.shape), ref) <= RTOL_TABLES, a
    return tab


@pytest.mark.parametrize("sd", [1, 2, 3], ids=CELLS.get)
def test_f64_engine_matches_fiat_tpu_and_host(engines, sd):
    """The f64 engine's plain path (K1 at the zoo's top degree, K2) against
    fiat_tpu's interpreted ``FusedZooTabulator`` at RTOL_TABLES and the
    host at RTOL_HOST, of max(1, max |table|) per alpha."""
    tab = _f64_check(engines[sd, "plain"])
    assert tab.recurrence.generic and tab.recurrence.degree == DEGREES[sd][-1]
    assert tab.matmul.launches == tab.recurrence.launches == 0


@pytest.mark.parametrize("sd", [1, 2], ids=CELLS.get)
def test_f64_macro_zoo_runs_k3_generic(engines, random_macro, sd):
    """The Alfeld elements on the f64 engine: K3's generic stage (parent
    degree 20 on the interval, 12 on the triangle, past the unrolled 15 /
    10), its plan on a narrower point tile where the Phi tile needs it:
    on random rows against fiat_tpu's interpreted engine at RTOL_TABLES,
    and on the triangle's collocation zoo against fiat_tpu and the host
    (``_f64_check``)."""
    tab = _random_f64_check(random_macro[sd])
    mo = merged_macro(tab)
    assert mo.name == "K3" and mo.generic and mo.launches == 0
    assert merged_macro(tab).plan[0] in GENERIC_TILES and merged_macro(tab).smem <= MAX_SMEM
    if sd == 2:
        tab = _f64_check(engines[sd, "macro"])
        assert merged_macro(tab).name == "K3" and merged_macro(tab).generic


def test_f64_macro_tet_takes_k7_on_k1s_prefix(random_macro):
    """Lagrange 11 on the Alfeld tetrahedron in the f64 engine: K7 over K1's
    generic Phi (the 364-row prefix of degree 11), its plan within shared
    memory, on random rows against fiat_tpu's interpreted engine at
    RTOL_TABLES."""
    tab = _random_f64_check(random_macro[3])
    mo = merged_macro(tab)
    assert mo.name == "K7" and mo.max_nexp == 364 and mo.plan is not None
    assert tab.recurrence.generic and tab.recurrence.degree == 11


def _f32_check(jbt, tbt, pts):
    """The f32 engine on ``tbt`` against the f64 engine on it at RTOL_F32
    of each alpha's max, and against fiat_tpu's ``PallasZooTabulator`` in
    interpret mode on ``jbt`` (the same arrays) at twice it: every row."""
    want = PallasZooTabulator(jbt, tile=256, interpret=True).tables(pts)
    tab = F32ZooTabulator(tbt, device="cpu")
    got = tab.tables(pts)
    assert list(got) == list(want)
    f64 = FusedZooTabulator(tbt, device="cpu")(pts)
    for a in want:
        w, g, h = np.asarray(want[a]), got[a].numpy(), f64[a].numpy()
        big = np.abs(h).max()
        assert g.shape == w.shape == h.shape
        assert np.abs(g - h).max() <= RTOL_F32 * big, a
        assert np.abs(g - w).max() <= 2 * RTOL_F32 * big, a
    return tab


@pytest.mark.parametrize("sd", [1, 2, 3], ids=CELLS.get)
def test_f32_engine_matches_fiat_tpu_pallas_interpret(engines, sd):
    """The f32 engine (K6's generic stage) against fiat_tpu's
    ``PallasZooTabulator`` in interpret mode: each alpha to RTOL_F32 of its
    max."""
    e = engines[sd, "plain"]
    tab = _f32_check(e["bt1"], BatchedTabulator(e["tzoo"], order=1, device="cpu"), e["pts"])
    assert tab.kernel.generic and tab.kernel.launches == 0
    if sd == 3:       # tet degree 14: 680 Phi rows, one block of 64 points an SM
        assert tab.kernel.plan[0] == 64 and tab.kernel.plan[3] == 1


@pytest.mark.parametrize("sd", [1, 2, 3], ids=CELLS.get)
def test_f32_macro_zoo_matches_fiat_tpu_pallas_interpret(random_macro, sd):
    """The Alfeld zoos on the f32 engine: K3's float32 generic stage (K6 for
    the plain rows) on ``random_macro``'s rows against the f64 engine and
    fiat_tpu's interpreted engine.  The collocation rows keep no float32
    digit at these degrees in either package (``chip_smoke.F32_NO_DIGITS``'s
    rule), so the random rows hold the stage."""
    e = random_macro[sd]
    tab = _f32_check(*e[1], e["pts"])
    assert merged_macro(tab).generic and merged_macro(tab).dtype == torch.float32
    assert merged_macro(tab).plan is not None and merged_macro(tab).smem <= MAX_SMEM


def _dual_check(e, moments=True):
    """Moments and interpolation against fiat_tpu's CPU path: at RTOL_DUAL
    of max(1, max |table|) times the sum of the weights (or of |c|), plus,
    for a macro element, its engine table's distance from the host times
    that sum: the port's dual route goes through the parent-basis
    collocation (as fiat_tpu's device route does), fiat_tpu's CPU route
    tabulates the split basis (tests/test_torch_interval.py's split
    elements, there at the host bar)."""
    pts, bt = e["pts"], e["bt0"]
    rng = np.random.default_rng(len(pts))
    wf = rng.random(len(pts))
    tb = BatchedTabulator(e["tzoo"], order=0, device="cpu")
    tables = tb.unpack({a: t.numpy() for a, t in tb(pts).items()})
    zero = (0,) * pts.shape[1]
    big = max(max(1.0, np.abs(t[zero]).max()) for t in tables)
    # per row: the distance of its element's engine table from the host
    off = np.zeros(sum(el.space_dimension() for el in e["tzoo"]))
    for el, t, (lo, hi, _) in zip(e["tzoo"], tables, tb.slices):
        if el.is_macroelement():
            off[lo:hi] = np.abs(t[zero] - el.tabulate(0, pts)[zero]).max()
    if moments:
        want = np.asarray(jmo.moment_rows(bt, jnp.asarray(pts), jnp.asarray(wf)))
        got = tmo.moment_rows(tb, pts, wf).numpy()
        assert got.shape == want.shape
        assert (np.abs(got - want) <= (RTOL_DUAL * big + off) * wf.sum()).all()
    c = rng.random(len(off)) - 0.5
    wi = np.asarray(jmo.interpolate_rows(bt, jnp.asarray(pts), jnp.asarray(c)))
    ui = tmo.interpolate_rows(tb, pts, c).numpy()
    assert np.abs(ui - wi).max() <= RTOL_DUAL * big * np.abs(c).sum() + off @ np.abs(c)
    return tb._moment_engine


@pytest.mark.parametrize("sd", [1, 2, 3], ids=CELLS.get)
def test_moments_and_interpolation_match_fiat_tpu(engines, sd):
    """``moment_rows`` (K45's generic stage, plain) and
    ``interpolate_rows`` (K1) against fiat_tpu's ``ops.moments`` on the
    CPU, at RTOL_DUAL of max(1, max |table|) times the sum of the weights
    (moments) or of |c| (interpolation)."""
    eng = _dual_check(engines[sd, "plain"])
    assert eng.moments.generic and eng.moments.plain_smem_rows == eng.moments.nplain
    assert eng.moments.launches == eng.recurrence.launches == 0


def _random_dual_check(e):
    """Moments and interpolation on ``random_macro``'s order-0 rows against
    fiat_tpu on the same arrays, at RTOL_DUAL of max(1, max |table|) times
    the sum of the weights (or of |c|): interpolation against fiat_tpu's
    ``interpolate_rows`` (on the CPU it folds c through the programs' tall
    matrices and evaluates their masked parent pairs); moments against
    ``moment_rows`` on the plain rows and, on the macro rows, against
    fiat_tpu's program's value rows times its masked parent stack times
    the weights (its device route's sum: its CPU route tabulates the split
    basis, which the random rows replace)."""
    jbt, tbt = e[0]
    pts = e["pts"]
    rng = np.random.default_rng(len(pts) + 1)
    wf = rng.random(len(pts))
    big = max(1.0, np.abs(tbt(pts)[(0,) * pts.shape[1]].numpy()).max())
    want = np.array(jmo.moment_rows(jbt, jnp.asarray(pts), jnp.asarray(wf)))
    for p in jbt.macro_programs:
        v = p.tall[:p.rows] @ (np.asarray(p.b_stack(jnp.asarray(pts), 0)) @ wf)
        for idx, lo, hi in p.row_slices:
            r0 = tbt.slices[idx][0]
            want[r0:r0 + hi - lo] = v[lo:hi]
    got = tmo.moment_rows(tbt, pts, wf).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL_DUAL * big * wf.sum()
    c = rng.random(len(want)) - 0.5
    wi = np.asarray(jmo.interpolate_rows(jbt, jnp.asarray(pts), jnp.asarray(c)))
    ui = tmo.interpolate_rows(tbt, pts, c).numpy()
    assert np.abs(ui - wi).max() <= RTOL_DUAL * big * np.abs(c).sum()
    return tbt._moment_engine


@pytest.mark.parametrize("sd", [1, 2, 3], ids=CELLS.get)
def test_macro_dual_matches_fiat_tpu(engines, random_macro, sd):
    """The Alfeld elements through dual evaluation: interpolation on K1 and
    K3's one-row generic stage, moments on K45's generic stage with the
    masked sums, on random rows against fiat_tpu (``_random_dual_check``);
    the collocation zoos of the triangle and the tetrahedron, which keep
    digits of the host's, against fiat_tpu's CPU path and the host
    (``_dual_check``; moments on the triangle)."""
    eng = _random_dual_check(random_macro[sd])
    mo = merged_macro(eng)
    assert mo.generic and mo.plan_one is not None and eng.moments.generic
    if sd > 1:
        eng = _dual_check(engines[sd, "macro"], moments=sd < 3)
        assert merged_macro(eng).generic


@pytest.mark.parametrize("sd,degree", [(2, 20), (3, 14)], ids=["tri-20", "tet-14"])
def test_element_tabulator_matches_fiat_tpu(sd, degree):
    """``ElementTabulator`` on GLL Lagrange at the top of the range (K1's
    generic stage + K2) against fiat_tpu's ``ElementTabulator`` and the
    host."""
    if jfe is None:
        pytest.skip("needs fiat_tpu and JAX")
    t = ft.Lagrange(tcl.ufc_simplex(sd), degree, variant="gll")
    j = jfe.Lagrange(jcl.ufc_simplex(sd), degree, variant="gll")
    pts = _points(sd, NPTS, degree)
    tab = ElementTabulator(t, 1, device="cpu")
    mine = tab(pts)
    ref = JElementTabulator(j, 1)(jnp.asarray(pts))
    host = t.tabulate(1, pts)
    assert tab.recurrence.generic and set(mine) == set(ref) == set(host)
    for a, h in host.items():
        x, y = mine[a].numpy(), np.asarray(ref[a])
        assert _scaled(x, y) <= RTOL_TABLES, a
        assert _scaled(x, h) <= RTOL_HOST, a


def test_element_tabulator_interval_against_host():
    """GLL Lagrange 30 on the interval: fiat_tpu's ``ElementTabulator``
    cannot trace the interval's numpy nodal basis; the port's against the
    host."""
    el = ft.Lagrange(tcl.ufc_simplex(1), 30, variant="gll")
    pts = _points(1, NPTS, 30)
    tab = ElementTabulator(el, 1, device="cpu")
    mine = tab(pts)
    for a, h in el.tabulate(1, pts).items():
        assert _scaled(mine[a].numpy(), h) <= RTOL_HOST, a
    assert tab.recurrence.generic


# -- what the wrappers decide on the host --------------------------------------------

def test_k45_generic_shared_memory_layout():
    """K45's generic instantiation keeps one double a plain row a warp (its
    plain sums by member) after the piece sums; the unrolled ones none."""
    es = texp.ExpansionSet(tcl.ufc_simplex(2))
    amap = es.affine_mappings[0]
    gen = PairMoments(20, 231, 1.0, amap, device="cpu")
    unrolled = PairMoments(10, 66, 1.0, amap, device="cpu")
    assert gen.generic and not unrolled.generic
    assert (gen.plain_smem_rows, unrolled.plain_smem_rows) == (231, 0)
    assert warp_doubles(0, 0, 0, 231) - warp_doubles(0, 0, 0) == 232
    assert gen.smem == block_smem(gen.warps, 0, 0, 0, 231) and gen.warps == 8
    assert gen.dconsts is not None and unrolled.dconsts is None


@pytest.mark.parametrize("sd,degree,itemsize,tp", [
    (2, 20, 8, 64), (2, 20, 4, 128), (3, 14, 8, 32), (3, 14, 4, 64), (3, 11, 4, 128),
    (1, 30, 8, 128)])
def test_k3_generic_plan_narrows_the_point_tile(sd, degree, itemsize, tp):
    """K3's generic plan takes the widest of GENERIC_TILES whose Phi tile
    (members + 1 rows) leaves room for a ring: triangle 20 in f64 at 64
    points (128 would need 237 KB), tet 14 at 32 in f64 (348 KB at 64) and
    64 in f32."""
    n = math.comb(degree + sd, sd)
    cell = tcl.ufc_simplex(sd)
    rng = np.random.default_rng(degree)
    dtype = torch.float64 if itemsize == 8 else torch.float32
    mo = MacroOneShot(A=rng.standard_normal((5, 2 * n)), pieces=[(0, n), (1, n)],
                      geom=[{"maps": [cell.barycentric_map(rescale=True)] * 2, "unique": False,
                             "rows": (0, 5)}],
                      parent_map=cell.barycentric_map(rescale=True), degree=degree, scale=1.0,
                      affine_map=(2 * np.eye(sd), -np.ones(sd)), device="cpu", dtype=dtype)
    assert mo.generic and mo.plan[0] == tp and mo.smem <= MAX_SMEM
    wider = [t for t in GENERIC_TILES if t > tp]
    assert all(mo.plan_for(*mo._plan_args(False, t)) is None for t in wider)
    assert smem_bytes(n, itemsize, tp, 0, mo.words, 0) < mo.smem


def test_one_shot_applies_follows_k3s_plans():
    """The f64 engine takes K3 on a triangle parent of at most 32 subcells
    where K3's tables have a plan at the parent degree (the generic stage
    past 10), and K7 where none fits (degree 45: 1082 Phi rows at 32
    points pass a block's shared memory)."""
    zoo = _zoo(ft, tcl, MACRO[2], 2)
    bt = BatchedTabulator(zoo, order=1, device="cpu")
    merged = merge_group(bt.macro_programs, 1)
    assert merged["degree"] == 12 and one_shot_applies(merged)
    wide = dict(merged, degree=45, pieces=[(c, 1081) for c, _ in merged["pieces"]])
    assert not one_shot_applies(wide)


# -- the refusals that remain --------------------------------------------------------

def test_k2_refuses_past_792_at_construction():
    """Tet degree 15 (816 members) is past the 792 whose Phi tile K2 keeps
    resident: engine construction no longer raises, K2 streams Phi in k
    (``tests/test_torch_wide.py`` holds it to fiat_tpu)."""
    tab = device_tabulator([ft.Lagrange(tcl.ufc_simplex(3), 15)], order=1, device="cpu")
    assert tab.matmul.mode == "streamed" and tab.matmul.max_k == 816
    assert BucketMatmul([np.ones((2, 816))], device="cpu").mode == "streamed"
    assert BucketMatmul([np.ones((2, 792))], device="cpu").mode == "resident"


def test_k3_refuses_where_no_plan_fits():
    """Triangle parent degree 45 in f64 (1081 members): even 32 points of
    its Phi tile pass a block's shared memory, so K3 raises at
    construction, naming the Phi tile's rows and the shared memory."""
    n = math.comb(47, 2)
    cell = tcl.ufc_simplex(2)
    with pytest.raises(NotImplementedError, match=f"K3: a Phi tile of {n} rows .* {MAX_SMEM} "
                                                  "bytes of shared memory"):
        MacroOneShot(A=np.ones((2, n)), pieces=[(0, n)],
                     geom=[{"maps": [cell.barycentric_map(rescale=True)], "unique": False,
                            "rows": (0, 2)}],
                     parent_map=cell.barycentric_map(rescale=True), degree=45, scale=1.0,
                     affine_map=(2 * np.eye(2), -np.ones(2)), device="cpu")


def test_k6_refuses_where_no_plan_fits():
    """A Phi tile past 842 rows leaves no room for a ring of A at 64 points:
    K6 no longer raises, it takes its wide mode (Phi through device memory,
    streamed in k; ``tests/test_torch_wide.py``)."""
    es = texp.ExpansionSet(tcl.ufc_simplex(2))
    k6 = ZooF32Kernel([np.ones((2, 861))], 40, 1.0, es.affine_mappings[0], device="cpu")
    assert k6.mode == "wide" and k6.kpad == 862 and k6.plan == ZooF32Kernel.wide_plan(862)[0]


@pytest.mark.parametrize("sd,top", [(1, 26), (2, 17), (3, 15)])
def test_k8_keeps_its_own_degrees(sd, top):
    """K8 takes fiat_tpu's degrees (26 / 17 / 15, the generic instantiation
    past 15 / 15 / 10): ``features="bernstein"`` raises by name past them,
    where fiat_tpu's K8 refuses."""
    cell = tcl.ufc_simplex(sd)
    A, c = cell.barycentric_map()
    assert BernsteinFeatures(sd, top, (A, c), device="cpu").generic
    with pytest.raises(NotImplementedError, match=f"Bernstein degree {top + 1} outside 0..{top}"):
        BernsteinFeatures(sd, top + 1, (A, c), device="cpu")
    if sd == 1:     # the engine's Bernstein route (K1 would take the degree)
        bt = BatchedTabulator([ft.Lagrange(cell, top + 1)], order=0, device="cpu")
        with pytest.raises(NotImplementedError, match=f"outside 0..{top}"):
            FusedZooTabulator(bt, device="cpu", features="bernstein")


# -- on the card ------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sd,degree", [(1, 16), (1, 30), (2, 16), (2, 20), (3, 11), (3, 14)])
def test_k1_generic_on_card_matches_plain(sd, degree, cuda):
    es = texp.ExpansionSet(tcl.ufc_simplex(sd))
    rec = DubinerRecurrence(sd, degree, float(es.get_scale(degree)), es.affine_mappings[0], cuda)
    pts = torch.as_tensor(_points(sd, 20_001, degree), device=cuda)
    got = rec(pts)
    torch.cuda.synchronize()
    want = rec.plain(pts)
    assert rec.generic and rec.launches == 1
    assert ((got - want).abs().max() / want.abs().max()).item() <= RTOL_PLAIN


def _row_scale(A, B):
    """Per row of A B, max over the points of |A_r| |B|: the scale its sums
    round at."""
    return (A.double().abs() @ B.double().abs()).amax(dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("sd", [1, 2, 3], ids=CELLS.get)
def test_k3_generic_on_card_matches_plain(sd, dtype, cuda):
    """K3's generic stage (the Alfeld zoos' merged programs, parent degree
    20 / 12 / 11) against its plain version, its tables and one row a
    program, each row to 1e-13 (f64) or 1e-5 (float32) of its max |A_r| |B|:
    the extension of the subcell polynomials cancels far below it."""
    bt = BatchedTabulator(_zoo(ft, tcl, MACRO[sd], sd), order=1, device="cpu")
    st = bt.state()
    merged = merge_group(st["macro_programs"], 1)
    mo = MacroOneShot(**merged, device=cuda, dtype=dtype)
    P = torch.as_tensor(_points(sd, 20_001, sd), device=cuda).to(dtype)
    rtol = RTOL_PLAIN if dtype == torch.float64 else RTOL_F32_KERNEL
    B = mo.operand(P)[0]
    W = torch.as_tensor(np.random.default_rng(sd).random((len(mo.geom), mo.K)) - 0.5,
                        device=cuda).to(dtype)
    for A, args in ((mo.A, ()), (W, (W,))):
        got, want = mo(P, *args), mo.plain(P, *args)
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs().amax(dim=1)
        assert (err <= rtol * _row_scale(A, B)).all()
    assert mo.generic and mo.launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("sd", [1, 2, 3], ids=CELLS.get)
def test_k45_and_k6_generic_on_card_match_plain(sd, cuda):
    """K45's generic stage (with the Alfeld zoo's masked sums) to 1e-13 of
    max |plain|, two calls bit for bit; K6's generic stage on the plain zoo
    to 1e-5 of each row's max |A_r| |Phi|."""
    zoo = _zoo(ft, tcl, PLAIN[sd] + MACRO[sd][1:], sd)
    pm = tmo.MomentEngine(BatchedTabulator(zoo, order=0, device=cuda), device=cuda).moments
    P = torch.as_tensor(_points(sd, 100_001, sd), device=cuda)
    wf = torch.as_tensor(np.random.default_rng(44).random(P.shape[0]) - 0.5, device=cuda)
    got, again, want = pm(P, wf), pm(P, wf), pm.plain(P, wf)
    torch.cuda.synchronize()
    assert pm.generic and pm.launches == 2 and torch.equal(got, again)
    assert ((got - want).abs().max() / want.abs().max()).item() <= RTOL_PLAIN
    f32 = device_tabulator(_zoo(ft, tcl, PLAIN[sd], sd), order=1, f64=False)
    k6 = f32.kernel
    P32 = P[:20_001].float()
    out = torch.zeros((k6.total_rows, P32.shape[0]), device=cuda)
    got = k6(P32, f32.dst_plain, out).clone()
    want = k6.plain(P32, f32.dst_plain, torch.zeros_like(out))
    torch.cuda.synchronize()
    scale = _row_scale(k6.A.to(cuda), k6.phi(P32)[:k6.max_k])
    dst = f32.dst_plain.long()
    assert k6.generic and k6.launches == 1
    assert ((got - want).abs()[dst].amax(dim=1) <= RTOL_F32_KERNEL * scale).all()


@pytest.mark.cuda
@pytest.mark.parametrize("sd", [1, 2, 3], ids=CELLS.get)
def test_generic_entry_points_on_card_one_launch_each(sd, cuda):
    """Every engine on the plain and macro zoos of a cell: one launch of
    each kernel a pass, each generic; on the plain zoo the tables, moments
    and interpolation equal to the CPU's plain engine's (f64 and dual at
    1e-12 of max(1, max |table|), f32 at RTOL_F32_KERNEL of max abs + 1);
    on the macro zoo the plain elements' rows alike (its macro stages are
    held to their plain versions above, row by row)."""
    for name in ("plain", "macro"):
        specs = PLAIN[sd] if name == "plain" else MACRO[sd]
        zoo = _zoo(ft, tcl, specs, sd)
        pts = _points(sd, 3001, sd)
        P = torch.as_tensor(pts, device=cuda)
        tab = device_tabulator(zoo, order=1)
        cpu = device_tabulator(zoo, order=1, device="cpu")
        got, want = tab(P), cpu(pts)
        torch.cuda.synchronize()
        assert tab.recurrence.launches == tab.matmul.launches == 1
        if merged_macro(tab) is None:
            assert tab.recurrence.generic
        else:   # K3's generic stage, or on the tet K7 over K1's generic Phi
            assert merged_macro(tab).launches == 1
            mo = merged_macro(tab)
            assert (mo.generic if mo.name == "K3" else tab.recurrence.generic)
        pr = sum(hi - lo for (lo, hi, _), el in zip(cpu.slices, zoo) if not el.is_macroelement())
        for a in want:
            assert _scaled(got[a][:pr].cpu().numpy(), want[a][:pr].numpy()) <= 1e-12, (name, a)
        f32 = device_tabulator(zoo, order=1, f64=False)
        g32, w32 = f32.tables(P.float()), device_tabulator(zoo, order=1, f64=False,
                                                           device="cpu").tables(pts)
        assert f32.kernel.launches == 1 and (f32.kernel.generic or name == "macro")
        for a in w32:
            g, w = g32[a][:pr].cpu().numpy(), w32[a][:pr].numpy()
            assert np.abs(g - w).max() <= RTOL_F32_KERNEL * (np.abs(w).max() + 1.0), (name, a)
            assert np.isfinite(g32[a].cpu().numpy()).all()
        bt, btc = BatchedTabulator(zoo, order=0), BatchedTabulator(zoo, order=0, device="cpu")
        wf = np.random.default_rng(5).random(len(pts))
        m, mc = tmo.moment_rows(bt, P, torch.as_tensor(wf, device=cuda)), tmo.moment_rows(
            btc, pts, wf)
        eng = bt._moment_engine
        assert eng.moments.launches == 1 and eng.moments.generic
        assert _scaled(m[:pr].cpu().numpy(), mc[:pr].numpy()) <= 1e-12
        c = np.random.default_rng(6).random(mc.shape[0]) - 0.5
        u = tmo.interpolate_rows(bt, P, torch.as_tensor(c, device=cuda))
        assert eng.recurrence.launches == 1
        if eng.macros:
            assert merged_macro(eng).launches == 1 and merged_macro(eng).generic
        else:
            uc = tmo.interpolate_rows(btc, pts, c)
            assert _scaled(u.cpu().numpy(), uc.numpy()) <= 1e-12
