"""K3's sd = 3 stage (``ops/macro_oneshot.MacroOneShot`` on a tetrahedral
parent) against fiat_tpu on the CPU: its plain version against fiat_tpu's
one-shot kernel ``FusedMacroOneShot`` built by hand at sd = 3 (as
tests/test_device_ops.py builds it at sd = 2) in interpret mode, against
fiat_tpu's interpreted K7 path and host tabulation, a replay of the
kernel's loop on its chunk tables and packed constants, and the two paths
it opens: the f32 tables and the interpolation of tetrahedral macro zoos.
Also the C1 macro zoos of bench.py on K3's sd = 2 stage.

Inputs are numpy arrays made from seeds and handed to both packages;
fiat_tpu's Pallas kernels run in interpret mode, as its own tests run them."""

import math
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fiat_tpu import elements as jfe
from fiat_tpu.core import cells as jcl
from fiat_tpu.ops import moments as jmo
from fiat_tpu.ops.pallas_multiword import FusedMacroOneShot
from fiat_tpu.ops.pallas_multiword import FusedZooTabulator as JFusedZooTabulator
from fiat_tpu.ops.pallas_tabulate import PallasZooTabulator
from fiat_tpu.ops.tabulate import BatchedTabulator as JBatchedTabulator
from fiat_tpu_torch import device_tabulator
from fiat_tpu_torch import elements as tfe
from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.core import macro as tmacro
from fiat_tpu_torch.ops import moments as tmo
from fiat_tpu_torch.ops.f32_zoo import F32ZooTabulator
from fiat_tpu_torch.ops.fused_zoo import _merge_macro_programs
from fiat_tpu_torch.ops.macro_oneshot import (CHUNK_ROWS, COLUMN_STRIDE, GENERIC_TILES, MAX_SMEM,
                                              RESIDENT_SMEM, MacroOneShot, ceil16, chunk_table,
                                              one_shot_applies, smem_bytes)
from fiat_tpu_torch.ops.moments import MomentEngine
from fiat_tpu_torch.ops.tabulate import BatchedTabulator
from chip_smoke import merged_macro

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_k3_tri import _replay_k3  # noqa: E402
from test_torch_tet_dual import _points, _tie_points  # noqa: E402

RTOL_INTERPRET = 1e-5   # fiat_tpu's one-shot kernel in interpret mode (its own CPU bar)
ATOL_FIAT = 1e-11       # fiat_tpu's interpreted K7 path: 9.2e-12 from host itself
ATOL_HOST = 1e-10       # f64 tables vs host el.tabulate (the BASELINE.json metric)
ATOL_DUAL = 1e-12       # interpolation vs host
ATOL_FIAT_DUAL = 2e-12  # vs fiat_tpu's f64 path, itself 1.04e-12 from host here
RTOL_REPLAY = 1e-13     # the kernel's loop vs the plain version: the order of sums differs
RTOL_F32 = 5e-6         # fiat_tpu's f32 bar (tests/test_device_ops.py:143-144)
MACRO_TOL = 5e-5        # its macro bar, relative to max abs + 1 (:586-589)


def sv_macro_tet(fe, T):
    """The Scott-Vogelius pairs: P3 / DG2 on Alfeld splits, P2 / DG1 on
    Worsey-Farin splits, beside the unsplit P1 and P3."""
    return [fe.Lagrange(T, 1), fe.Lagrange(T, 3), fe.Lagrange(T, 3, variant="alfeld"),
            fe.DiscontinuousLagrange(T, 2, variant="alfeld"),
            fe.Lagrange(T, 2, variant="worsey-farin"),
            fe.DiscontinuousLagrange(T, 1, variant="worsey-farin")]


def _sv_small(fe, T):
    """P2 / DG1 on both splits beside P1: 4 programs over 32 subcells."""
    return [fe.Lagrange(T, 1), fe.Lagrange(T, 2, variant="alfeld"),
            fe.DiscontinuousLagrange(T, 1, variant="alfeld"),
            fe.Lagrange(T, 2, variant="worsey-farin"),
            fe.DiscontinuousLagrange(T, 1, variant="worsey-farin")]


def _k3(zoo, order, dtype=torch.float64):
    """K3 on the merged macro programs of a port zoo (the CPU: its plain
    version)."""
    st = BatchedTabulator(zoo, order=order, device="cpu").state()
    merged = _merge_macro_programs(st["macro_programs"], st["scale"], st["affine_map"], order)
    return MacroOneShot(**merged, device="cpu", dtype=dtype)


def _max_diff(ref_tabs, got_tabs):
    return max(float(np.abs(np.asarray(r[a]) - np.asarray(g[a])).max())
               for r, g in zip(ref_tabs, got_tabs) for a in r)


@pytest.mark.parametrize("order", [0, 1])
def test_k3_sd3_plain_matches_fiat_tpu_oneshot_interpreted(order):
    """fiat_tpu's FusedMacroOneShot at sd = 3, built from its own macro
    programs as tests/test_device_ops.py:776-838 builds it at sd = 2, in
    interpret mode: its EFT pairs lose precision on XLA:CPU, so the bar is
    its own CPU bar (f32 level)."""
    pts = _points(200, 21)
    bt = JBatchedTabulator(_sv_small(jfe, jcl.ufc_simplex(3)), order=order)
    rec_deg = max(p.degree for p in bt.macro_programs)
    t_es = bt.target_es
    A = np.zeros((sum(p.tall.shape[0] for p in bt.macro_programs),
                  sum(p.K for p in bt.macro_programs)))
    geom, pieces, r0, c0 = [], [], 0, 0
    for p in bt.macro_programs:
        ref = p.es.ref_el
        geom.append({"maps": [ref.barycentric_map(entity=(3, c), rescale=True) for c in p.cells],
                     "unique": p.es.continuity is not None and order == 0,
                     "rows": (r0, r0 + p.tall.shape[0])})
        ratio = float(np.asarray(p.parent_es.get_scale(p.degree))
                      / np.asarray(t_es.get_scale(rec_deg)))
        A[r0:r0 + p.tall.shape[0], c0:c0 + p.K] = ratio * p.tall
        pieces += [(len(pieces) + i, p.nexp_parent) for i in range(len(p.cells))]
        r0, c0 = r0 + p.tall.shape[0], c0 + p.K
    parent_map = bt.macro_programs[0].es.ref_el.get_parent().barycentric_map(rescale=True)
    scale = float(np.asarray(t_es.get_scale(rec_deg, cell=0)))
    osk = FusedMacroOneShot(A, pieces, geom, parent_map, 3, rec_deg, scale, interpret=True,
                            wdtype="bf16", point_tile=256)
    hi, lo = jax.jit(lambda q: osk.apply_pair_points(q))(jnp.asarray(pts))
    want = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)

    mo = _k3(_sv_small(tfe, tcl.ufc_simplex(3)), order)
    assert mo.sd == 3 and (mo.rows, mo.K, len(mo.nexp)) == (A.shape[0], A.shape[1], 32)
    assert np.array_equal(mo.A.numpy(), A)
    assert [g["unique"] for g in mo.geom] == [g["unique"] for g in geom]
    got = mo(torch.as_tensor(pts)).numpy()
    assert mo.launches == 0
    assert np.abs(got - want).max() <= RTOL_INTERPRET * np.abs(want).max()


@pytest.mark.parametrize("order", [0, 1])
def test_k3_sd3_in_the_f64_engine_matches_fiat_tpu_k7_path_and_host(order):
    """sv_macro_tet with K3's sd = 3 stage in place of K7 in the f64 engine:
    against K7 on the same arrays (1e-13), fiat_tpu's interpreted engine
    (its merged masked kernel) on random points, and host tabulation on
    those and the tie points (fiat_tpu's windowed K7 path is itself
    9.2e-12 from host on random points, so the tie points are held to host
    and to K7)."""
    T, J = tcl.ufc_simplex(3), jcl.ufc_simplex(3)
    rand = _points(200, 42)
    pts = np.vstack([rand, _tie_points()])
    jzoo, tzoo = sv_macro_tet(jfe, J), sv_macro_tet(tfe, T)
    jfz = JFusedZooTabulator(JBatchedTabulator(jzoo, order=order), interpret=True,
                             row_block=256, point_tile=256)
    ref = jfz.unpack(jfz.block_tables(jnp.asarray(rand)))

    tab = device_tabulator(tzoo, order=order, device="cpu")
    k7, rec = merged_macro(tab), tab.recurrence
    assert k7.name == "K7"
    k3 = MacroOneShot(k7.A.numpy(), list(enumerate(k7.nexp)), k7.geom, k7.parent_map,
                      rec.degree, rec.scale, (rec.A, rec.b), device="cpu")
    P = torch.as_tensor(pts)
    want = k7(P, rec(P))
    got = k3(P)
    assert (got - want).abs().max().item() <= RTOL_REPLAY * want.abs().max().item()
    # the engine with K3 in K7's place on its route: the same block_tables call
    route = tab.macro_routes[0]
    route.engine, route.name = k3, "K3"
    tables = tab.unpack(tab.block_tables(pts))
    assert k3.launches == 0
    n = len(rand)
    assert _max_diff(ref, [{a: t[..., :n] for a, t in g.items()} for g in tables]) <= ATOL_FIAT
    assert _max_diff([el.tabulate(order, pts) for el in tzoo], tables) <= ATOL_HOST


@pytest.mark.parametrize("where", ["random", "tie"])
@pytest.mark.parametrize("order", [0, 1])
def test_k3_sd3_kernel_loop_on_its_chunk_table_matches_plain(order, where):
    """The kernel cannot run here: its loop (the one template of both
    parents, replayed as test_torch_k3_tri does), on the chunk tables, the
    shared-memory offsets and the packed constants, equals the plain
    version, on random points and on tie points (the first hit of each C0
    program at order 0, 1 / hits elsewhere), for the merged tables and for
    one row per program (the interpolation's W: every program's one-row
    chunk in one block)."""
    mo = _k3(sv_macro_tet(tfe, tcl.ufc_simplex(3)), order)
    assert (mo.rows, mo.K) == ((158, 288) if order == 0 else (632, 288))
    assert mo.chunks.shape[0] == sum(-(-(g["rows"][1] - g["rows"][0]) // CHUNK_ROWS)
                                     for g in mo.geom) == (8 if order == 0 else 21)
    assert tuple(mo.chunks_one.shape) == (4, 4) and mo.chunks_one[:, 2].tolist() == [1] * 4
    assert (mo.cpb, mo.cpb_one) == (1, 4)
    pts = _points(150, 23 + order) if where == "random" else _tie_points()
    P = torch.as_tensor(pts)
    want = mo(P).numpy()
    assert np.abs(_replay_k3(mo, pts) - want).max() <= RTOL_REPLAY * np.abs(want).max()
    # row g of W holds program g's columns alone, as the interpolation's does
    W = np.random.default_rng(order).standard_normal((len(mo.geom), mo.K))
    W *= np.repeat(np.eye(len(mo.geom)), [sum(mo.nexp[c0:c1]) for _, _, c0, c1, _ in
                                          mo.progs.numpy()], axis=1)
    want = mo(P, A=torch.as_tensor(W)).numpy()
    assert np.abs(_replay_k3(mo, pts, W) - want).max() <= RTOL_REPLAY * np.abs(want).max()


def test_k3_sd3_chunks_fit_shared_memory_and_the_precondition():
    """sv_macro_tet's largest chunk (the Worsey-Farin programs: 12 pieces of
    10 columns, 32.6 KB in f64) and its Phi tile (20 members x 128 points,
    20 KB) fit a block, so every chunk stays resident; K3 takes tets for the
    f32 tables and interpolation, and the f64 engine keeps K7 there
    (one_shot_applies)."""
    mo = _k3(sv_macro_tet(tfe, tcl.ufc_simplex(3)), 1)
    assert mo.plan == (128, 12 * 10, 1, True)
    ring = 12 * 10 * COLUMN_STRIDE
    assert mo.layout()["ring"] == ring and mo.smem == smem_bytes(20, 8, 128, ring, 1, 0)
    assert mo.smem <= MAX_SMEM
    assert mo.chunks[:, 3].tolist() == [20] * 5 + [10] * 10 + [4] * 6
    assert mo.consts.shape[0] == 4 * (4 + 10 + 20) and mo.slots.shape[0] == 20
    st = BatchedTabulator(sv_macro_tet(tfe, tcl.ufc_simplex(3)), order=1, device="cpu").state()
    merged = _merge_macro_programs(st["macro_programs"], st["scale"], st["affine_map"], 1)
    assert not one_shot_applies(merged)
    assert merged_macro(device_tabulator(sv_macro_tet(tfe, tcl.ufc_simplex(3)), order=1,
                                         device="cpu")).name == "K7"
    chunks = chunk_table(np.array([[0, 70, 0, 2, 0]]), np.array([[0, 9], [9, 4]]))
    assert chunks.tolist() == [[0, 0, 32, 9], [0, 32, 32, 9], [0, 64, 6, 9]]


def test_k3_sd3_wrapper_checks_and_limits():
    mo = _k3(_sv_small(tfe, tcl.ufc_simplex(3)), 0)
    P = torch.as_tensor(_points(10, 1))
    with pytest.raises(ValueError, match=r"points must have shape \(npts, 3\), got \(10, 2\)"):
        mo(P[:, :2].contiguous())
    with pytest.raises(TypeError, match="float64"):
        mo(P.float())
    with pytest.raises(ValueError, match="A must be contiguous of shape"):
        mo(P, A=torch.zeros((3, mo.K), dtype=torch.float64))
    with pytest.raises(ValueError, match="engine on cpu"):
        mo(P.to("meta"))
    assert mo.launches == 0
    args = dict(A=mo.A.numpy(), pieces=list(enumerate(mo.nexp)), geom=mo.geom,
                parent_map=mo.parent_map, scale=mo.scale,
                affine_map=(mo.affine[:9].reshape(3, 3), mo.affine[9:]), device="cpu")
    # parent degree 11, past the unrolled 10, computes on the generic
    # instantiation: the pieces read the same leading members of the
    # degree-11 recurrence (same scale), so the tables are the same
    gen = MacroOneShot(degree=11, **args)
    assert gen.generic and gen.tiles == GENERIC_TILES and gen.plan is not None
    want = mo(P)
    assert np.abs(gen(P).numpy() - want.numpy()).max() <= 1e-13 * np.abs(want.numpy()).max()


@pytest.mark.parametrize("dtype,subcells,degree,fits", [
    (torch.float64, 4, 6, True), (torch.float64, 4, 7, False), (torch.float64, 12, 4, True),
    (torch.float64, 12, 5, False), (torch.float32, 4, 8, True), (torch.float32, 12, 6, True),
    (torch.float32, 12, 7, False), (torch.float64, 4, 10, False)])
def test_k3_sd3_streams_a_chunk_and_tile_past_shared_memory(dtype, subcells, degree, fits):
    """One program of ``subcells`` pieces of the degree's width: its chunk
    and the Phi tile fit a block's 227 KB, or not (``fits``: the shapes the
    kernel refused before).  The chunk stays resident where the block
    takes at most RESIDENT_SMEM, and is streamed through a ring of slices
    where not; at degree 10 the Phi tile of 286 members x 128 points (293
    KB in f64) does not fit alone, so the plan takes 64 points.  Every plan
    fits a block and the kernel's loop under it equals the plain
    version."""
    split = tmacro.AlfeldSplit if subcells == 4 else tmacro.WorseyFarinSplit
    cell = split(tcl.ufc_simplex(3))
    n = math.comb(degree + 3, 3)
    maps = [cell.barycentric_map(entity=(3, c), rescale=True) for c in range(subcells)]
    rng = np.random.default_rng(degree)
    args = dict(A=rng.standard_normal((40, subcells * n)), pieces=[(c, n) for c in range(subcells)],
                geom=[{"maps": maps, "unique": False, "rows": (0, 40)}],
                parent_map=tcl.ufc_simplex(3).barycentric_map(rescale=True), degree=degree,
                scale=1.0, affine_map=(2 * np.eye(3), -np.ones(3)), device="cpu", dtype=dtype)
    mo = MacroOneShot(**args)
    size = 8 if dtype == torch.float64 else 4
    tp = 64 if degree == 10 else 128
    whole = ceil16(subcells * n * COLUMN_STRIDE * size) + (n + 1) * tp * size + 4 * tp
    assert fits == (whole <= MAX_SMEM) and mo.plan[0] == tp
    assert mo.plan[3] == (whole <= RESIDENT_SMEM)
    assert mo.smem <= MAX_SMEM and mo.smem_one <= MAX_SMEM
    pts = _points(20, degree)
    P = torch.as_tensor(pts).to(dtype)
    want = mo(P)
    assert tuple(want.shape) == (40, 20) and mo.launches == 0
    if dtype == torch.float64:
        got = _replay_k3(mo, pts)
        assert np.abs(got - want.numpy()).max() <= RTOL_REPLAY * np.abs(want.numpy()).max()


def test_tet_macro_f32_tables_match_fiat_tpu_pallas_interpret():
    """sv_macro_tet on the f32 engine: K6's sd = 3 stage for the plain rows,
    K3's float32 sd = 3 stage for the macro rows, against fiat_tpu's
    PallasZooTabulator in interpret mode (its macro side program on XLA)."""
    pts = np.vstack([_points(200, 25), _tie_points()])
    bt = JBatchedTabulator(sv_macro_tet(jfe, jcl.ufc_simplex(3)), order=1)
    want = PallasZooTabulator(bt, tile=256, interpret=True).tables(pts)
    tab = device_tabulator(sv_macro_tet(tfe, tcl.ufc_simplex(3)), order=1, f64=False,
                           device="cpu")
    assert tab.kernel.sd == merged_macro(tab).sd == 3 and merged_macro(tab).dtype == torch.float32
    got = tab.tables(pts)
    assert (tab.kernel.launches, merged_macro(tab).launches) == (0, 0)
    assert list(got) == list(want)
    pr = tab.plain_rows
    for a in want:
        w, g = np.asarray(want[a]), got[a].numpy()
        assert np.abs(g[:pr] - w[:pr]).max() <= RTOL_F32 * np.abs(w[:pr]).max(), a
        assert np.abs(g[pr:] - w[pr:]).max() <= MACRO_TOL * (np.abs(w[pr:]).max() + 1.0), a


def test_same_subcells_marks_the_float32_binning_band():
    """A point 3e-6 off an Alfeld interior face is taken by both subcells in
    float32 (tolerance 1e-5) and by one in float64: there the f32 tables
    average, by design; 1e-3 off, and exactly on the face, both agree."""
    mo = _k3(sv_macro_tet(tfe, tcl.ufc_simplex(3)), 1, torch.float32)
    on_face = (np.array([1.0, 0.0, 0.0]) + np.full(3, 0.25)) / 3     # vertices 0, 1 and the centre
    normal = np.array([0.0, -1.0, 1.0]) / np.sqrt(2.0)
    pts = np.stack([on_face, on_face + 3e-6 * normal, on_face + 1e-3 * normal])
    assert mo.same_subcells(torch.as_tensor(pts)).tolist() == [True, False, True]
    assert bool(mo.same_subcells(torch.as_tensor(_tie_points())).all())


def test_tet_macro_interpolation_matches_fiat_tpu_and_host_without_k45():
    """sv_macro_tet's interpolation: K1 for the plain rows, K3's sd = 3
    stage on one folded row per program; K45 is never built."""
    tzoo = sv_macro_tet(tfe, tcl.ufc_simplex(3))
    pts = np.vstack([_points(200, 27), _tie_points()])
    jbt = JBatchedTabulator(sv_macro_tet(jfe, jcl.ufc_simplex(3)), order=0)
    rows = max(hi for _, hi, _ in jbt.slices)
    c = np.random.default_rng(28).random(rows) - 0.5
    want = np.asarray(jmo.interpolate_rows(jbt, jnp.asarray(pts), jnp.asarray(c)))
    tb = BatchedTabulator(tzoo, order=0, device="cpu")
    got = tmo.interpolate_rows(tb, pts, c).numpy()
    eng = tb._moment_engine
    assert eng.built == {"moments": False, "macro": True}
    assert merged_macro(eng).sd == 3 and merged_macro(eng).launches == eng.recurrence.launches == 0
    assert np.abs(got - want).max() <= ATOL_FIAT_DUAL
    host = np.zeros(len(pts))
    for el, (lo, hi, _) in zip(tzoo, tb.slices):
        host += c[lo:hi] @ el.tabulate(0, pts)[(0, 0, 0)].reshape(hi - lo, len(pts))
    assert np.abs(got - host).max() <= ATOL_DUAL


def test_from_arrays_on_fiat_tpu_macro_programs_runs_k3_sd3():
    """The f32 engine and the moments engine built from fiat_tpu's
    BatchedTabulator arrays of sv_macro_tet equal the port's own."""
    pts = np.vstack([_points(150, 29), _tie_points()])
    bt = JBatchedTabulator(sv_macro_tet(jfe, jcl.ufc_simplex(3)), order=1, matmul="native")
    common = dict(stacked=bt.stacked, slices=bt.slices, max_degree=bt.max_degree,
                  scale=float(bt.target_es.get_scale(bt.max_degree)),
                  affine_map=bt.target_es.affine_mappings[0], macro_programs=bt.macro_programs,
                  device="cpu")
    jtab = F32ZooTabulator.from_arrays(alpha_mats=bt.alpha_mats, plain_nexp=bt.plain_nexp,
                                       **common)
    ttab = device_tabulator(sv_macro_tet(tfe, tcl.ufc_simplex(3)), order=1, f64=False,
                            device="cpu")
    assert merged_macro(jtab).sd == 3
    got, want = jtab.tables(pts), ttab.tables(pts)
    for a in want:
        assert np.abs(got[a].numpy() - want[a].numpy()).max() <= 1e-6 * (
            np.abs(want[a].numpy()).max() + 1.0)
    bt0 = JBatchedTabulator(sv_macro_tet(jfe, jcl.ufc_simplex(3)), order=0)
    jeng = MomentEngine.from_arrays(**dict(common, stacked=bt0.stacked, slices=bt0.slices,
                                           macro_programs=bt0.macro_programs))
    teng = MomentEngine(BatchedTabulator(sv_macro_tet(tfe, tcl.ufc_simplex(3)), order=0,
                                         device="cpu"), device="cpu")
    c = np.random.default_rng(30).random(teng.rows) - 0.5
    assert np.abs(jeng.interpolate_rows(pts, c).numpy()
                  - teng.interpolate_rows(pts, c).numpy()).max() <= RTOL_REPLAY


def _c1_zoo(fe, T):
    """bench.py's c1_macro_zoo (:825-837): the C1 elements plus PS6 and PS12."""
    return [fe.CubicHermite(T), fe.Morley(T), fe.Argyris(T, 5), fe.Bell(T),
            fe.HsiehCloughTocher(T, 3), fe.QuadraticPowellSabin6(T),
            fe.QuadraticPowellSabin12(T)]


@pytest.mark.parametrize("order", [1, 2])
def test_c1_macro_zoos_take_k3_and_match_host(order):
    """c1_macro_zoo (order 1) and c1_macro_hessians (order 2) on K3's sd = 2
    stage: 21 subcells; the order-2 A (198 x 138, 213.5 KB in f64) is just
    under a block's shared memory."""
    T = tcl.ufc_simplex(2)
    zoo = _c1_zoo(tfe, T)
    tab = device_tabulator(zoo, order=order, device="cpu")
    mo = merged_macro(tab)
    assert mo.name == "K3" and mo.sd == 2 and len(mo.nexp) == 21
    assert (mo.rows, mo.K) == ((99, 138) if order == 1 else (198, 138))
    assert mo.rows * mo.K * 8 <= MAX_SMEM
    rng = np.random.default_rng(31)
    pts = rng.random((300, 2))
    pts = pts / (pts.sum(axis=1)[:, None] + 1e-9) * rng.random((300, 1))
    got = tab.unpack(tab.block_tables(pts))
    assert _max_diff([el.tabulate(order, pts) for el in zoo], got) <= ATOL_HOST
