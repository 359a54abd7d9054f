"""The f32 engine (``ops/f32_zoo.F32ZooTabulator``: K6's and K3's float32
plain versions) against fiat_tpu's ``PallasZooTabulator`` in interpret mode,
as fiat_tpu's own tests run it (tests/test_device_ops.py), and against the
port's float64 tables.  K6's host layout and plan on the CPU: a numpy replay
of the kernel's schedule on ``ZooF32Kernel``'s device arrays (the ring of A
chunks, row and point tiles, each lane's fragments and stores) against the
plain product, bit for bit on integers under every plan; the shared-memory
addresses of its fragments; the plan's shared memory at every degree.

Inputs are numpy arrays made from seeds and handed to both packages."""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fiat_tpu import elements as jfe
from fiat_tpu.core import cells as jcl
from fiat_tpu.core import expansions as jexp
from fiat_tpu.ops.pallas_tabulate import PallasZooTabulator
from fiat_tpu.ops.tabulate import BatchedTabulator as JBatchedTabulator
from fiat_tpu_torch import device_tabulator
from fiat_tpu_torch import elements as tfe
from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.core import expansions as texp
from fiat_tpu_torch.ops.f32_zoo import F32ZooTabulator, ZooF32Kernel
from fiat_tpu_torch.ops.tabulate import BatchedTabulator
from chip_smoke import merged_macro

RTOL = 5e-6         # fiat_tpu's f32 bar (tests/test_device_ops.py:143-144)
MACRO_TOL = 5e-5    # its macro bar, relative to max abs + 1 (:586-589)


def _rng(seed):
    return np.random.default_rng(seed)


def _nodal_zoo(fe, T):
    return [fe.Lagrange(T, p) for p in (1, 3, 5)] + [fe.RaviartThomas(T, 2)]


def _macro_zoo(fe, T):
    return [fe.CubicHermite(T), fe.Morley(T), fe.HsiehCloughTocher(T, 3),
            fe.QuadraticPowellSabin6(T)]


def _special_points():
    c = np.array([1.0, 1.0]) / 3.0
    ends = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [0.5, 0.5], [0.0, 0.5], [0.5, 0.0]])
    t = np.array([0.0, 0.125, 0.25, 0.5, 0.75])[:, None]
    return np.vstack([c[None]] + [v + t * (c - v) for v in ends])


def test_plain_rows_match_fiat_tpu_pallas_interpret():
    pts = _rng(0).random((700, 2)) / 2
    bt = JBatchedTabulator(_nodal_zoo(jfe, jcl.ufc_simplex(2)), order=0)
    want = np.asarray(PallasZooTabulator(bt, tile=256, interpret=True)(pts))
    tab = device_tabulator(_nodal_zoo(tfe, tcl.ufc_simplex(2)), order=0, f64=False, device="cpu")
    got = tab(pts)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert tab.kernel.launches == 0            # CPU tensors: the plain version
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= RTOL
    ref = np.asarray(bt(jnp.asarray(pts))[(0, 0)])
    assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() <= RTOL


@pytest.mark.parametrize("variant", ["bubble", "dual"])
def test_variant_recurrences_match_fiat_tpu_pallas_interpret(variant):
    """The same SimpleNamespace shim as fiat_tpu's variant test, triangle
    only: the identity change of basis on a degree-5 variant basis."""
    degree = 5
    es = jexp.ExpansionSet(jcl.ufc_simplex(2), variant=variant)
    nexp = es.get_num_members(degree)
    shim = SimpleNamespace(target_es=es, sd=2, max_degree=degree, alpha_mats={},
                           stacked=np.eye(nexp), special_progs=[], special=[], order=0)
    pts = _rng(1).random((260, 2)) / 2
    want = np.asarray(PallasZooTabulator(shim, tile=256, interpret=True)(pts))
    host = np.asarray(es.tabulate(degree, pts))
    tes = texp.ExpansionSet(tcl.ufc_simplex(2), variant=variant)
    tab = F32ZooTabulator.from_arrays(
        stacked=np.eye(nexp), alpha_mats={}, slices=[(0, nexp, (nexp,))], max_degree=degree,
        scale=float(tes.get_scale(degree)), affine_map=tes.affine_mappings[0], variant=variant,
        device="cpu")
    got = tab(pts).numpy()
    assert np.abs(got - want).max() / (np.abs(want).max() + 1.0) <= RTOL
    assert np.abs(got - host).max() / (np.abs(host).max() + 1.0) <= RTOL


def test_macro_zoo_matches_host_and_fiat_tpu_pallas_interpret():
    pts = np.vstack([_rng(2).random((300, 2)) / 2, _special_points()])
    bt = JBatchedTabulator(_macro_zoo(jfe, jcl.ufc_simplex(2)), order=1)
    want = PallasZooTabulator(bt, tile=256, interpret=True).tables(pts)
    tzoo = _macro_zoo(tfe, tcl.ufc_simplex(2))
    tab = device_tabulator(tzoo, order=1, f64=False, device="cpu")
    got = tab.tables(pts)
    assert list(got) == list(want)
    for a in want:
        w = np.asarray(want[a])
        assert np.abs(got[a].numpy() - w).max() / (np.abs(w).max() + 1.0) <= MACRO_TOL, a
    assert (tab.kernel.launches, merged_macro(tab).launches) == (0, 0)
    for el, t in zip(tzoo, BatchedTabulator(tzoo, order=1, device="cpu").unpack(got)):
        host = el.tabulate(1, pts)
        for a in host:
            err = np.abs(t[a].numpy().reshape(host[a].shape) - host[a]).max()
            assert err / (np.abs(host[a]).max() + 1.0) <= MACRO_TOL, (type(el).__name__, a)


def test_from_arrays_on_fiat_tpu_arrays_matches_the_ports():
    pts = np.vstack([_rng(3).random((200, 2)) / 2, _special_points()])
    jzoo = _nodal_zoo(jfe, jcl.ufc_simplex(2)) + _macro_zoo(jfe, jcl.ufc_simplex(2))
    tzoo = _nodal_zoo(tfe, tcl.ufc_simplex(2)) + _macro_zoo(tfe, tcl.ufc_simplex(2))
    bt = JBatchedTabulator(jzoo, order=1, matmul="native")
    jtab = F32ZooTabulator.from_arrays(
        stacked=bt.stacked, alpha_mats=bt.alpha_mats, slices=bt.slices,
        plain_nexp=bt.plain_nexp, max_degree=bt.max_degree,
        scale=float(bt.target_es.get_scale(bt.max_degree)),
        affine_map=bt.target_es.affine_mappings[0], macro_programs=bt.macro_programs, device="cpu")
    ttab = device_tabulator(tzoo, order=1, f64=False, device="cpu")
    got, want = jtab.tables(pts), ttab.tables(pts)
    for a in want:
        assert np.abs(got[a].numpy() - want[a].numpy()).max() <= 1e-6 * np.abs(
            want[a].numpy()).max()


@pytest.mark.parametrize("degree", [0, 1, 10])
def test_single_degrees_against_float64_tables(degree):
    """Lagrange / DG of one degree, values and first derivatives, against
    the port's float64 engine: degree 0 is the scale quirk, 10 the
    full_zoo's widest basis."""
    T = tcl.ufc_simplex(2)
    zoo = ([tfe.DiscontinuousLagrange(T, 0)] if degree == 0
           else [tfe.Lagrange(T, degree), tfe.DiscontinuousLagrange(T, degree)])
    pts = _rng(4).random((500, 2)) / 2
    f32 = device_tabulator(zoo, order=1, f64=False, device="cpu").tables(pts)
    f64 = device_tabulator(zoo, order=1, device="cpu")(pts)
    for a in f64:
        scale = f64[a].abs().max().item() or 1.0
        assert (f32[a].double() - f64[a]).abs().max().item() / scale <= RTOL, a


def test_call_tables_and_unpack_share_rows():
    pts = _rng(5).random((130, 2)) / 2
    tzoo = _nodal_zoo(tfe, tcl.ufc_simplex(2)) + _macro_zoo(tfe, tcl.ufc_simplex(2))
    tab = device_tabulator(tzoo, order=1, f64=False, device="cpu")
    plain, tables = tab.unpack(tab(pts)), tab.tables(pts)
    assert list(plain) == list(tables) == [(0, 0), (0, 1), (1, 0)]
    for a in plain:
        assert tuple(tables[a].shape) == (tab.rows, len(pts))
        assert torch.equal(plain[a], tables[a][:tab.plain_rows])
    f64 = device_tabulator(tzoo, order=1, device="cpu")(pts)
    for a in f64:
        assert (tables[a].double() - f64[a]).abs().max().item() <= MACRO_TOL * (
            f64[a].abs().max().item() + 1.0)


def test_engine_checks_device_cell_and_inputs():
    T = tcl.ufc_simplex(2)
    tab = device_tabulator([tfe.Lagrange(T, 2)], order=1, f64=False, device="cpu")
    pts = _rng(6).random((40, 2)) / 2
    with pytest.raises(ValueError, match="engine on cpu"):
        tab.tables(torch.as_tensor(pts, device="meta"))
    with pytest.raises(ValueError, match="points must have shape"):
        tab(np.zeros((4, 3)))
    out = torch.empty((tab.kernel.total_rows, 4))
    with pytest.raises(TypeError, match="float32"):
        tab.kernel(torch.zeros((4, 2), dtype=torch.float64), tab.dst_plain, out)
    assert tab.kernel.launches == 0
    # tetrahedra run on K6's sd = 3 stage, a tet macro zoo's macro rows on K3's
    T3 = tcl.ufc_simplex(3)
    tet = device_tabulator([tfe.Lagrange(T3, 2), tfe.Lagrange(T3, 2, variant="alfeld")],
                           order=0, f64=False, device="cpu")
    assert tet.kernel.sd == merged_macro(tet).sd == 3
    with pytest.raises(ValueError, match="points must have shape"):
        merged_macro(tet)(torch.zeros((4, 2)))
    with pytest.raises(NotImplementedError, match="variant"):
        ZooF32Kernel([np.eye(3)], 1, 1.0, (np.eye(2), np.zeros(2)), variant="other")


def test_float32_binning_equals_fiat_tpu_masks():
    """K3's float32 binning (tolerance 1e-5) takes the same subcells as
    fiat_tpu's float32 masks on random points and on points exactly on
    interior edges, the barycentre and the Powell-Sabin centre."""
    from fiat_tpu.core import macro as jmacro
    from fiat_tpu_torch.core import macro as tmacro
    pts = np.vstack([_rng(7).random((400, 2)), _special_points()]).astype(np.float32)
    for split in ("AlfeldSplit", "PowellSabinSplit"):
        tcell = getattr(tmacro, split)(tcl.ufc_simplex(2))
        jcell = getattr(jmacro, split)(jcl.ufc_simplex(2))
        for unique in (True, False):
            g, _ = texp.partition_of_unity_masks(tcell, torch.as_tensor(pts), unique=unique,
                                                 raw=True)
            w, _ = jexp.partition_of_unity_masks(jcell, jnp.asarray(pts), unique=unique,
                                                 raw=True)
            for gm, wm in zip(g, w):
                assert np.array_equal(gm.numpy(), np.asarray(wm)), (split, unique)


# -- K6's schedule on the card, replayed on the CPU ---------------------------

LANE = np.arange(32)
RG, PG = LANE >> 3, LANE & 7        # a lane's row group and point group


def _lane_tiles(tp):
    """Per warp and lane, as the kernel computes them: the lane's first row
    in a row tile (W, 32) and first point in a point tile (W, 32); the warp
    tile's place (wr, wp) in the block tile."""
    warps = np.arange(ZooF32Kernel.threads(tp) // 32)
    wr, wp = warps // (tp // 64), warps % (tp // 64)
    return (wr[:, None] * 32 + 8 * RG[None]), (wp[:, None] * 64 + 4 * PG[None]), wr, wp


def k6_replay(k6, phi, dst, out, pad):
    """``out`` as K6 leaves it, from ``k6.At``, ``k6.tiles`` and ``k6.plan``:
    per point tile the Phi tile in shared memory (``phi``'s columns, ``pad``
    (kmax, tp) past the last point as the recurrence at x = 0 gives them,
    each pair of points' columns swapped, zeros past kmax, NaN elsewhere),
    every lane pairing the Phi it loads for point p with its accumulator for
    point p ^ 1, every row tile's A chunks as the bulk
    copies bring them into the ring (NaN until copied), each lane's 8 x 8
    float32 accumulators over its two A and two Phi float4 a k-step, up to
    its warp's width in the table, and each finished tile's rows stored
    from the lanes to ``out[dst]``, the points past the last one dropped."""
    tp, kc, stages, _ = k6.plan
    At, tiles, dst = k6.At.numpy(), k6.tiles.numpy(), dst.numpy()
    npts, W, TR = phi.shape[1], ZooF32Kernel.threads(tp) // 32, ZooF32Kernel.TILE_ROWS
    row_l, pt_l, wr, _ = _lane_tiles(tp)
    rows8 = row_l[..., None] + np.arange(8)                                   # (W, 32, 8)
    pts8 = pt_l[..., None, None] + 32 * np.arange(2)[:, None] + np.arange(4)  # (W, 32, 2, 4)
    chunks = [(t, k0, min(kc, int(w) - k0)) for t, (_, _, w, *_) in enumerate(tiles)
              for k0 in range(0, int(w), kc)]
    for p0 in range(0, npts, tp):
        cols = min(tp, npts - p0)
        Bs = np.full((k6.kpad, tp), np.nan, np.float32)
        Bs[:k6.max_k, :cols] = phi[:k6.max_k, p0:p0 + cols]
        Bs[:k6.max_k, cols:] = pad[:, cols:]
        Bs[k6.max_k:] = 0.0
        Bs = Bs[:, np.arange(tp) ^ 1]                    # point pt at column pt ^ 1
        ring = np.full((stages, kc, TR), np.nan, np.float32)

        def fetch(q):
            t, k0, kn = chunks[q]
            first = tiles[t, 3]
            ring[q % stages, :kn] = At[first + k0:first + k0 + kn]

        for q in range(min(stages, len(chunks))):
            fetch(q)
        q = 0
        for row0, nrows, width, _, *warp_width in tiles:
            acc = np.zeros((W, 32, 8, 2, 4), np.float32)
            kw = np.asarray(warp_width)[wr]                # each warp's width
            for k0 in range(0, width, kc):
                buf = ring[q % stages]
                for kk in range(min(kc, width - k0)):
                    a = buf[kk, rows8]                      # the lane's A fragments
                    b = Bs[k0 + kk, pts8][..., [1, 0, 3, 2]]  # Phi, paired as fma8 does
                    on = k0 + kk < kw
                    acc[on] += (a[..., :, None, None] * b[..., None, :, :])[on]
                if q + stages < len(chunks):               # the last warp refills it
                    fetch(q + stages)
                q += 1
            keep = (rows8 < nrows)[..., None, None] & (p0 + pts8 < npts)[..., None, :, :]
            r = np.broadcast_to(rows8[..., None, None], keep.shape)[keep]
            p = np.broadcast_to((p0 + pts8)[..., None, :, :], keep.shape)[keep]
            out[dst[row0 + r], p] = acc[keep]
    return out


def _replay_check(k6, phi, exact=False, seed=0):
    rng = _rng(seed)
    npts = phi.shape[1]
    pad = rng.standard_normal((k6.max_k, k6.plan[0])).astype(np.float32)
    dst = torch.as_tensor(rng.permutation(k6.total_rows + 5)[:k6.total_rows].astype(np.int32))
    got = k6_replay(k6, phi, dst, np.full((k6.total_rows + 5, npts), np.nan, np.float32), pad)
    want = k6.product(torch.as_tensor(phi), dst,
                      torch.full((k6.total_rows + 5, npts), float("nan"))).numpy()
    assert k6.launches == 0
    untouched = np.setdiff1d(np.arange(k6.total_rows + 5), dst.numpy())
    assert np.isnan(got[untouched]).all() and np.isnan(want[untouched]).all()
    rows = dst.numpy()
    if exact:
        np.testing.assert_array_equal(got[rows], want[rows])
    else:
        assert np.isfinite(got[rows]).all()
        assert np.abs(got[rows] - want[rows]).max() <= 1e-5 * np.abs(want[rows]).max()


def _kernel(sd, degree, shapes, seed=0, integers=False):
    rng = _rng(seed)
    mats = [(rng.integers(-8, 9, s).astype(np.float64) if integers else rng.standard_normal(s))
            for s in shapes]
    es = texp.ExpansionSet(tcl.ufc_simplex(sd))
    return ZooF32Kernel(mats, degree, float(es.get_scale(degree)), es.affine_mappings[0],
                        device="cpu")


@pytest.mark.parametrize("case", [
    (2, 10, ((70, 66), (9, 3))), (3, 8, ((70, 165),)), (2, 2, ((1, 1), (63, 1), (2, 3))),
    (3, 3, ((40, 20), (100, 10), (3, 4))), (3, 10, ((65, 286),))])
@pytest.mark.parametrize("npts", [1, 255, 300, 517])
def test_replay_of_the_schedule_matches_plain(case, npts):
    """Ragged row tiles and points (whole tiles of 300 go out as bulk
    copies, a tile of 517 one value at a time), widths of 1 (a Phi tile
    padded to 2 rows) to 286, multi-chunk tiles, on Phi from the plain
    recurrence at the cell's points; rows outside dst keep their NaN."""
    sd, degree, shapes = case
    k6 = _kernel(sd, degree, shapes, seed=npts)
    pts = _rng(npts).random((npts, sd))
    pts = pts / (pts.sum(axis=1)[:, None] + 1e-9) * _rng(npts + 1).random((npts, 1))
    phi = k6.phi(torch.as_tensor(pts, dtype=torch.float32)).numpy()
    _replay_check(k6, phi, seed=npts)


@pytest.mark.parametrize("sd,degree,width", [(2, 10, 66), (3, 3, 20), (3, 8, 165)])
def test_replay_is_exact_on_integers_under_every_plan(sd, degree, width):
    """Integer A and Phi in [-8, 8]: every partial sum is exact in float32,
    so the replay equals the plain product bit for bit under every plan the
    host offers (rings of 2 to 4 chunks, tiles of 1 to several chunks, point
    tiles of 64, 128 and 256) and no index can hide under a tolerance."""
    k6 = _kernel(sd, degree, ((90, width), (41, 7)), integers=True)
    phi = _rng(width).integers(-8, 9, (k6.max_k, 300)).astype(np.float32)
    plans = k6.candidates(k6.kpad)
    assert {p[0] for p in plans} == set(ZooF32Kernel.POINT_TILES) or width == 165
    for plan in plans:
        k6.plan = plan
        _replay_check(k6, phi, exact=True, seed=plan[1])


@pytest.mark.parametrize("tp", ZooF32Kernel.POINT_TILES)
def test_fragment_and_store_addresses_are_conflict_free(tp):
    """Shared memory serves 128 bytes a wavefront.  Each k-step's float4
    loads of A (4 row groups' 16 bytes, 32 bytes apart) and of Phi (8
    lanes' consecutive 16 bytes, broadcast to the 4 row groups) touch at
    most 8 distinct 16-byte words in 8 distinct bank groups: one wavefront
    each.  The recurrence's writes of a warp (one member, 32 consecutive
    points, each pair's columns swapped) take 32 distinct banks.  Each 16-byte store of a row group
    (8 lanes) writes 128 contiguous, 128-byte aligned bytes of one row of
    the tile; the ring's buffers and every chunk's source in At are 16-byte
    aligned, as the bulk copies need."""
    row_l, pt_l, _, _ = _lane_tiles(tp)
    kc, TR = 42, ZooF32Kernel.TILE_ROWS
    for k in (0, 1, 5):
        for h in range(2):
            a = 4 * 7 * kc * TR + k * TR + row_l + 4 * h      # floats, in ring buffer 7
            b = k * tp + pt_l + 32 * h
            for addr in (a, b):
                for warp in addr:
                    words = np.unique(warp)
                    assert (words % 4 == 0).all() and len(words) <= 8
                    assert len(set((words // 4) % 8)) == len(words)
    for m in (0, 3):                   # two threads a point, at column pt ^ 1
        cols = m * tp + (np.arange(2 * tp) % tp ^ 1)
        assert all(len(set(warp % 32)) == 32 for warp in cols.reshape(-1, 32))
    for j in range(2):
        for warp_rows, warp_pts in zip(row_l, pt_l + 32 * j):
            for group in range(4):
                lanes = RG == group
                assert len(set(warp_rows[lanes])) == 1
                cols = np.sort(warp_pts[lanes])
                assert cols[0] % 32 == 0 and (np.diff(cols) == 4).all()
    k6 = _kernel(3, 8, ((70, 165),))
    tp_, kc_, stages, _ = k6.plan
    ring = 4 * k6.kpad * tp_
    assert ring % 16 == 0 and (4 * kc_ * TR) % 16 == 0
    assert (4 * TR * k6.tiles.numpy()[:, 3] % 16 == 0).all()


def test_plan_fits_shared_memory_at_every_degree_and_refuses_past_it():
    """At every width a zoo of sd 2 degrees 0-15 or sd 3 degrees 0-10 can
    have (Phi tiles of 2 to 286 rows), the plan keeps at least two blocks an
    SM within 232,448 bytes a block and 233,472 an SM (in 128-byte units,
    1 KB kept a block) and 16 warps' registers, on the widest point tile of
    those that keep most threads, or the narrowest for at most two row
    tiles; past 386 rows (the generic instantiation's degrees: tet 14's
    680) one block an SM on the widest point tile that fits, up to 842 rows
    (64 points); past 842 rows no fused plan fits and the kernel takes
    its wide mode at construction (``wide_plan``).  The
    first degrees past the unrolled ones build on the generic
    instantiation."""
    K = ZooF32Kernel
    for kpad in range(2, 850, 2):
        for ntiles in (1, 2, 3, 40):
            plan = K.plan_for(kpad, ntiles)
            if kpad > 842:
                assert plan is None
                continue
            if kpad > 386:
                tp, kc, stages, blocks = plan
                smem = K.smem_bytes(kpad, tp, kc, stages)
                widest = max(t for t in K.POINT_TILES if K.fit(kpad, t, 1) is not None)
                assert (tp, blocks) == (widest, 1) and smem <= 232448 and 2 <= stages <= 4
                assert -(-smem // 128) * 128 + 1024 <= 233472 and min(kpad, 16) <= kc <= kpad
                continue
            tp, kc, stages, blocks = plan
            smem = K.smem_bytes(kpad, tp, kc, stages)
            assert smem <= 232448 and blocks >= 2 and blocks * K.threads(tp) <= 512
            assert blocks * (-(-smem // 128) * 128 + 1024) <= 233472
            assert kc % 2 == 0 and min(kpad, 16) <= kc <= kpad and 2 <= stages <= 4
            most = max(K.threads(p[0]) * p[3] for p in K.candidates(kpad))
            tiles = {p[0] for p in K.candidates(kpad) if K.threads(p[0]) * p[3] == most}
            assert K.threads(tp) * blocks == most
            assert tp == (min(tiles) if ntiles <= 2 else max(tiles))
    for sd, top in ((2, 15), (3, 10)):
        for degree in range(top + 1):
            k6 = _kernel(sd, degree, ((3, math.comb(degree + sd, sd)),))
            assert k6.plan == K.plan_for(k6.kpad, 1) and k6.plan is not None
        k6 = _kernel(sd, top + 1, ((3, 4),))
        assert k6.generic and k6.plan == K.plan_for(k6.kpad, 1)
    assert _kernel(3, 14, ((3, 680),)).plan == K.plan_for(680, 1) == (64, 56, 2, 1)
    k6 = _kernel(2, 40, ((3, 843),))
    assert k6.mode == "wide" and k6.plan == K.wide_plan(844)[0]
