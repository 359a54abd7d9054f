"""K2's host layout for the FP64 tensor cores (``csrc/bucket_matmul.cu``),
on the CPU.

A numpy replay of the kernel's schedule on ``BucketMatmul``'s device
arrays: the block's Phi tile (swizzled, zero rows past ``max_k``, shared
memory otherwise NaN as if uninitialised), every row tile's A chunks as
the bulk copies bring them, the warp tiles, the k-steps of
``mma.sync.m16n8k4`` with each lane's fragments taken from the kernel's
shared-memory addresses and multiplied in the PTX ISA's fragment layout,
and the C tile through the per-warp staging area.  The replay must equal
the plain version, and the plain version fiat_tpu's ``FusedMultiwordMatmul``
in interpret mode on ``full_zoo``'s and ``tet_lagrange8``'s groups.  Also:
the swizzle puts each half-warp's fragment loads on 16 distinct bank
pairs, the plan fits a block's shared memory, and ``pack_rows`` /
``transposed_tiles`` give the arrays they always gave, from which K6's
``k6_layout`` cuts its own."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fiat_tpu.ops.pallas_multiword import FusedMultiwordMatmul
from fiat_tpu_torch import device_tabulator, ufc_simplex
from fiat_tpu_torch import elements as tfe
from fiat_tpu_torch.ops.f32_zoo import ZooF32Kernel
from fiat_tpu_torch.ops.fused_zoo import (BucketMatmul, k2_staging_stride, k2_swizzle,
                                          pack_rows, transposed_tiles)

LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3          # the fragment's row group and thread in group
W = BucketMatmul.WARPS
WM = BucketMatmul.TILE_ROWS // (W // BucketMatmul.WARPS_N)   # rows of a warp tile


def warp_tiles(tp):
    """(first row, first point) of each warp's tile in a block."""
    warps = np.arange(W)
    return (warps // BucketMatmul.WARPS_N) * WM, (warps % BucketMatmul.WARPS_N) * (
        tp // BucketMatmul.WARPS_N)


def fragment_columns(tp, swizzle=k2_swizzle):
    """The shared-memory columns each lane loads its fragments from, as the
    kernel computes them: A (W, 2 MMA tiles, 2 halves, 32 lanes) in a chunk
    row of 64, B (W, point MMA tiles, 32 lanes) in a Phi row of ``tp``; the
    row is k0 + kk + t, kk a multiple of 4."""
    row_w, pt_w = warp_tiles(tp)
    nt = tp // BucketMatmul.WARPS_N // 8
    a = (row_w[:, None, None, None] + 16 * np.arange(WM // 16)[None, :, None, None]
         + 8 * np.arange(2)[None, None, :, None] + G) ^ swizzle(T)
    b = (pt_w[:, None, None] + 8 * np.arange(nt)[None, :, None] + G) ^ swizzle(T)
    return a, b


def mma_16x8x4(a, b):
    """Each lane's accumulator increments of ``mma.sync.m16n8k4.row.col.f64``
    (PTX ISA): lane (g, t) holds A[g][t], A[g + 8][t] in a (..., 2, 32),
    B[t][g] in b (..., 32), and C[g][2t], C[g][2t + 1], C[g + 8][2t],
    C[g + 8][2t + 1].  a (W, MT, 2, 32), b (W, NT, 32) -> (W, MT, NT, 32, 4)."""
    A = a.reshape(*a.shape[:2], 2, 8, 4).reshape(*a.shape[:2], 16, 4)   # [8h + g][t]
    B = np.swapaxes(b.reshape(*b.shape[:2], 8, 4), -1, -2)              # [t][g]
    D = np.einsum("wimk,wjkn->wijmn", A, B)
    e = np.arange(4)
    return D[..., G[:, None] + 8 * (e // 2), 2 * T[:, None] + e % 2]


def replay(mm, phi):
    """C as the kernel computes it from ``mm.At``, ``mm.tiles`` and
    ``mm.plan`` on the numpy ``phi`` (>= max_k, npts)."""
    tp, kc, stages, blocks = mm.plan
    At, tiles = mm.At.numpy(), mm.tiles.numpy()
    npts, kmax = phi.shape[1], mm.max_k
    wn = tp // BucketMatmul.WARPS_N
    ss, slab = k2_staging_stride(wn), BucketMatmul.SLAB
    row_w, pt_w = warp_tiles(tp)
    a_col, b_col = fragment_columns(tp)
    C = np.full((mm.total_rows, npts), np.nan)
    p = np.arange(tp)
    for p0 in range(0, npts, tp):
        Bs = np.full((mm.kpad, tp), np.nan)          # uninitialised shared memory
        for k in range(kmax):
            Bs[k, p ^ k2_swizzle(k)] = np.where(p0 + p < npts,
                                                phi[k, np.minimum(p0 + p, npts - 1)], 0.0)
        Bs[kmax:] = 0.0
        for tile, (row0, nrows, K) in enumerate(tiles):
            kt = max(4, -(-K // 4) * 4)
            acc = np.zeros((W, WM // 16, wn // 8, 32, 4))
            for k0 in range(0, kt, kc):
                As = At[tile, k0:k0 + min(kc, kt - k0)]     # one bulk copy into the ring
                for kk in range(0, len(As), 4):
                    acc += mma_16x8x4(As[kk + T, a_col], Bs[k0 + kk + T, b_col])
            for s in range(WM // slab):                     # 8 rows at a time
                i, h = divmod(s, 2)
                St = np.full((W, slab, ss), np.nan)
                for j in range(wn // 8):
                    St[:, G, 8 * j + 2 * T] = acc[:, i, j, :, 2 * h]
                    St[:, G, 8 * j + 2 * T + 1] = acc[:, i, j, :, 2 * h + 1]
                for w in range(W):
                    r = np.arange(slab)[(row_w[w] + s * slab + np.arange(slab)) < nrows]
                    c = np.arange(wn)[p0 + pt_w[w] + np.arange(wn) < npts]
                    C[np.ix_(row0 + row_w[w] + s * slab + r, p0 + pt_w[w] + c)] = St[w][np.ix_(r, c)]
    return C


def _check(mm, phi, exact=False):
    got = replay(mm, phi)
    want = mm.plain(torch.as_tensor(phi)).numpy()
    assert mm.launches == 0
    if exact:
        np.testing.assert_array_equal(got, want)
        return
    assert np.isfinite(got).all()
    for off, r in zip(mm.offsets, mm.rows):
        scale = np.abs(want[off:off + r]).max()
        assert np.abs(got[off:off + r] - want[off:off + r]).max() <= 1e-13 * scale


@pytest.mark.parametrize("shape", [
    ((70, 1),), ((70, 3), (9, 1)), ((70, 5),), ((18, 3), (200, 66), (65, 21), (1, 10)),
    ((70, 165), (9, 1)), ((70, 167),), ((67, 300), (80, 35)), ((70, 438), (9, 1)),
    ((80, 792),), ((1100, 20), (9, 7))])
@pytest.mark.parametrize("npts", [1, 127, 333])
def test_replay_of_the_schedule_matches_plain(shape, npts):
    """Widths off the MMA's depth (1 to 792, one chunk to many, every point
    tile; narrow zoos of few and of many row tiles), ragged row and point
    tiles, on a Phi of exactly max_k rows."""
    rng = np.random.default_rng(sum(r * k for r, k in shape) + npts)
    mm = BucketMatmul([rng.standard_normal(s) for s in shape], device="cpu")
    _check(mm, rng.standard_normal((mm.max_k, npts)))


@pytest.mark.parametrize("widths", [(3, 66), (165,), (3, 66, 165, 438)])
def test_replay_is_exact_on_integers(widths):
    """Integer A and Phi in [-8, 8]: every partial sum is exact in f64, so
    the replay equals the plain version bit for bit and no fragment index
    can hide under a tolerance."""
    rng = np.random.default_rng(len(widths))
    mats = [rng.integers(-8, 9, (37 + 29 * i, k)).astype(np.float64)
            for i, k in enumerate(widths)]
    mm = BucketMatmul(mats, device="cpu")
    _check(mm, rng.integers(-8, 9, (max(widths), 300)).astype(np.float64), exact=True)


@pytest.fixture(scope="module")
def zoo_matmuls():
    """K2 of full_zoo's triangle Lagrange/DG/RT/N1curl/BDM/C1 rows (10
    groups, K 3 to 66) and of tet_lagrange8 (660 rows at K 165)."""
    T, T3 = ufc_simplex(2), ufc_simplex(3)
    full = ([tfe.Lagrange(T, p) for p in range(1, 11)]
            + [tfe.DiscontinuousLagrange(T, p) for p in range(1, 9)]
            + [tfe.RaviartThomas(T, k) for k in range(1, 7)]
            + [tfe.Nedelec(T, k) for k in range(1, 7)]
            + [tfe.BrezziDouglasMarini(T, k) for k in range(1, 7)]
            + [tfe.CubicHermite(T), tfe.Morley(T), tfe.Argyris(T, 5), tfe.Bell(T),
               tfe.HsiehCloughTocher(T, 3), tfe.QuadraticPowellSabin6(T)])
    return {"full_zoo": device_tabulator(full, order=1, device="cpu").matmul,
            "tet_lagrange8": device_tabulator([tfe.Lagrange(T3, 8)], order=1,
                                              device="cpu").matmul}


@pytest.mark.parametrize("cell", ["full_zoo", "tet_lagrange8"])
def test_zoo_groups_replay_plain_and_fiat_tpu(zoo_matmuls, cell):
    """The replay equals the plain version on the cell's own groups, and the
    plain version equals fiat_tpu's FusedMultiwordMatmul (interpret mode)
    group by group."""
    mm = zoo_matmuls[cell]
    assert (mm.total_rows, mm.max_k) == {"full_zoo": (4113, 66), "tet_lagrange8": (660, 165)}[cell]
    rng = np.random.default_rng(len(cell))
    phi = rng.standard_normal((mm.max_k, 256))
    _check(mm, phi)
    got = mm.plain(torch.as_tensor(phi)).numpy()
    for off, k, r in zip(mm.offsets, mm.K, mm.rows):
        want = np.asarray(FusedMultiwordMatmul(mm.A[off:off + r, :k].numpy(), interpret=True,
                                               row_block=256, point_tile=256)(jnp.asarray(phi[:k])))
        assert np.abs(got[off:off + r] - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("tp", BucketMatmul.POINT_TILES)
def test_fragment_loads_hit_16_distinct_bank_pairs(tp):
    """8-byte shared-memory loads are served a half-warp at a time, each
    bank pair (address / 8 mod 16) once: the swizzle spreads the four k
    rows of a fragment load over four bank groups, where the unswizzled
    rows (strides of 64 and tp doubles, both 0 mod 16) put four lanes on
    each bank pair."""
    mm = BucketMatmul([np.ones((64, 165))], device="cpu")
    kc = mm.plan[1]
    # each buffer starts 16 doubles aligned: Phi at 0, A chunk s at kpad * tp + s * kc * 64
    assert (mm.kpad * tp) % 16 == 0 and (kc * BucketMatmul.TILE_ROWS) % 16 == 0
    for swizzle, distinct in ((k2_swizzle, 16), (lambda k: 0 * k, 4)):
        a_col, b_col = fragment_columns(tp, swizzle)
        for k0 in (0, 4, 8, 12):
            a = (k0 + T) * BucketMatmul.TILE_ROWS + a_col
            b = (k0 + T) * tp + b_col
            for addr in (a.reshape(-1, 32), b.reshape(-1, 32)):
                for half in (addr[:, :16], addr[:, 16:]):
                    for lanes in half:
                        assert len(set(lanes % 16)) == distinct


@pytest.mark.parametrize("tp", BucketMatmul.POINT_TILES)
def test_staging_and_phi_copies_keep_their_layout(tp):
    """The C staging: each quarter-warp's 16-byte stores (rows g, g + 1 of
    the slab) take 8 distinct 16-byte bank groups, and a row is read back
    contiguously.  The swizzle moves columns in fours, so the 16-byte
    copies of Phi point pairs (p, p + 1) stay adjacent."""
    wn = tp // BucketMatmul.WARPS_N
    ss = k2_staging_stride(wn)
    assert ss >= wn and ss % 16 == 8
    for j in range(wn // 8):
        addr = G * ss + 8 * j + 2 * T                   # doubles, 16-byte aligned
        for quarter in addr.reshape(4, 8):
            assert len(set((quarter % 16) // 2)) == 8
    k = np.arange(64)
    assert (k2_swizzle(k) % 4 == 0).all() and (k2_swizzle(k) < 16).all()


def test_at_is_the_swizzled_transposed_tiles_zero_padded():
    """``At[tile][k][m ^ swizzle(k)] = A[row0 + m][k]``, zero past each
    tile's rows and past max_k up to kpad, so a chunk is one contiguous
    copy and a tile's rounded-up width reads zeros."""
    rng = np.random.default_rng(3)
    mats = [rng.standard_normal((r, k)) for r, k in ((5, 3), (130, 10), (64, 6), (3, 13))]
    mm = BucketMatmul(mats, device="cpu")
    assert mm.kpad == 16 and mm.At.shape == (len(mm.tiles), 16, 64) and mm.At.is_contiguous()
    packed = mm.A.numpy()
    At = mm.At.numpy()
    for t, (row0, n, _) in enumerate(mm.tiles.numpy()):
        for k in range(mm.kpad):
            m = np.arange(64)
            want = np.where(m < n, packed[np.minimum(row0 + m, mm.total_rows - 1),
                                          min(k, mm.max_k - 1)], 0.0) * (k < mm.max_k)
            np.testing.assert_array_equal(At[t, k, m ^ k2_swizzle(k)], want)


@pytest.mark.parametrize("ntiles", [1, 16, 17, 100])
def test_plan_fits_shared_memory_and_refuses_past_792(ntiles):
    """A narrow contraction (K <= 44: the 128-point tile fits two blocks an
    SM with A's whole width in one chunk) runs two blocks an SM, on the
    32-point tile for at most 16 row tiles, else on the 128-point one; any
    other one block an SM on the widest point tile with room for two A
    chunks, the widest chunk there, then as many chunks as fit (up to 4);
    no resident plan past K 792, where construction takes the streamed
    mode (``stream_plan``; on the CPU too)."""
    B = BucketMatmul
    plans = {}
    for kpad in range(4, 800, 4):
        plan = B.plan_for(kpad, ntiles)
        if plan is None:
            assert kpad > 792
            continue
        tp, kc, stages, blocks = plan
        plans[kpad] = plan
        budget = min(B.SMEM_MAX, B.SMEM_SM // blocks - B.SMEM_BLOCK)
        assert kc % 4 == 0 and kc <= kpad and 2 <= stages <= 4
        assert B.smem_bytes(kpad, tp, kc, stages) <= budget
        assert kc == kpad or B.smem_bytes(kpad, tp, kc + 4, 2) > budget
        assert (blocks == 2) == (kpad <= 44)
        if blocks == 2:
            assert kc == kpad and tp == (32 if ntiles <= 16 else 128)
    assert max(plans) == 792
    narrow = 32 if ntiles <= 16 else 128
    assert {k: plans[k] for k in (4, 20, 44, 48, 68, 108, 168, 188, 192, 396, 400, 440, 792)} == {
        4: (narrow, 4, 4, 2), 20: (narrow, 20, 4, 2), 44: (narrow, 44, 4 if narrow == 32 else 2, 2),
        48: (128, 48, 4, 1), 68: (128, 68, 4, 1), 108: (128, 96, 2, 1), 168: (128, 36, 2, 1),
        188: (128, 16, 2, 1), 192: (64, 116, 2, 1), 396: (64, 16, 2, 1), 400: (32, 112, 2, 1),
        440: (32, 104, 2, 1), 792: (32, 16, 2, 1)}
    mm = BucketMatmul([np.ones((4, 793))], device="cpu")
    assert mm.mode == "streamed" and mm.plan == BucketMatmul.stream_plan(796)[0]
    assert BucketMatmul([np.ones((4, 792))], device="cpu").mode == "resident"


def _parent_pack_rows(mats, tile_rows):
    """The tile table and packed rows, entry by entry (the layout K6 reads)."""
    rows = [M.shape[0] for M in mats]
    packed = np.zeros((sum(rows), max(M.shape[1] for M in mats)))
    width = []
    r = 0
    for M in mats:
        packed[r:r + M.shape[0], :M.shape[1]] = M
        width += [M.shape[1]] * M.shape[0]
        r += M.shape[0]
    tiles = [[r0, min(tile_rows, len(width) - r0), max(width[r0:r0 + tile_rows])]
             for r0 in range(0, len(width), tile_rows)]
    At = np.zeros((len(tiles), packed.shape[1], tile_rows))
    for t, (r0, n, _) in enumerate(tiles):
        for m in range(n):
            At[t, :, m] = packed[r0 + m]
    return packed, tiles, At


@pytest.mark.parametrize("shape", [((5, 3), (130, 10), (64, 6)), ((1, 1),),
                                   ((65, 21), (64, 28), (3, 36))])
def test_k6_keeps_its_unswizzled_tiles(shape):
    """``pack_rows`` and ``transposed_tiles`` still give the packed rows,
    the (first row, rows, K) table and the plain (tile, k, row) transpose,
    unswizzled and unpadded; K6's device arrays (``k6_layout``) are the
    same transposed tiles, of 128 rows, in float32, each cut to its width
    rounded up to the kernel's depth of 2 (zeros past max_k) and stacked
    tile after tile, with each tile's width, first row of At and its 32-row
    warp slabs' widths in the table."""
    rng = np.random.default_rng(len(shape))
    mats = [rng.standard_normal(s) for s in shape]
    packed, tiles, K, rows, offsets = pack_rows(mats, 64)
    want_packed, want_tiles, want_At = _parent_pack_rows(mats, 64)
    np.testing.assert_array_equal(packed, want_packed)
    assert tiles.dtype == np.int32 and tiles.tolist() == want_tiles
    assert (K, rows) == ([s[1] for s in shape], [s[0] for s in shape])
    assert offsets == np.concatenate([[0], np.cumsum(rows)]).tolist()
    np.testing.assert_array_equal(transposed_tiles(packed, tiles, 64), want_At)
    k6 = ZooF32Kernel(mats, 7, 1.0, (np.eye(2), np.zeros(2)), device="cpu")
    _, k6_tiles, k6_At = _parent_pack_rows(mats, k6.TILE_ROWS)
    widths = [min(k6.kpad, k + k % 2) for _, _, k in k6_tiles]
    firsts = np.concatenate([[0], np.cumsum(widths)]).tolist()
    padded = np.pad(k6_At, ((0, 0), (0, k6.kpad - k6_At.shape[1]), (0, 0)))
    assert torch.equal(k6.At, torch.as_tensor(np.concatenate(
        [padded[t, :w] for t, w in enumerate(widths)])).float())
    row_width = np.concatenate([np.full(M.shape[0], M.shape[1]) for M in mats])
    slabs = [[min(k6.kpad, int(row_width[r0 + s:r0 + min(n, s + 32)].max()) + 1) // 2 * 2
              if s < n else 0 for s in range(0, k6.TILE_ROWS, 32)] for r0, n, _ in k6_tiles]
    assert k6.tiles.tolist() == [[r0, n, w, f, *ws] for (r0, n, _), w, f, ws in
                                 zip(k6_tiles, widths, firsts, slabs)]
