"""The widths and degrees past the port's old caps: K2 at any contraction
width (past 792 it streams Phi in k beside A: ``BucketMatmul.mode ==
"streamed"``), K6 past its Phi tile (past 842 rows: K6's recurrence writes
Phi to device memory and a product streams it in k, ``mode == "wide"``),
and K8 to fiat_tpu's 26 / 17 / 15 (a generic instantiation past the
unrolled 15 / 15 / 10).

On the CPU, against fiat_tpu (inputs from seeded numpy generators, 32
points, handed to both packages): the f64 engine on tet GLL Lagrange 15
and 16 and triangle GLL Lagrange 40 (vs fiat_tpu's interpreted
``FusedZooTabulator``), the f32 engine on tet GLL Lagrange 16 (vs
``PallasZooTabulator`` in interpret mode), ``ElementTabulator`` on tet
GLL Lagrange 15, K8's plain version at 26 / 17 / 15 (vs fiat_tpu's f64
features ``xla_f64``) and the refusals at 27 / 18 / 16 in both packages,
the Bernstein conversion bit for bit; the streamed plans on the host
(shared memory, every width 793-1771) and numpy replays of both streaming
orders on the wrappers' device arrays, bit for bit on integers.  On the
card (marker ``cuda``, skipped without one): each new mode against its
plain version and the entry points one launch of each kernel.

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
from fiat_tpu_torch.ops import bernstein as tb
from fiat_tpu_torch.ops import moments as tmo
from fiat_tpu_torch.ops.f32_zoo import F32ZooTabulator, ZooF32Kernel
from fiat_tpu_torch.ops.fused_zoo import BucketMatmul, FusedZooTabulator, k2_swizzle
from fiat_tpu_torch.ops.tabulate import BatchedTabulator, ElementTabulator

try:    # fiat_tpu and JAX, the CPU tests' oracle; the card's cases need neither
    import jax.numpy as jnp

    from fiat_tpu import elements as jfe
    from fiat_tpu.core import cells as jcl
    from fiat_tpu.core.expansions import ExpansionSet as JExpansionSet
    from fiat_tpu.ops import pallas_bernstein as jb
    from fiat_tpu.ops.pallas_multiword import FusedZooTabulator as JFusedZooTabulator
    from fiat_tpu.ops.pallas_tabulate import PallasZooTabulator
    from fiat_tpu.ops.tabulate import BatchedTabulator as JBatchedTabulator
    from fiat_tpu.ops.tabulate import ElementTabulator as JElementTabulator
except ImportError:
    jfe = None

RTOL_TABLES = 1e-11     # f64 tables vs fiat_tpu's engine, of max(1, max |table|)
RTOL_HOST = 1e-10       # f64 tables vs host, of max(1, max |table|)
RTOL_F32 = 2e-5         # f32 tables vs fiat_tpu's / the f64 engine, of each alpha's max
RTOL_FEATURES = 1e-13   # K8's plain version vs fiat_tpu's f64 features, of max |features|
RTOL_PLAIN = 1e-13      # an f64 kernel vs its plain version
RTOL_F32_KERNEL = 1e-5  # a float32 kernel vs its plain version
NPTS = 32
#: the highest Bernstein degree per sd, both packages'
BERNSTEIN_TOP = {1: 26, 2: 17, 3: 15}


def _need_fiat_tpu():
    if jfe is None:
        pytest.skip("needs fiat_tpu and JAX")


def _points(sd, n, seed):
    return np.random.default_rng(seed).random((n, sd)) / sd


def _scaled(got, want):
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _gll(fe, cells, sd, degree):
    return fe.Lagrange(cells.ufc_simplex(sd), degree, variant="gll")


# -- the f64 engine, the f32 engine and ElementTabulator against fiat_tpu ----------

@pytest.mark.parametrize("sd,degree", [(3, 15), (3, 16), (2, 40)],
                         ids=["tet-15", "tet-16", "tri-40"])
def test_f64_engine_streams_k2_and_matches_fiat_tpu(sd, degree):
    """GLL Lagrange past K2's 792 (816, 969 and 861 members) on the f64
    engine (plain versions, K2 in its streamed mode) against fiat_tpu's
    interpreted ``FusedZooTabulator`` at RTOL_TABLES and the host at
    RTOL_HOST, of max(1, max |table|) per alpha."""
    _need_fiat_tpu()
    pts = _points(sd, NPTS, 100 + degree)
    t = _gll(ft, tcl, sd, degree)
    tab = device_tabulator([t], order=1, device="cpu")
    assert tab.matmul.mode == "streamed" and tab.matmul.max_k == math.comb(degree + sd, sd)
    got = tab.unpack(tab.block_tables(pts))[0]
    jfz = JFusedZooTabulator(JBatchedTabulator([_gll(jfe, jcl, sd, degree)], order=1),
                             interpret=True, row_block=256, point_tile=128)
    ref = jfz.unpack({a: [np.asarray(x) for x in v]
                      for a, v in jfz.block_tables(jnp.asarray(pts)).items()})[0]
    host = t.tabulate(1, pts)
    assert set(got) == set(ref) == set(host)
    for a, h in host.items():
        mine = got[a].numpy().reshape(h.shape)
        assert _scaled(mine, np.asarray(ref[a]).reshape(h.shape)) <= RTOL_TABLES, a
        assert _scaled(mine, h) <= RTOL_HOST, a
    assert tab.matmul.launches == tab.recurrence.launches == 0


def test_f32_engine_goes_wide_and_matches_fiat_tpu():
    """GLL Lagrange 16 on the tet (969 Phi rows, past K6's 842) on the f32
    engine (plain versions, K6 wide) against fiat_tpu's
    ``PallasZooTabulator`` in interpret mode and the port's f64 engine, at
    RTOL_F32 of each alpha's max."""
    _need_fiat_tpu()
    pts = _points(3, NPTS, 16)
    tbt = BatchedTabulator([_gll(ft, tcl, 3, 16)], order=1, device="cpu")
    tab = F32ZooTabulator(tbt, device="cpu")
    assert tab.kernel.mode == "wide" and tab.kernel.generic
    got = tab.tables(pts)
    want = PallasZooTabulator(JBatchedTabulator([_gll(jfe, jcl, 3, 16)], order=1), tile=256,
                              interpret=True).tables(pts)
    f64 = FusedZooTabulator(tbt, device="cpu")(pts)
    assert list(got) == list(want)
    for a in want:
        g, w, h = got[a].numpy(), np.asarray(want[a]), f64[a].numpy()
        assert np.abs(g - w).max() <= RTOL_F32 * np.abs(h).max(), a
        assert np.abs(g - h).max() <= RTOL_F32 * np.abs(h).max(), a
    assert tab.kernel.launches == tab.kernel.phi_launches == 0


def test_element_tabulator_takes_tet_15():
    """``ElementTabulator`` on tet GLL Lagrange 15 (816 members: K1's
    generic stage + K2 streamed) against fiat_tpu's and the host, of
    max(1, max |table|) per alpha."""
    _need_fiat_tpu()
    t = _gll(ft, tcl, 3, 15)
    pts = _points(3, NPTS, 15)
    tab = ElementTabulator(t, 1, device="cpu")
    assert tab.matmul.mode == "streamed" and tab.recurrence.generic
    mine = tab(pts)
    ref = JElementTabulator(_gll(jfe, jcl, 3, 15), 1)(jnp.asarray(pts))
    host = t.tabulate(1, pts)
    assert set(mine) == set(ref) == set(host)
    for a, h in host.items():
        assert _scaled(mine[a].numpy(), np.asarray(ref[a])) <= RTOL_TABLES, a
        assert _scaled(mine[a].numpy(), h) <= RTOL_HOST, a


# -- K8 to 26 / 17 / 15 ----------------------------------------------------------------

def _simplex_points(cell, n, seed):
    lam = np.random.default_rng(seed).dirichlet(np.ones(cell.get_spatial_dimension() + 1), n)
    return lam @ np.asarray(cell.get_vertices())


@pytest.mark.parametrize("sd", [1, 2, 3])
def test_k8_plain_at_the_top_matches_fiat_tpu(sd):
    """K8's plain version at fiat_tpu's highest degrees (the generic
    instantiation's) against fiat_tpu's f64 features at RTOL_FEATURES of
    their max, and against the host's Bernstein tabulation; the multinomials
    are fiat_tpu's, every one below 2^24."""
    _need_fiat_tpu()
    degree = BERNSTEIN_TOP[sd]
    tcell = tcl.ufc_simplex(sd)
    pts = _simplex_points(tcell, NPTS, degree)
    feat = tb.BernsteinFeatures(sd, degree, tb._bary_map(tcell), device="cpu")
    assert feat.generic and feat.nexp == math.comb(degree + sd, sd)
    got = feat(torch.as_tensor(pts)).numpy()
    jfeat = jb.PallasBernsteinFeatures(JExpansionSet(jcl.ufc_simplex(sd)), degree, interpret=True)
    want = np.asarray(jfeat.xla_f64(jnp.asarray(pts)))
    assert got.shape == want.shape == (feat.nexp, NPTS)
    assert np.abs(got - want).max() <= RTOL_FEATURES * np.abs(want).max()
    host = tb._bernstein_host(tcell, degree, pts)
    assert np.abs(got - host).max() <= RTOL_FEATURES * np.abs(host).max()
    assert feat.coef.max().item() < 2 ** 24 and feat.launches == 0


@pytest.mark.parametrize("sd", [1, 2, 3])
def test_k8_refuses_past_fiat_tpus_degrees(sd):
    """At 27 / 18 / 16 both packages refuse by name: fiat_tpu's packed
    multinomials pass 2^24, and the port refuses where fiat_tpu does (also
    on the engine's Bernstein route)."""
    _need_fiat_tpu()
    over = BERNSTEIN_TOP[sd] + 1
    cell = tcl.ufc_simplex(sd)
    with pytest.raises(NotImplementedError, match=f"Bernstein degree {over} outside "
                                                  f"0..{over - 1} for sd = {sd}"):
        tb.BernsteinFeatures(sd, over, tb._bary_map(cell), device="cpu")
    with pytest.raises(NotImplementedError, match="coefficient exceeds exact f32 ints"):
        jb.PallasBernsteinFeatures(JExpansionSet(jcl.ufc_simplex(sd)), over, interpret=True)
    if sd == 1:
        bt = BatchedTabulator([ft.Lagrange(cell, over)], order=0, device="cpu")
        with pytest.raises(NotImplementedError, match=f"outside 0..{over - 1}"):
            FusedZooTabulator(bt, device="cpu", features="bernstein")


@pytest.mark.parametrize("sd,degree", [(1, 26), (2, 12), (3, 6)])
def test_bernstein_operand_is_fiat_tpus_conversion_bit_for_bit(sd, degree):
    """The Bernstein route's M (``bernstein_operand``, its longdouble
    products threaded by ``ld_matmul``) is fiat_tpu's ``bernstein_conversion``
    times the scale ratio, bit for bit; ``ld_matmul`` is numpy's longdouble
    ``matmul`` bit for bit."""
    _need_fiat_tpu()
    tes = texp.ExpansionSet(tcl.ufc_simplex(sd))
    jes = JExpansionSet(jcl.ufc_simplex(sd))
    M, _ = tb.bernstein_operand(sd, degree, tes.get_scale(degree), tes.affine_mappings[0])
    base = texp.ExpansionSet(tcl.default_simplex(sd))
    ratio = float(tes.get_scale(degree)) / float(base.get_scale(degree))
    want = jb.bernstein_conversion(JExpansionSet(jcl.default_simplex(sd)), degree) * ratio
    assert M.dtype == np.longdouble and np.array_equal(M, want)
    assert np.array_equal(tb.bernstein_conversion(tes, degree),
                          jb.bernstein_conversion(jes, degree))
    rng = np.random.default_rng(degree)
    a = rng.standard_normal((23, 41)).astype(np.longdouble) / 3
    b = rng.standard_normal((41, 17)).astype(np.longdouble) * 7
    for workers in (1, 3, None):
        assert np.array_equal(tb.ld_matmul(a, b, workers), a @ b)


# -- K2's streamed mode on the host --------------------------------------------------

def test_k2_stream_plan_fits_every_width_past_792():
    """Every contraction 793-1771 (kpad 796-1772) takes the streamed mode
    (no resident plan), whose ring of 2 to 4 (A chunk, Phi slab) pairs fits
    two blocks an SM within 232,448 bytes a block, chunks of STREAM_KC rows
    (a multiple of the MMA's depth), and a group of row tiles whose A takes
    about 16 MB (at least one tile)."""
    B = BucketMatmul
    for kpad in range(796, 1776, 4):
        assert B.plan_for(kpad, 40) is None
        (tp, kc, stages, blocks), group = B.stream_plan(kpad)
        smem = B.stream_smem_bytes(kc, stages)
        assert (tp, blocks) == (B.STREAM_TP, 2) and 2 <= stages <= 4
        assert smem <= B.SMEM_MAX and blocks * (smem + B.SMEM_BLOCK) <= B.SMEM_SM
        assert kc == min(kpad, B.STREAM_KC) and kc % 4 == 0
        assert group == max(1, B.STREAM_L2 // (8 * kpad * B.TILE_ROWS))
    mm = BucketMatmul([np.ones((3, 793))], device="cpu")
    assert mm.mode == "streamed" and mm.kpad == 796 and mm.plan == B.stream_plan(796)[0]
    assert BucketMatmul([np.ones((3, 792))], device="cpu").mode == "resident"


def k2_stream_order(ntiles, npts, tp, group):
    """The (point tile, row tile) of each block of the streamed grid, in
    block order, as ``bucket_matmul_stream_kernel`` computes them."""
    npt = -(-npts // tp)
    span = group * npt
    out = []
    for b in range(npt * ntiles):
        gi, local = divmod(b, span)
        rows_g = min(group, ntiles - gi * group)
        out.append((local // rows_g, gi * group + local % rows_g))
    return out


def k2_stream_replay(mm, phi):
    """C as the streamed kernel computes it from ``mm.At``, ``mm.tiles``,
    ``mm.plan`` and ``mm.group`` on the numpy ``phi`` (>= max_k, npts):
    each block's chunks of kc rows of k, A's as one run of the swizzled
    ``At``, Phi's slab swizzled with rows past ``max_k`` and points past
    npts zero, in the ring's order; the products in the (k, row) x (k,
    point) of the chunk; C's rows and points inside the tile written."""
    tp, kc, stages, _ = mm.plan
    At, tiles = mm.At.numpy(), mm.tiles.numpy()
    npts, kmax = phi.shape[1], mm.max_k
    C = np.full((mm.total_rows, npts), np.nan)
    m, p = np.arange(64), np.arange(tp)
    for pt, tile in k2_stream_order(len(tiles), npts, tp, mm.group):
        row0, nrows, K = tiles[tile]
        kt, p0 = max(4, -(-K // 4) * 4), pt * tp
        acc = np.zeros((64, tp))
        for k0 in range(0, kt, kc):
            kn = min(kc, kt - k0)
            As = At[tile, k0:k0 + kn]                 # one run of the swizzled tile
            Bs = np.full((kn, tp), np.nan)            # the ring's slab
            for k in range(kn):
                live = (k0 + k < kmax) & (p0 + p < npts)
                Bs[k, p ^ k2_swizzle(k)] = np.where(
                    live, phi[min(k0 + k, kmax - 1), np.minimum(p0 + p, npts - 1)], 0.0)
            sw = (k2_swizzle(np.arange(kn)))[:, None]
            acc += As[np.arange(kn)[:, None], m ^ sw].T @ Bs[np.arange(kn)[:, None], p ^ sw]
        c = p[p0 + p < npts]
        C[row0:row0 + nrows, p0 + c] = acc[:nrows][:, c]
    return C


@pytest.mark.parametrize("shapes,npts", [
    (((70, 793), (9, 3)), 300), (((130, 1771), (64, 816), (1, 861)), 257),
    (((200, 796),), 128)], ids=["793+3", "tet-20-16-15", "one-group"])
def test_k2_stream_replay_matches_plain(shapes, npts):
    """The replay of the streamed kernel equals the plain version bit for
    bit on integers (every width group, ragged row and point tiles, rows
    past max_k never read); the grid visits each (point tile, row tile)
    once, and within a group the blocks of one point tile run together."""
    rng = np.random.default_rng(sum(k for _, k in shapes))
    mats = [rng.integers(-4, 5, s).astype(np.float64) for s in shapes]
    mm = BucketMatmul(mats, device="cpu")
    assert mm.mode == "streamed"
    phi = rng.integers(-4, 5, (mm.max_k + 3, npts)).astype(np.float64)
    phi[mm.max_k:] = np.nan                     # rows past max_k: read by no product
    got = k2_stream_replay(mm, phi)
    want = mm.plain(torch.as_tensor(phi)).numpy()
    np.testing.assert_array_equal(got, want)
    assert mm.launches == 0
    ntiles, npt = len(mm.tiles), -(-npts // mm.plan[0])
    for group in (1, 2, mm.group):
        assert k2_stream_order(ntiles, npts, mm.plan[0], group) == [
            (pt, g0 + r) for g0 in range(0, ntiles, group) for pt in range(npt)
            for r in range(min(group, ntiles - g0))]


# -- K6's wide mode on the host ------------------------------------------------------

def _k6(sd, degree, shapes, rng, integers=False):
    mats = [(rng.integers(-4, 5, s).astype(np.float64) if integers else rng.standard_normal(s))
            for s in shapes]
    es = texp.ExpansionSet(tcl.ufc_simplex(sd))
    return ZooF32Kernel(mats, degree, float(es.get_scale(degree)), es.affine_mappings[0],
                        device="cpu")


def test_k6_wide_plan_fits_every_width_past_842():
    """Every Phi tile of 844-1772 rows (tet 16-20, triangle 40) takes the
    wide mode, whose ring of (A chunk, Phi slab) pairs fits two blocks an
    SM in 128-byte units within 232,448 bytes a block; a kernel built past
    842 rows (triangle 40, tet 16) goes wide at construction."""
    K = ZooF32Kernel
    for kpad in range(844, 1774, 2):
        assert K.plan_for(kpad, 40) is None
        (tp, kc, stages, blocks), group = K.wide_plan(kpad)
        smem = K.wide_smem_bytes(kc, stages)
        assert (tp, blocks) == (K.WIDE_TP, 2) and 2 <= stages <= 4 and smem <= K.SMEM_MAX
        assert blocks * (-(-smem // 128) * 128 + K.SMEM_BLOCK) <= K.SMEM_SM
        assert kc % 2 == 0 and kc <= kpad and blocks * K.threads(tp) <= K.THREADS_SM
        assert group == max(1, K.WIDE_L2 // (4 * kpad * K.TILE_ROWS))
    rng = np.random.default_rng(40)
    for sd, degree in ((2, 40), (3, 16)):
        k6 = _k6(sd, degree, ((5, math.comb(degree + sd, sd)),), rng)
        assert k6.mode == "wide" and k6.generic and k6.smem <= K.SMEM_MAX
    assert _k6(2, 39, ((5, 820),), rng).mode == "fused"


def k6_wide_phi(phi, kpad, tp):
    """The wide mode's Phi as ``zoo_f32_phi_kernel`` writes it from the
    recurrence's (kmax, npts): (kpad, npts rounded up to tp), each pair of
    points' columns swapped, rows past kmax zero; the points past npts
    (the recurrence at the coordinates 0) here NaN: no product reads them
    into a stored output."""
    kmax, npts = phi.shape
    ld = -(-npts // tp) * tp
    out = np.full((kpad, ld), np.nan, np.float32)
    out[:kmax, np.arange(npts) ^ 1] = phi
    out[kmax:] = 0.0
    return out


def k6_wide_replay(k6, phi, dst, out):
    """``out`` as the wide product computes it from ``k6.At``, ``k6.tiles``,
    ``k6.plan`` and ``k6.group`` on ``k6_wide_phi(phi)``: each block's
    chunks, A's one run of ``At`` and Phi's slab whole, each warp's 32 rows
    contracted to their own width, Phi's swapped columns un-swapped by the
    FMAs' operand order, the rows inside the tile written through dst."""
    tp, kc, stages, _ = k6.plan
    At, tiles = k6.At.numpy(), k6.tiles.numpy()
    npts = phi.shape[1]
    wide = k6_wide_phi(phi, k6.kpad, tp)
    p = np.arange(tp)
    for pt, tile in k2_stream_order(len(tiles), npts, tp, k6.group):
        row0, nrows, kt, first = tiles[tile, :4]
        widths, p0 = tiles[tile, 4:], pt * tp
        acc = np.zeros((128, tp), np.float32)
        for k0 in range(0, kt, kc):
            kn = min(kc, kt - k0)
            As = At[first + k0:first + k0 + kn]                   # (kn, 128)
            Bs = wide[k0:k0 + kn, p0 + (p ^ 1)]                    # the FMAs' operands
            for w, kw in enumerate(widths):
                rows = slice(32 * w, 32 * w + 32)
                n = max(0, min(kn, kw - k0))
                acc[rows] += As[:n, rows].T @ Bs[:n]
        c = p[p0 + p < npts]
        out[np.ix_(dst[row0:row0 + nrows], p0 + c)] = acc[:nrows][:, c]
    return out


@pytest.mark.parametrize("sd,degree,shapes,npts", [
    (3, 16, ((130, 969), (40, 816)), 200), (2, 40, ((300, 861), (3, 10)), 129),
    (3, 20, ((70, 1771),), 128)], ids=["tet-16-15", "tri-40", "tet-20"])
def test_k6_wide_replay_matches_plain_product(sd, degree, shapes, npts):
    """The replay of the wide product on integer A and Phi equals the plain
    product bit for bit (sums of small integers are exact in float32 in any
    order): K6's tile table and ``At`` at each tile's and warp's width, the
    grid's order, the swapped columns and dst; rows not in dst untouched."""
    rng = np.random.default_rng(degree)
    k6 = _k6(sd, degree, shapes, rng, integers=True)
    assert k6.mode == "wide"
    phi = rng.integers(-3, 4, (k6.max_k, npts)).astype(np.float32)
    dst = rng.permutation(k6.total_rows + 5)[:k6.total_rows].astype(np.int32)
    got = k6_wide_replay(k6, phi, dst, np.full((k6.total_rows + 5, npts), 7.0, np.float32))
    want = np.full_like(got, 7.0)
    k6.product(torch.as_tensor(phi), torch.as_tensor(dst), torch.as_tensor(want))
    np.testing.assert_array_equal(got, want)


# -- on the card ------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _phi_before_nan(rng, rows, npts, cuda, offset=0, integers=False):
    """A (rows, npts) Phi followed in memory by NaN (and starting ``offset``
    doubles into its buffer)."""
    buf = torch.full((offset + (rows + 8) * npts,), float("nan"), dtype=torch.float64,
                     device=cuda)
    phi = buf[offset:offset + rows * npts].view(rows, npts)
    vals = rng.integers(-4, 5, (rows, npts)) if integers else rng.standard_normal((rows, npts))
    phi.copy_(torch.as_tensor(vals.astype(np.float64)))
    return phi


@pytest.mark.cuda
@pytest.mark.parametrize("npts,offset", [(1, 0), (127, 1), (128, 0), (1000, 0), (4097, 1),
                                         (20_000, 0)])
def test_k2_streamed_on_card_matches_plain(npts, offset, cuda):
    """K2's streamed mode (widths 793, 816, 1771 and a narrow group in one
    launch) against its plain version bit for bit on integers, on ragged and
    whole point tiles, an aligned and an unaligned Phi followed by NaN; one
    launch a call, two calls bit for bit."""
    rng = np.random.default_rng(npts)
    mats = [rng.integers(-4, 5, s).astype(np.float64)
            for s in ((70, 793), (130, 1771), (64, 816), (9, 3))]
    mm = BucketMatmul(mats, cuda)
    assert mm.mode == "streamed"
    phi = _phi_before_nan(rng, mm.max_k, npts, cuda, offset, integers=True)
    got, again = mm(phi), mm(phi)
    torch.cuda.synchronize()
    assert mm.launches == 2 and torch.equal(got, again)
    assert torch.equal(got, mm.plain(phi))


@pytest.mark.cuda
def test_k2_streamed_on_card_real_values(cuda):
    """Tet GLL Lagrange 20 (1771 members) on the f64 engine's K1 Phi: K2
    streamed within RTOL_PLAIN of each group's max |plain|."""
    tab = device_tabulator([_gll(ft, tcl, 3, 20)], order=1)
    mm = tab.matmul
    P = torch.as_tensor(_points(3, 5001, 20), device=cuda)
    phi = tab.recurrence(P)
    got, want = mm(phi), mm.plain(phi)
    torch.cuda.synchronize()
    assert mm.mode == "streamed" and mm.launches == 1
    for g, w in zip(mm.views(got), mm.views(want)):
        assert (g - w).abs().max().item() <= RTOL_PLAIN * w.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("sd,degree,npts", [(3, 16, 1), (3, 16, 3001), (2, 40, 129),
                                            (3, 20, 20_000)])
def test_k6_wide_on_card_matches_plain(sd, degree, npts, cuda):
    """K6's wide mode (its Phi stage, then the product) against its plain
    version at RTOL_F32_KERNEL of each row's max |A_r| |Phi|; rows not in
    dst left as they were; one launch of each stage a call."""
    f32 = device_tabulator([_gll(ft, tcl, sd, degree)], order=1, f64=False)
    k6 = f32.kernel
    assert k6.mode == "wide"
    P32 = torch.as_tensor(_points(sd, npts, degree), device=cuda).float()
    out = torch.full((k6.total_rows + 3, npts), 7.0, device=cuda)
    got = k6(P32, f32.dst_plain, out).clone()
    want = k6.plain(P32, f32.dst_plain, torch.full_like(out, 7.0))
    torch.cuda.synchronize()
    assert k6.launches == k6.phi_launches == 1
    phi = k6.phi(P32)[:k6.max_k].double()
    scale = (k6.A.to(cuda).double().abs() @ phi.abs()).amax(dim=1)
    dst = f32.dst_plain.long()
    assert ((got[dst] - want[dst]).abs().amax(dim=1) <= RTOL_F32_KERNEL * scale).all()
    assert torch.equal(got[k6.total_rows:], want[k6.total_rows:])
    assert k6.occupancy() >= k6.plan[3]


@pytest.mark.cuda
@pytest.mark.parametrize("sd,degree", [(1, 16), (1, 26), (2, 16), (2, 17), (3, 11), (3, 15)])
def test_k8_generic_on_card_matches_plain(sd, degree, cuda):
    """K8's generic instantiation against its plain version at
    RTOL_FEATURES of max |features| (the same multiplications, in the same
    order), on 1 and 100,001 points; two calls bit for bit."""
    cell = tcl.ufc_simplex(sd)
    feat = tb.BernsteinFeatures(sd, degree, tb._bary_map(cell), device=cuda)
    assert feat.generic
    for n in (1, 100_001):
        P = torch.as_tensor(_simplex_points(cell, n, degree), device=cuda)
        got, again, want = feat(P), feat(P), feat.plain(P)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert ((got - want).abs().max() / want.abs().max()).item() <= RTOL_FEATURES
    assert feat.launches == 4


@pytest.mark.cuda
def test_wide_entry_points_on_card_one_launch_each(cuda):
    """Tet GLL Lagrange 16 through every entry point on the card: the f64
    tables (K1 + K2 streamed), the f32 tables (K6 wide: its Phi stage and
    its product), moments (K45) and interpolation (K1), one launch of each
    a pass, against the CPU's plain engines (f64 and dual at 1e-12 of
    max(1, max |table|), f32 at RTOL_F32_KERNEL of max abs + 1); and the
    Bernstein route at tet degree 15 (K8 generic + K2 streamed) against the
    host."""
    zoo = [_gll(ft, tcl, 3, 16)]
    pts = _points(3, 3001, 16)
    P = torch.as_tensor(pts, device=cuda)
    tab, cpu = device_tabulator(zoo, order=1), device_tabulator(zoo, order=1, device="cpu")
    got, want = tab(P), cpu(pts)
    torch.cuda.synchronize()
    assert tab.matmul.mode == "streamed"
    assert tab.recurrence.launches == tab.matmul.launches == 1
    for a in want:
        assert _scaled(got[a].cpu().numpy(), want[a].numpy()) <= 1e-12, a
    f32 = device_tabulator(zoo, order=1, f64=False)
    g32, w32 = f32.tables(P), device_tabulator(zoo, order=1, f64=False, device="cpu").tables(pts)
    assert f32.kernel.mode == "wide" and f32.kernel.launches == f32.kernel.phi_launches == 1
    for a in w32:
        g, w = g32[a].cpu().numpy(), w32[a].numpy()
        assert np.abs(g - w).max() <= RTOL_F32_KERNEL * (np.abs(w).max() + 1.0), a
    bt, btc = BatchedTabulator(zoo, order=0), BatchedTabulator(zoo, order=0, device="cpu")
    wf = np.random.default_rng(5).random(len(pts))
    m = tmo.moment_rows(bt, P, torch.as_tensor(wf, device=cuda))
    mc = tmo.moment_rows(btc, pts, wf)
    eng = bt._moment_engine
    assert eng.moments.launches == 1
    assert _scaled(m.cpu().numpy(), mc.numpy()) <= 1e-12
    c = np.random.default_rng(6).random(mc.shape[0]) - 0.5
    u = tmo.interpolate_rows(bt, P, torch.as_tensor(c, device=cuda))
    uc = tmo.interpolate_rows(btc, pts, c)
    assert eng.recurrence.launches == 1
    assert np.abs(u.cpu().numpy() - uc.numpy()).max() <= 1e-12 * np.abs(c).sum()
    el = ft.Lagrange(tcl.ufc_simplex(3), 15)
    fz = FusedZooTabulator(BatchedTabulator([el], order=1), features="bernstein")
    assert fz.features.generic and fz.matmul.mode == "streamed"
    Q = torch.as_tensor(_simplex_points(tcl.ufc_simplex(3), 2000, 15), device=cuda)
    tabs = fz.unpack(fz.block_tables(Q))[0]
    assert fz.features.launches == fz.matmul.launches == 1
    host = el.tabulate(1, Q.cpu().numpy())
    for a, h in host.items():
        assert _scaled(tabs[a].cpu().numpy(), h) <= 1e-8, a
