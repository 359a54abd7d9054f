"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the decision
is made inside the fixture, never at import).  Run them on a machine with
the card:  python -m pytest tests/test_torch_kernels.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from fiat_tpu_torch import device_tabulator
from fiat_tpu_torch import elements as tfe
from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.core.expansions import ExpansionSet
from fiat_tpu_torch.ops.fused_zoo import BucketMatmul
from fiat_tpu_torch.ops.recurrence import DubinerRecurrence
from chip_smoke import merged_macro

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _points(n, seed=3):
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    return pts / (pts.sum(axis=1)[:, None] + 1e-9) * rng.random((n, 1))


@pytest.mark.parametrize("degree", [0, 1, 2, 7, 10, 15])
def test_recurrence_kernel_matches_plain(cuda, degree):
    es = ExpansionSet(tcl.ufc_simplex(2))
    rec = DubinerRecurrence(2, degree, es.get_scale(degree), es.affine_mappings[0], cuda)
    P = torch.as_tensor(_points(1000 + degree), device=cuda)
    got = rec(P)
    torch.cuda.synchronize()
    assert rec.launches == 1
    want = rec.plain(P)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-13


@pytest.mark.parametrize("npts,offset", [(1077, 0), (1024, 0), (1024, 1)])
def test_bucket_matmul_kernel_matches_plain(cuda, npts, offset):
    """Odd point counts and a Phi that starts off 16-byte alignment take the
    kernel's scalar path; the rest its double2 path."""
    rng = np.random.default_rng(8)
    mats = [rng.standard_normal((r, k)) for r, k in ((18, 3), (200, 66), (65, 21), (1, 10))]
    mm = BucketMatmul(mats, cuda)
    buf = torch.as_tensor(rng.standard_normal(66 * npts + offset), device=cuda)
    phi = buf[offset:].view(66, npts)
    got = mm(phi)
    torch.cuda.synchronize()
    assert mm.launches == 1
    want = mm.plain(phi)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-13


def test_bucket_matmul_kernel_raises_past_its_shared_memory(cuda):
    """Contraction width 793 leaves no room for a ring of two 16-row A
    chunks and the C staging beside a 32-point Phi tile in a block's shared
    memory: construction takes the streamed mode, which runs against its
    plain version, and a resident launch after it runs too."""
    rng = np.random.default_rng(793)
    wide = BucketMatmul([rng.standard_normal((4, 793))], cuda)
    assert wide.mode == "streamed"
    _k2_matches_plain(wide, torch.as_tensor(rng.standard_normal((793, 256)), device=cuda))
    ok = BucketMatmul([np.ones((4, 10))], cuda)
    ok(torch.ones((10, 256), dtype=torch.float64, device=cuda))
    assert ok.launches == 1


def test_engine_device_checks(cuda):
    T = tcl.ufc_simplex(2)
    zoo = [tfe.Lagrange(T, 2)]
    pts = torch.as_tensor(_points(300))
    with pytest.raises(ValueError, match="engine on cpu"):
        device_tabulator(zoo, order=1, device="cpu").block_tables(pts.to(cuda))
    gpu = device_tabulator(zoo, order=1, device="cuda")     # no index: the current card
    assert gpu.device == cuda
    with pytest.raises(ValueError, match="engine on cuda:0"):
        gpu.block_tables(pts)
    gpu.block_tables(pts.to(cuda))
    assert gpu.recurrence.launches == 1 and gpu.matmul.launches == 1


def test_engine_on_card_matches_cpu_engine(cuda):
    T = tcl.ufc_simplex(2)
    zoo = [tfe.Lagrange(T, p) for p in (1, 3, 6)] + [tfe.DiscontinuousLagrange(T, 2)]
    pts = _points(513)
    gpu = device_tabulator(zoo, order=1, device=cuda)
    cpu = device_tabulator(zoo, order=1, device="cpu")
    got = gpu.unpack(gpu.block_tables(pts))
    want = cpu.unpack(cpu.block_tables(pts))
    assert gpu.recurrence.launches == 1 and gpu.matmul.launches == 1
    for g, w in zip(got, want):
        for a in w:
            assert (g[a].cpu() - w[a]).abs().max().item() <= 1e-12


def _macro_zoo(T):
    return [tfe.Lagrange(T, 3), tfe.CubicHermite(T), tfe.HsiehCloughTocher(T, 3),
            tfe.QuadraticPowellSabin6(T)]


def _special_points():
    """Points exactly on the interior edges of the Alfeld and Powell-Sabin
    splits, on the Alfeld barycentre (= the Powell-Sabin centre), on the
    edge midpoints and on the vertices."""
    c = np.array([1.0, 1.0]) / 3.0
    ends = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [0.5, 0.5], [0.0, 0.5], [0.5, 0.0]])
    t = np.array([0.0, 0.125, 0.25, 0.5, 0.75])[:, None]
    return np.vstack([c[None]] + [v + t * (c - v) for v in ends])


@pytest.mark.parametrize("order", [0, 1])
def test_macro_kernel_matches_plain(cuda, order):
    """K3 against its plain version: order 0 bins the C0 HCT basis uniquely,
    order 1 averages over the subcells sharing a point."""
    fz = device_tabulator(_macro_zoo(tcl.ufc_simplex(2)), order=order, device=cuda)
    assert [g["unique"] for g in merged_macro(fz).geom] == [order == 0, False]
    P = torch.as_tensor(_points(3001, seed=order), device=cuda)
    got = merged_macro(fz)(P)
    torch.cuda.synchronize()
    assert merged_macro(fz).launches == 1
    want = merged_macro(fz).plain(P)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-13


@pytest.mark.parametrize("order", [0, 1])
def test_macro_kernel_on_facet_barycentre_and_centre_points(cuda, order):
    fz = device_tabulator(_macro_zoo(tcl.ufc_simplex(2)), order=order, device=cuda)
    P = torch.as_tensor(_special_points(), device=cuda)
    got = merged_macro(fz)(P)
    want = merged_macro(fz).plain(P)
    assert torch.isfinite(got).all()
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-13


def test_macro_engine_on_card_matches_host_and_refuses_cpu_points(cuda):
    T = tcl.ufc_simplex(2)
    zoo = _macro_zoo(T)
    pts = np.vstack([_points(700), _special_points()])
    gpu = device_tabulator(zoo, order=1, device=cuda)
    with pytest.raises(ValueError, match="engine on cuda:0"):
        gpu.block_tables(torch.as_tensor(pts))
    # K3's wrapper alone runs its plain version on a CPU tensor, launching nothing
    assert merged_macro(gpu)(torch.as_tensor(pts)).device.type == "cpu"
    assert merged_macro(gpu).launches == 0
    got = gpu.unpack(gpu.block_tables(torch.as_tensor(pts, device=cuda)))
    assert (gpu.recurrence.launches, gpu.matmul.launches, merged_macro(gpu).launches) == (1, 1, 1)
    for el, g in zip(zoo, got):
        want = el.tabulate(1, pts)
        for a in want:
            assert np.abs(g[a].cpu().numpy() - want[a]).max() <= 1e-10


def _moment_engine(cuda="cpu"):
    from fiat_tpu_torch.ops.moments import MomentEngine
    from fiat_tpu_torch.ops.tabulate import BatchedTabulator
    T = tcl.ufc_simplex(2)
    zoo = [tfe.Lagrange(T, 10), tfe.RaviartThomas(T, 2)] + _macro_zoo(T)
    return MomentEngine(BatchedTabulator(zoo, order=0, device="cpu"), device=cuda)


def _assert_k45_matches_plain(pm, P, wf):
    """One launch against the plain version at 1e-13 of max |plain|
    (the order of the sums differs); no points give exact zeros."""
    got = pm(P, wf)
    torch.cuda.synchronize()
    assert pm.launches == 1 and tuple(got.shape) == (pm.rows,)
    want = pm.plain(P, wf)
    if P.shape[0] == 0:
        assert not got.any()
    else:
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-13


@pytest.mark.parametrize("npts", [0, 1, 31, 33, 127, 1077, 100_000])
def test_moments_kernel_matches_plain(cuda, npts):
    """K45 (plain and masked moments in one launch) against its plain
    version at partial warp tiles and at the bench's size."""
    eng = _moment_engine(cuda)
    rng = np.random.default_rng(npts)
    P = torch.as_tensor(_points(npts, seed=npts).reshape(npts, 2), device=cuda)
    wf = torch.as_tensor(rng.random(npts), device=cuda)
    _assert_k45_matches_plain(eng.moments, P, wf)


def test_moments_kernel_on_facet_barycentre_and_centre_points(cuda):
    eng = _moment_engine(cuda)
    P = torch.as_tensor(_special_points(), device=cuda)
    wf = torch.linspace(0.5, 1.5, len(P), dtype=torch.float64, device=cuda)
    got, want = eng.moments(P, wf), eng.moments.plain(P, wf)
    assert torch.isfinite(got).all()
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-13


def test_moments_and_interpolation_on_card_match_cpu_engine_one_launch_each(cuda):
    """A CUDA tensor never takes a plain path: one K45 launch per moments
    pass, one K1 and one K3 launch per interpolation pass."""
    gpu, cpu = _moment_engine(cuda), _moment_engine()
    pts = np.vstack([_points(900), _special_points()])
    rng = np.random.default_rng(4)
    wf, c = rng.random(len(pts)), rng.random(gpu.rows) - 0.5
    with pytest.raises(ValueError, match="engine on cuda:0"):
        gpu.moment_rows(torch.as_tensor(pts), wf)
    got = gpu.moment_rows(torch.as_tensor(pts, device=cuda), torch.as_tensor(wf, device=cuda))
    assert (gpu.moments.launches, gpu.recurrence.launches, merged_macro(gpu).launches) == (1, 0, 0)
    want = cpu.moment_rows(pts, wf)
    assert (got.cpu() - want).abs().max().item() <= 1e-12 * want.abs().max().item()
    u = gpu.interpolate_rows(torch.as_tensor(pts, device=cuda), torch.as_tensor(c, device=cuda))
    assert (gpu.moments.launches, gpu.recurrence.launches, merged_macro(gpu).launches) == (1, 1, 1)
    want = cpu.interpolate_rows(pts, c)
    assert (u.cpu() - want).abs().max().item() <= 1e-12 * want.abs().max().item()


@pytest.mark.parametrize("degree,variant", [(0, None), (1, None), (5, None), (10, None),
                                            (5, "bubble"), (5, "dual")])
def test_f32_kernel_matches_plain(cuda, degree, variant):
    """K6 against its plain version (eager f32 recurrence + full-f32 matmul
    per group); both are f32, so only the order of operations differs."""
    from fiat_tpu_torch.ops.f32_zoo import F32ZooTabulator
    es = ExpansionSet(tcl.ufc_simplex(2), variant=variant)
    nexp = (degree + 1) * (degree + 2) // 2
    rng = np.random.default_rng(degree)
    stacked = rng.standard_normal((300, nexp))
    tab = F32ZooTabulator.from_arrays(
        stacked=stacked, alpha_mats={}, slices=[(0, 100, (100,)), (100, 300, (200,))],
        plain_nexp=None, max_degree=degree, scale=float(es.get_scale(degree)),
        affine_map=es.affine_mappings[0], variant=variant, device=cuda)
    P = torch.as_tensor(_points(3001, seed=degree), device=cuda).float()
    out = torch.empty((300, 3001), device=cuda)
    got = tab.kernel(P, tab.dst_plain, out).clone()
    torch.cuda.synchronize()
    assert tab.kernel.launches == 1
    want = tab.kernel.plain(P, tab.dst_plain, torch.empty_like(out))
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5


@pytest.mark.parametrize("order", [0, 1])
def test_f32_macro_kernel_matches_plain(cuda, order):
    """K3 in float32 (tolerance 1e-5 binning) against its plain version,
    on random points and on points on interior edges and centres."""
    tab = device_tabulator(_macro_zoo(tcl.ufc_simplex(2)), order=order, f64=False, device=cuda)
    assert merged_macro(tab).dtype == torch.float32
    pts = np.vstack([_points(3001, seed=order), _special_points()])
    P = torch.as_tensor(pts, device=cuda).float()
    got = merged_macro(tab)(P)
    torch.cuda.synchronize()
    assert merged_macro(tab).launches == 1
    want = merged_macro(tab).plain(P)
    assert torch.isfinite(got).all()
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5


def test_f32_engine_on_card_one_launch_each_and_refuses_cpu_points(cuda):
    T = tcl.ufc_simplex(2)
    zoo = [tfe.Lagrange(T, p) for p in (1, 4)] + _macro_zoo(T)
    pts = np.vstack([_points(700), _special_points()])
    gpu = device_tabulator(zoo, order=1, f64=False, device=cuda)
    with pytest.raises(ValueError, match="engine on cuda:0"):
        gpu.tables(torch.as_tensor(pts))
    got = gpu.tables(torch.as_tensor(pts, device=cuda))
    assert (gpu.kernel.launches, merged_macro(gpu).launches) == (1, 1)
    want = device_tabulator(zoo, order=1, f64=False, device="cpu").tables(pts)
    for a in want:
        assert (got[a].cpu() - want[a]).abs().max().item() <= 1e-5 * (want[a].abs().max().item() + 1)


# -- tetrahedra: K1's sd = 3 stage, K2 past width 151, K8 ----------------------

def _tet_points(n, seed=5):
    """Uniform points in the UFC tetrahedron (bench.py's pts3 construction)."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 3))
    return pts / (pts.sum(axis=1)[:, None] + 1e-9) * rng.random((n, 1))


def test_default_device_is_the_card(cuda):
    tab = device_tabulator([tfe.Lagrange(tcl.ufc_simplex(3), 2)], order=1)
    assert tab.device == cuda and tab.recurrence.consts.device == cuda


@pytest.mark.parametrize("degree", [0, 1, 2, 5, 8, 10])
def test_tet_recurrence_kernel_matches_plain(cuda, degree):
    es = ExpansionSet(tcl.ufc_simplex(3))
    rec = DubinerRecurrence(3, degree, es.get_scale(degree), es.affine_mappings[0], cuda)
    P = torch.as_tensor(_tet_points(1000 + degree), device=cuda)
    got = rec(P)
    torch.cuda.synchronize()
    assert rec.launches == 1 and tuple(got.shape) == (rec.nexp, 1000 + degree)
    want = rec.plain(P)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-13


@pytest.mark.parametrize("npts", [1077, 1024])
@pytest.mark.parametrize("widths", [(165, 4, 20, 10), (300, 35), (438,)])
def test_wide_bucket_matmul_kernel_matches_plain(cuda, npts, widths):
    """Contraction widths past 104 (the A tile in chunks; past 188 the
    64-point tile, past 396 the 32-point one) mixed with narrow groups, in
    one launch."""
    rng = np.random.default_rng(sum(widths))
    mats = [rng.standard_normal((67 + 13 * i, k)) for i, k in enumerate(widths)]
    mm = BucketMatmul(mats, cuda)
    phi = torch.as_tensor(rng.standard_normal((max(widths), npts)), device=cuda)
    got = mm(phi)
    torch.cuda.synchronize()
    assert mm.launches == 1
    want = mm.plain(phi)
    for g, w in zip(mm.views(got), mm.views(want)):
        assert ((g - w).abs().max() / w.abs().max()).item() <= 1e-13


# -- K2 on the FP64 tensor cores (mma.sync m16n8k4) ------------------------------

def _k2_matches_plain(mm, phi, exact=False):
    """One launch of K2 against its plain version on the same Phi: bit for
    bit, or per group within 1e-13 of the group's max |plain|."""
    got = mm(phi)
    torch.cuda.synchronize()
    assert mm.launches == 1
    want = mm.plain(phi)
    if exact:
        assert torch.equal(got, want)
        return
    assert bool(torch.isfinite(got).all())
    for g, w in zip(mm.views(got), mm.views(want)):
        scale = w.abs().max().item()
        assert (g - w).abs().max().item() <= 1e-13 * scale


def _phi_before_nan(rng, rows, npts, cuda, offset=0):
    """A (rows, npts) Phi followed in memory by NaN (and starting ``offset``
    doubles into its buffer): a kernel that reads past Phi's rows, or
    multiplies uninitialised shared memory, returns NaN."""
    buf = torch.full((offset + (rows + 8) * npts,), float("nan"), dtype=torch.float64,
                     device=cuda)
    phi = buf[offset:offset + rows * npts].view(rows, npts)
    phi.copy_(torch.as_tensor(rng.standard_normal((rows, npts))))
    return phi


@pytest.mark.parametrize("width", [1, 3, 5, 66, 165, 167, 438])
def test_dmma_bucket_matmul_widths(cuda, width):
    """Contraction widths that are not a multiple of the MMA's depth, the
    widest group beside a one-column one, on a Phi of exactly ``width``
    rows followed by NaN: the rows past it are zeros in shared memory."""
    rng = np.random.default_rng(width)
    mats = [rng.standard_normal((70, width)), rng.standard_normal((9, 1))]
    mm = BucketMatmul(mats, cuda)
    assert mm.kpad % 4 == 0 and mm.kpad - width < 4
    _k2_matches_plain(mm, _phi_before_nan(rng, width, 1077, cuda))


def test_dmma_bucket_matmul_ragged_row_tiles(cuda):
    """Row counts of 1 to 129: tiles of 1 to 64 rows that end inside an
    MMA tile, a warp tile or an 8-row staging slab."""
    rng = np.random.default_rng(12)
    for rows in (1, 2, 7, 8, 9, 15, 16, 17, 31, 33, 47, 63, 64, 65, 127, 129):
        mm = BucketMatmul([rng.standard_normal((rows, 21))], cuda)
        _k2_matches_plain(mm, torch.as_tensor(rng.standard_normal((21, 333)), device=cuda))


@pytest.mark.parametrize("npts,offset", [(0, 0), (1, 0), (127, 0), (1077, 0), (1024, 1),
                                         (1077, 1)])
def test_dmma_bucket_matmul_point_counts(cuda, npts, offset):
    """No point, one, a point tile short of one, a ragged last tile, and a
    Phi that starts off 16-byte alignment (the scalar paths)."""
    rng = np.random.default_rng(npts + offset)
    mats = [rng.standard_normal((r, k)) for r, k in ((18, 3), (200, 66), (65, 21), (1, 10))]
    mm = BucketMatmul(mats, cuda)
    phi = _phi_before_nan(rng, 66, npts, cuda, offset)
    if npts:
        _k2_matches_plain(mm, phi)
    else:
        assert tuple(mm(phi).shape) == (mm.total_rows, 0) and mm.launches == 0


@pytest.mark.parametrize("widths", [(3, 66), (165,), (3, 66, 165, 438)])
def test_dmma_bucket_matmul_is_exact_on_integers(cuda, widths):
    """Integer A and Phi in [-8, 8]: every partial sum is an integer below
    2^53, exact in f64 whatever the order, so the kernel must equal the
    plain version bit for bit and a fragment-layout error cannot hide under
    1e-13.  Point tiles of 128 (K <= 165) and 32 (K 438)."""
    rng = np.random.default_rng(len(widths))
    mats = [rng.integers(-8, 9, (37 + 29 * i, k)).astype(np.float64)
            for i, k in enumerate(widths)]
    mm = BucketMatmul(mats, cuda)
    phi = torch.as_tensor(rng.integers(-8, 9, (max(widths), 1077)).astype(np.float64),
                          device=cuda)
    _k2_matches_plain(mm, phi, exact=True)


def test_dmma_bucket_matmul_widest(cuda):
    """The widest contraction the plan takes (792) runs, on a 32-point tile
    and two 16-row A chunks: the host's shared-memory sum is the entry's."""
    width = 792
    assert BucketMatmul.plan_for(width + 4, 2) is None
    rng = np.random.default_rng(width)
    mm = BucketMatmul([rng.standard_normal((80, width))], cuda)
    assert mm.plan == (32, 16, 2, 1)
    _k2_matches_plain(mm, torch.as_tensor(rng.standard_normal((width, 300)), device=cuda))


@pytest.mark.parametrize("tp", [128, 64, 32])
@pytest.mark.parametrize("blocks", [1, 2])
def test_dmma_bucket_matmul_every_instantiation(cuda, tp, blocks):
    """Each point tile built for one and for two blocks an SM, forced on a
    narrow zoo of 1100 rows (the plan takes most of them only at other
    widths or row counts, and 64 points on two blocks never), bit for bit
    on integers."""
    rng = np.random.default_rng(tp + blocks)
    mats = [rng.integers(-8, 9, (r, k)).astype(np.float64) for r, k in ((900, 20), (200, 7))]
    mm = BucketMatmul(mats, cuda)
    mm.plan = BucketMatmul.fit(mm.kpad, tp, blocks)
    assert mm.plan[1] == mm.kpad == 20
    _k2_matches_plain(mm, torch.as_tensor(rng.integers(-8, 9, (20, 1077)).astype(np.float64),
                                          device=cuda), exact=True)


def test_bucket_matmul_entry_refuses_a_plan_past_shared_memory(cuda):
    """The C entry checks the host's plan: a Phi tile and ring of A chunks
    that do not fit a block's shared memory (or two blocks' an SM), a point
    tile it has no kernel for, a chunk or kpad that is not a multiple of
    the MMA's depth, a ring of other than 2 to 4 chunks, or other than 1
    or 2 blocks an SM, is refused with cudaErrorInvalidValue, launching
    nothing."""
    from fiat_tpu_torch.ops.kernels import load_kernels, stream_of
    mm = BucketMatmul([np.ones((64, 208))], cuda)
    assert (mm.kpad, mm.plan) == (208, (64, 108, 2, 1))
    phi = torch.ones((208, 256), dtype=torch.float64, device=cuda)
    C = torch.zeros((64, 256), dtype=torch.float64, device=cuda)
    lib = load_kernels()
    for kpad, tp, kc, stages, minb in ((208, 128, 16, 2, 1), (208, 64, 56, 4, 1),
                                       (208, 96, 16, 4, 1), (208, 64, 50, 2, 1),
                                       (210, 64, 52, 2, 1), (208, 64, 16, 5, 1),
                                       (208, 64, 16, 1, 1), (208, 64, 16, 2, 2),
                                       (208, 64, 16, 2, 0), (208, 64, 16, 2, 3)):
        err = lib.fiat_bucket_matmul(mm.At.data_ptr(), kpad, mm.max_k, tp, kc, stages, minb,
                                     mm.tiles.data_ptr(), mm.tiles.shape[0], phi.data_ptr(), 256,
                                     256, C.data_ptr(), stream_of(phi))
        assert err == 1                 # cudaErrorInvalidValue
    torch.cuda.synchronize()
    assert C.abs().max().item() == 0.0
    _k2_matches_plain(mm, phi)


@pytest.mark.parametrize("sd,degree", [(1, 0), (1, 15), (2, 1), (2, 7), (2, 15), (3, 0),
                                       (3, 4), (3, 8), (3, 10)])
def test_bernstein_kernel_matches_plain(cuda, sd, degree):
    from fiat_tpu_torch.ops.bernstein import BernsteinFeatures, _bary_map
    cell = tcl.ufc_simplex(sd)
    feat = BernsteinFeatures(sd, degree, _bary_map(cell), cuda)
    lam = np.random.default_rng(degree).dirichlet(np.ones(sd + 1), 1001)
    P = torch.as_tensor(lam @ np.asarray(cell.get_vertices()), device=cuda)
    got = feat(P)
    torch.cuda.synchronize()
    assert feat.launches == 1
    want = feat.plain(P)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-13


def _tet_zoo(T):
    return ([tfe.RaviartThomas(T, k) for k in (1, 2)] + [tfe.Nedelec(T, k) for k in (1, 2)]
            + [tfe.BrezziDouglasMarini(T, k) for k in (1, 2)] + [tfe.Lagrange(T, 3)])


@pytest.mark.parametrize("features", ["dubiner", "bernstein"])
def test_tet_engines_on_card_one_launch_each_match_host(cuda, features):
    from fiat_tpu_torch.ops.fused_zoo import FusedZooTabulator
    from fiat_tpu_torch.ops.tabulate import BatchedTabulator
    T = tcl.ufc_simplex(3)
    zoo = [tfe.Lagrange(T, 8)] if features == "bernstein" else _tet_zoo(T)
    tab = FusedZooTabulator(BatchedTabulator(zoo, order=1, device="cpu"), device=cuda,
                            features=features)
    pts = _tet_points(701)
    with pytest.raises(ValueError, match="engine on cuda:0"):
        tab.block_tables(torch.as_tensor(pts))
    got = tab.unpack(tab.block_tables(torch.as_tensor(pts, device=cuda)))
    basis = tab.features if features == "bernstein" else tab.recurrence
    assert (basis.launches, tab.matmul.launches) == (1, 1)
    assert (tab.recurrence, tab.features)[features == "dubiner"] is None
    for el, g in zip(zoo, got):
        want = el.tabulate(1, pts)
        for a in want:
            assert np.abs(g[a].cpu().numpy() - want[a]).max() <= 1e-10


def test_bernstein_wrapper_refuses_points_on_another_device(cuda):
    from fiat_tpu_torch.ops.bernstein import BernsteinFeatures, _bary_map
    feat = BernsteinFeatures(3, 2, _bary_map(tcl.ufc_simplex(3)), cuda)
    P = torch.as_tensor(_tet_points(10))
    assert feat(P).device.type == "cpu" and feat.launches == 0
    with pytest.raises(ValueError, match="engine on cuda:0"):
        feat(P.to("meta"))
    with pytest.raises(ValueError, match="shape"):
        feat(torch.zeros((4, 2), dtype=torch.float64, device=cuda))


# -- K7: macro elements on tetrahedra (and triangle zoos past 32 subcells) ---

def _sv_zoo(T, wide=False):
    """sv_macro_tet: the Scott-Vogelius pairs on Alfeld and Worsey-Farin
    splits; ``wide`` adds Lagrange 3 on Worsey-Farin (44 subcells in all)."""
    zoo = [tfe.Lagrange(T, 1), tfe.Lagrange(T, 3), tfe.Lagrange(T, 3, variant="alfeld"),
           tfe.DiscontinuousLagrange(T, 2, variant="alfeld"),
           tfe.Lagrange(T, 2, variant="worsey-farin"),
           tfe.DiscontinuousLagrange(T, 1, variant="worsey-farin")]
    return zoo + [tfe.Lagrange(T, 3, variant="worsey-farin")] if wide else zoo


_K7_ZOOS = {
    "alfeld": lambda T: [tfe.Lagrange(T, 3), tfe.Lagrange(T, 3, variant="alfeld"),
                         tfe.DiscontinuousLagrange(T, 2, variant="alfeld")],
    "worsey-farin": lambda T: [tfe.Lagrange(T, 2), tfe.Lagrange(T, 2, variant="worsey-farin"),
                               tfe.DiscontinuousLagrange(T, 1, variant="worsey-farin")],
    "sv_wide": lambda T: _sv_zoo(T, wide=True),
}


def _tet_special_points():
    """Points where subcells meet: the barycentre (the Alfeld and
    Worsey-Farin centre), the face centres (Worsey-Farin), the vertices,
    points on the Alfeld interior faces and on the Worsey-Farin interior
    edges (centre to vertices, to face centres, face centres to vertices)."""
    V = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    c = V.mean(axis=0)
    faces = [V[[j for j in range(4) if j != i]].mean(axis=0) for i in range(4)]
    t = np.array([0.25, 0.5, 0.75])[:, None]
    segs = [v + t * (c - v) for v in list(V) + faces]
    segs += [f + t * (V[j] - f) for i, f in enumerate(faces) for j in range(4) if j != i]
    alfeld_faces = [(V[i] + V[j] + c) / 3 for i in range(4) for j in range(i + 1, 4)]
    return np.vstack([c[None], np.asarray(faces), V, *segs, np.asarray(alfeld_faces)])


@pytest.mark.parametrize("npts", [1, 1077, 100_000])
@pytest.mark.parametrize("zoo", sorted(_K7_ZOOS))
def test_masked_matmul_kernel_matches_plain(cuda, zoo, npts):
    """K7 against its plain version on the same Phi and points: each split
    alone, and a zoo of 44 subcells (past K3's 32)."""
    fz = device_tabulator(_K7_ZOOS[zoo](tcl.ufc_simplex(3)), order=1, device=cuda)
    k7 = merged_macro(fz)
    assert k7.name == "K7" and k7.sd == 3
    P = torch.as_tensor(_tet_points(npts, seed=npts), device=cuda)
    phi = fz.recurrence(P)
    got = k7(P, phi)
    torch.cuda.synchronize()
    assert k7.launches == 1 and tuple(got.shape) == (k7.rows, npts)
    want = k7.plain(P, phi)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-13


@pytest.mark.parametrize("order", [0, 1])
def test_masked_matmul_kernel_on_tie_points(cuda, order):
    """Points on interior faces, edges and centres: several subcells take
    them, averaged (order 1) or first hit of a C0 basis (order 0)."""
    fz = device_tabulator(_sv_zoo(tcl.ufc_simplex(3)), order=order, device=cuda)
    assert [g["unique"] for g in merged_macro(fz).geom] == [order == 0, False, order == 0, False]
    P = torch.as_tensor(_tet_special_points(), device=cuda)
    phi = fz.recurrence(P)
    got, want = merged_macro(fz)(P, phi), merged_macro(fz).plain(P, phi)
    assert torch.isfinite(got).all()
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-13


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("npts,offset", [(1077, 0), (1078, 0), (100_003, 0), (100_000, 0),
                                         (100_000, 1)])
def test_masked_matmul_kernel_under_every_plan(cuda, npts, offset, order):
    """sv_macro_tet under every candidate plan (point tiles 256, 128, 64,
    slices from the widest chunk down to ones that cut pieces, rings of 2 to
    4) and under slices of one to six k, on ragged point
    counts (none a multiple of a tile), odd and even ones (Phi by plain
    loads or by bulk copy), a Phi that starts off 16-byte alignment, unique
    programs (order 0) and averaged ones: each plan equals the plain
    version and gives the same bits as the wrapper's own plan on the points
    inside one subcell (each output is one FMA chain in (c, k) order; a tie
    point's pieces interleave by runs of k where a chunk is cut), and on
    every point where its slices hold whole chunks; two calls give the same
    bits."""
    fz = device_tabulator(_sv_zoo(tcl.ufc_simplex(3)), order=order, device=cuda)
    k7 = merged_macro(fz)
    assert [g["unique"] for g in k7.geom] == [order == 0, False, order == 0, False]
    ties = _tet_special_points()
    P = torch.as_tensor(np.vstack([_tet_points(npts - len(ties), seed=npts), ties]),
                        device=cuda)
    rec = fz.recurrence(P)
    buf = torch.empty(rec.numel() + offset, dtype=torch.float64, device=cuda)
    phi = buf[offset:].view(rec.shape)
    phi.copy_(rec)
    want = k7.plain(P, phi)
    mine = k7.plan
    first = k7(P, phi)
    assert torch.equal(first, k7(P, phi))
    plans = k7.candidates(k7.max_nexp, k7.chunk_cols, 3, 2)
    assert mine in plans and any(cols < k7.chunk_cols for _, cols, _, _ in plans)
    plans += [(64, 12, 3, 1), (128, 24, 2, 1), (256, 13, 4, 1)]   # runs of 1 to 6 k
    rand = npts - len(ties)      # points inside one subcell: one hit, one chain
    whole = None                 # the first plan whose slices hold whole chunks
    for plan in plans:
        k7.plan = plan
        got = k7(P, phi)
        torch.cuda.synchronize()
        assert torch.equal(got[:, :rand], first[:, :rand]), plan
        if plan[1] >= k7.chunk_cols:  # a tie point's hits in (c, k) order too
            whole = got if whole is None else whole
            assert torch.equal(got, whole), plan
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-13
    assert whole is not None
    k7.plan = mine
    assert k7.launches == 2 + len(plans)
    assert ((first - want).abs().max() / want.abs().max()).item() <= 1e-13


@pytest.mark.parametrize("npts", [1, 1077, 100_000])
def test_masked_matmul_kernel_past_the_old_shared_memory_ceiling(cuda, npts):
    """Lagrange 1 + Worsey-Farin DG 6: row chunks of 274,176 bytes, past a
    block's shared memory, streamed in slices; against the plain version
    (relative to |A| |B|: A's entries reach 5.2e5 and its sums cancel), and
    the tables on the card against host tabulation."""
    T = tcl.ufc_simplex(3)
    zoo = [tfe.Lagrange(T, 1), tfe.DiscontinuousLagrange(T, 6, variant="worsey-farin")]
    fz = device_tabulator(zoo, order=1, device=cuda)
    k7 = merged_macro(fz)
    assert k7.name == "K7" and k7.plan[1] < k7.chunk_cols
    P = torch.as_tensor(_tet_points(npts, seed=npts), device=cuda)
    phi = fz.recurrence(P)
    got = k7(P, phi)
    torch.cuda.synchronize()
    want = k7.plain(P, phi)
    scale = (k7.A.abs() @ k7.masked_basis(k7.masks(P)[0], phi).abs()).max().item()
    assert k7.launches == 1 and (got - want).abs().max().item() <= 1e-13 * scale
    pts = np.vstack([_tet_points(300), _tet_special_points()])
    tables = fz.unpack(fz.block_tables(torch.as_tensor(pts, device=cuda)))
    for el, g in zip(zoo, tables):
        for a, w in el.tabulate(1, pts).items():
            scale = max(1.0, float(np.abs(w).max()))
            assert np.abs(g[a].cpu().numpy() - w).max() <= 1e-9 * scale, a


def test_masked_matmul_kernel_matches_k3_on_triangle_macro_arrays(cuda):
    """K7 on the merged macro arrays of HCT + PS6 (K3's 63 x 66), reading
    the zoo's degree-10 Phi by prefix, against K3."""
    from fiat_tpu_torch.ops.masked_matmul import MaskedMatmul
    T = tcl.ufc_simplex(2)
    fz = device_tabulator([tfe.Lagrange(T, 10)] + _macro_zoo(T), order=1, device=cuda)
    mo = merged_macro(fz)
    assert mo.name == "K3" and (mo.rows, mo.K) == (63, 66)
    k7 = MaskedMatmul(mo.A.cpu().numpy(), list(enumerate(mo.nexp)), mo.geom, mo.parent_map,
                      device=cuda)
    P = torch.as_tensor(np.vstack([_points(3001), _special_points()]), device=cuda)
    got, want = k7(P, fz.recurrence(P)), mo(P)
    torch.cuda.synchronize()
    assert k7.launches == 1
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-13


def test_sv_macro_tet_on_card_one_launch_each_matches_host(cuda):
    """One pass launches K1, K2 and K7 once each; K1 runs at the macro
    degree when it exceeds the plain one, and a CPU tensor is refused."""
    T = tcl.ufc_simplex(3)
    for zoo in (_sv_zoo(T), [tfe.Lagrange(T, 1), tfe.Lagrange(T, 3, variant="alfeld")]):
        tab = device_tabulator(zoo, order=1, device=cuda)
        assert merged_macro(tab).name == "K7" and tab.recurrence.degree == 3
        pts = np.vstack([_tet_points(900), _tet_special_points()])
        with pytest.raises(ValueError, match="engine on cuda:0"):
            tab.block_tables(torch.as_tensor(pts))
        got = tab.unpack(tab.block_tables(torch.as_tensor(pts, device=cuda)))
        launches = (tab.recurrence.launches, tab.matmul.launches, merged_macro(tab).launches)
        assert launches == (1, 1, 1)
        for el, g in zip(zoo, got):
            want = el.tabulate(1, pts)
            for a in want:
                assert np.abs(g[a].cpu().numpy() - want[a]).max() <= 1e-10


# -- tetrahedra through dual evaluation (K45 sd = 3) and the f32 engine (K6 sd = 3)

def _tet_moment_engine(zoo, device="cpu"):
    from fiat_tpu_torch.ops.moments import MomentEngine
    from fiat_tpu_torch.ops.tabulate import BatchedTabulator
    return MomentEngine(BatchedTabulator(zoo, order=0, device="cpu"), device=device)


@pytest.mark.parametrize("npts", [0, 1, 31, 33, 1077, 100_000])
@pytest.mark.parametrize("degree", [0, 3, 8])
def test_tet_moments_kernel_plain_rows_match_plain(cuda, degree, npts):
    """K45's sd = 3 stage on the plain rows alone."""
    from fiat_tpu_torch.ops.moment_kernel import PairMoments
    es = ExpansionSet(tcl.ufc_simplex(3))
    nexp = (degree + 1) * (degree + 2) * (degree + 3) // 6
    pm = PairMoments(degree, nexp, es.get_scale(degree), es.affine_mappings[0], device=cuda)
    P = torch.as_tensor(_tet_points(npts, seed=npts + degree).reshape(npts, 3), device=cuda)
    wf = torch.as_tensor(np.random.default_rng(degree).random(npts), device=cuda)
    _assert_k45_matches_plain(pm, P, wf)


@pytest.mark.parametrize("sd", [2, 3])
def test_moments_kernel_is_deterministic(cuda, sd):
    """Two calls on the same inputs give the same bits: every sum, the last
    block's over the partials too, runs in an order fixed by the launch's
    shape (signed weights, so that the order would show)."""
    if sd == 2:
        pm = _moment_engine(cuda).moments
        P = torch.as_tensor(_points(100_000, seed=5), device=cuda)
    else:
        pm = _tet_moment_engine(_sv_zoo(tcl.ufc_simplex(3)), cuda).moments
        P = torch.as_tensor(_tet_points(100_000, seed=5), device=cuda)
    wf = torch.as_tensor(np.random.default_rng(6).random(P.shape[0]) - 0.5, device=cuda)
    first, second = pm(P, wf), pm(P, wf)
    assert pm.launches == 2 and torch.equal(first, second)


@pytest.mark.parametrize("npts", [0, 1, 31, 33, 1077, 100_000])
def test_tet_moments_kernel_past_the_old_row_cap(cuda, npts):
    """Lagrange 10 beside sv_macro_tet's macro pairs: 574 rows (286 plain +
    288 over 32 subcells; the per-lane layout took at most 454), and degree 10 with 32
    pieces of 286 members (9438 rows, two warps a block), against the plain
    version on random and tie points, and the resident warps an SM."""
    from fiat_tpu_torch.ops.moment_kernel import PairMoments
    T = tcl.ufc_simplex(3)
    pm = _tet_moment_engine([tfe.Lagrange(T, 10)] + _sv_zoo(T)[1:], cuda).moments
    assert (pm.rows, pm.warps) == (574, 4) and pm.resident_warps >= 8
    es = ExpansionSet(T)
    big = PairMoments(10, 286, es.get_scale(10), es.affine_mappings[0], pm.geom, pm.parent_map,
                      [(i, 286) for i in range(32)], device=cuda)
    assert (big.rows, big.warps) == (9438, 2) and big.resident_warps >= 2
    pts = np.vstack([_tet_points(npts, seed=npts).reshape(npts, 3), _tet_special_points()])
    P = torch.as_tensor(pts, device=cuda)
    wf = torch.as_tensor(np.random.default_rng(npts).random(len(pts)) - 0.25, device=cuda)
    _assert_k45_matches_plain(pm, P, wf)
    _assert_k45_matches_plain(big, P, wf)


@pytest.mark.parametrize("npts", [0, 1077, 100_000])
def test_tet_moments_kernel_on_both_splits_and_tie_points(cuda, npts):
    """K45's sd = 3 stage on sv_macro_tet (Alfeld and Worsey-Farin, 32
    subcells; the first hit of each C0 program, 1 / hits of each DG
    program): random points plus points shared by up to 12 subcells."""
    eng = _tet_moment_engine(_sv_zoo(tcl.ufc_simplex(3)), cuda)
    pm = eng.moments
    assert len(pm.piece_nexp) == 32 and pm.rows == 308
    assert [g["unique"] for g in pm.geom] == [True, False, True, False]
    pts = np.vstack([_tet_points(npts, seed=npts), _tet_special_points()])
    P = torch.as_tensor(pts, device=cuda)
    wf = torch.as_tensor(np.random.default_rng(npts).random(len(pts)) - 0.25, device=cuda)
    got = pm(P, wf)
    torch.cuda.synchronize()
    assert pm.launches == 1 and torch.isfinite(got).all()
    want = pm.plain(P, wf)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-13


@pytest.mark.parametrize("zoo", ["hdiv_lagrange", "sv"])
def test_tet_moments_and_interpolation_on_card_match_cpu_engine_one_launch_each(cuda, zoo):
    """One K45 launch per moments pass and one K1 launch per interpolation
    pass, no K45 there; a tet macro zoo's moments never build K3, and its
    interpolation adds one launch of K3's sd = 3 stage."""
    T = tcl.ufc_simplex(3)
    elements = _tet_zoo(T) if zoo == "hdiv_lagrange" else _sv_zoo(T)
    gpu, cpu = _tet_moment_engine(elements, cuda), _tet_moment_engine(elements)
    pts = np.vstack([_tet_points(900), _tet_special_points()])
    rng = np.random.default_rng(6)
    wf, c = rng.random(len(pts)), rng.random(gpu.rows) - 0.5
    with pytest.raises(ValueError, match="engine on cuda:0"):
        gpu.moment_rows(torch.as_tensor(pts), wf)
    got = gpu.moment_rows(torch.as_tensor(pts, device=cuda), torch.as_tensor(wf, device=cuda))
    assert (gpu.moments.launches, gpu.recurrence.launches) == (1, 0)
    want = cpu.moment_rows(pts, wf)
    assert (got.cpu() - want).abs().max().item() <= 1e-12 * want.abs().max().item()
    P, C = torch.as_tensor(pts, device=cuda), torch.as_tensor(c, device=cuda)
    assert gpu.built == {"moments": True, "macro": False}
    u = gpu.interpolate_rows(P, C)
    assert (gpu.moments.launches, gpu.recurrence.launches) == (1, 1)
    if zoo == "sv":
        assert merged_macro(gpu).sd == 3 and merged_macro(gpu).launches == 1
    else:
        assert merged_macro(gpu) is None
    want = cpu.interpolate_rows(pts, c)
    assert (u.cpu() - want).abs().max().item() <= 1e-12 * want.abs().max().item()


@pytest.mark.parametrize("degree,variant", [
    (d, v) for d in (0, 3, 8, 10) for v in (None, "bubble", "dual") if (d, v) != (0, "bubble")])
def test_tet_f32_kernel_matches_plain(cuda, degree, variant):
    """K6's sd = 3 stage against its plain version, every variant (the
    bubble basis starts at degree 1); degree 10 takes the 64-point tile."""
    from fiat_tpu_torch.ops.f32_zoo import F32ZooTabulator
    es = ExpansionSet(tcl.ufc_simplex(3), variant=variant)
    nexp = (degree + 1) * (degree + 2) * (degree + 3) // 6
    rng = np.random.default_rng(degree)
    stacked = rng.standard_normal((300, nexp))
    tab = F32ZooTabulator.from_arrays(
        stacked=stacked, alpha_mats={}, slices=[(0, 100, (100,)), (100, 300, (200,))],
        plain_nexp=None, max_degree=degree, scale=float(es.get_scale(degree)),
        affine_map=es.affine_mappings[0], variant=variant, device=cuda)
    assert tab.kernel.sd == 3 and tab.kernel.plan[0] == (64 if degree == 10 else 128)
    P = torch.as_tensor(_tet_points(3001, seed=degree), device=cuda).float()
    out = torch.empty((300, 3001), device=cuda)
    got = tab.kernel(P, tab.dst_plain, out).clone()
    torch.cuda.synchronize()
    assert tab.kernel.launches == 1
    want = tab.kernel.plain(P, tab.dst_plain, torch.empty_like(out))
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5


def _zoo_kernel(device, sd, degree, shapes, variant=None, seed=0):
    """K6 on random rows of the given (rows, width) groups."""
    from fiat_tpu_torch.ops.f32_zoo import ZooF32Kernel
    es = ExpansionSet(tcl.ufc_simplex(sd), variant=variant)
    rng = np.random.default_rng(seed)
    return ZooF32Kernel([rng.standard_normal(s) for s in shapes], degree,
                        float(es.get_scale(degree)), es.affine_mappings[0], variant, device)


def _k6_matches_plain(k6, npts, device, seed=1):
    """K6 on ``npts`` points of its cell, every packed row to its own output
    row, against its plain version (1e-5 of the plain rows' max abs: only
    the order of the float32 operations differs); returns the output."""
    pts = (_points if k6.sd == 2 else _tet_points)(npts, seed)
    P = torch.as_tensor(pts, device=device).float()
    dst = torch.arange(k6.total_rows, dtype=torch.int32, device=device)
    k6.launches = 0
    got = k6(P, dst, torch.empty((k6.total_rows, npts), device=device)).clone()
    torch.cuda.synchronize()
    assert k6.launches == 1
    want = k6.plain(P, dst, torch.empty_like(got))
    assert torch.isfinite(got).all()
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5
    return got


@pytest.mark.parametrize("npts", [1, 3, 255, 257, 3001, 3072])
@pytest.mark.parametrize("sd,degree", [(2, 10), (3, 8)])
def test_k6_point_counts(cuda, sd, degree, npts):
    """One point to many tiles, ragged and whole last tiles (the bulk
    stores take whole tiles of a point count divisible by 4), on 79 rows
    (a ragged row tile) in two widths."""
    nexp = (degree + 1) * (degree + 2) // 2 if sd == 2 else 165
    _k6_matches_plain(_zoo_kernel(cuda, sd, degree, ((70, nexp), (9, 3)), seed=npts), npts,
                      cuda)


@pytest.mark.parametrize("sd", [2, 3])
def test_k6_ragged_rows_and_width_one(cuda, sd):
    """Row groups of width 1 (a Phi tile padded to 2 rows) beside width 3,
    66 rows: row tiles not a multiple of 64."""
    _k6_matches_plain(_zoo_kernel(cuda, sd, 2, ((1, 1), (63, 1), (2, 3))), 1000, cuda)
    _k6_matches_plain(_zoo_kernel(cuda, sd, 0, ((5, 1),)), 4000, cuda)


@pytest.mark.parametrize("variant", [None, "bubble", "dual"])
@pytest.mark.parametrize("degree", [9, 10])
def test_k6_tet_degrees_9_and_10(cuda, degree, variant):
    """The 64-point tiles of the widest tetrahedral Phi, every variant."""
    nexp = (degree + 1) * (degree + 2) * (degree + 3) // 6
    k6 = _zoo_kernel(cuda, 3, degree, ((100, nexp), (30, 20)), variant)
    assert k6.plan[0] == 64
    _k6_matches_plain(k6, 2000, cuda)


@pytest.mark.parametrize("sd,degree,width", [(2, 10, 66), (3, 8, 165), (3, 3, 20), (2, 15, 136)])
def test_k6_every_candidate_plan(cuda, sd, degree, width):
    """Every plan the host offers (each point tile at each count of blocks an
    SM) computes the same rows, and holds its blocks an SM on the card."""
    k6 = _zoo_kernel(cuda, sd, degree, ((150, width), (40, 7)))
    plans = k6.candidates(k6.kpad)
    assert k6.plan in plans and len(plans) >= 1
    for plan in plans:
        k6.plan = plan
        assert k6.occupancy() >= plan[3]
        _k6_matches_plain(k6, 3000, cuda)


def test_k6_plans_hold_their_blocks_at_every_degree(cuda):
    """At every degree and cell, a full-width zoo's plan keeps its planned
    blocks an SM resident (registers within the launch bounds, shared memory
    within the SM's)."""
    import math
    for sd, top in ((2, 15), (3, 10)):
        for degree in range(top + 1):
            n = math.comb(degree + sd, sd)
            k6 = _zoo_kernel(cuda, sd, degree, ((64, n),))
            assert k6.occupancy() >= k6.plan[3] >= 2, (sd, degree, k6.plan)


def test_k6_leaves_rows_outside_dst_untouched_and_repeats_bit_for_bit(cuda):
    """dst scatters 150 rows into every other row of a 320-row output, in
    reverse: the rows it does not name keep their bits (NaN here), and a
    second call gives the same bits."""
    for sd, degree in ((2, 6), (3, 4)):
        k6 = _zoo_kernel(cuda, sd, degree, ((110, 28 if sd == 2 else 35), (40, 10)))
        P = torch.as_tensor((_points if sd == 2 else _tet_points)(4096, 9),
                            device=cuda).float()
        dst = torch.arange(2 * 149, -1, -2, dtype=torch.int32, device=cuda)
        out = torch.full((320, 4096), float("nan"), device=cuda)
        first = k6(P, dst, out).clone()
        second = k6(P, dst, out)
        torch.cuda.synchronize()
        assert torch.equal(first.view(torch.int32), second.view(torch.int32))
        assert k6.launches == 2
        untouched = torch.ones(320, dtype=torch.bool, device=cuda)
        untouched[dst.long()] = False
        assert torch.isnan(first[untouched]).all() and torch.isfinite(first[~untouched]).all()
        want = k6.plain(P, dst, torch.full_like(out, float("nan")))
        scale = want[~untouched].abs().max()
        assert ((first[~untouched] - want[~untouched]).abs().max() / scale).item() <= 1e-5


def test_k6_entry_refuses_plans_it_does_not_take(cuda):
    """The C entry checks the host's plan: a Phi tile, ring and staging past
    a block's shared memory (or the planned blocks' an SM), blocks past the
    launch bounds' registers, a point tile it has no kernel for, a chunk or
    Phi tile off the depth of 2, a ring of other than 2 to 4 chunks, or a
    degree past the generic instantiation's 63 (the split of a point's
    stage-1 rows is a 64-bit mask; degree 11, past the unrolled 10, now
    launches the generic instantiation), is refused with
    cudaErrorInvalidValue, launching nothing."""
    import ctypes
    from fiat_tpu_torch.ops.kernels import load_kernels, stream_of
    k6 = _zoo_kernel(cuda, 3, 8, ((64, 165),))
    assert (k6.kpad, k6.plan) == (166, (128, 28, 2, 2))
    P = torch.as_tensor(_tet_points(256), device=cuda).float()
    dst = torch.arange(64, dtype=torch.int32, device=cuda)
    out = torch.zeros((64, 256), device=cuda)
    affine = (ctypes.c_float * 12)(*k6.affine)
    lib = load_kernels()
    for degree, kpad, tp, kc, stages, minb in (
            (8, 166, 128, 28, 2, 3), (8, 166, 128, 30, 2, 2),
            (8, 166, 256, 28, 2, 2), (8, 166, 96, 28, 2, 2), (8, 166, 128, 27, 2, 2),
            (8, 165, 128, 28, 2, 2), (8, 166, 128, 28, 1, 2), (8, 166, 128, 28, 5, 2),
            (8, 166, 64, 16, 2, 5), (8, 166, 128, 28, 2, 0), (64, 166, 128, 28, 2, 2)):
        err = lib.fiat_zoo_f32(P.data_ptr(), 256, 3, k6.consts.data_ptr(), k6.slots.data_ptr(),
                               affine, k6.scale, degree, k6.At.data_ptr(), kpad, k6.max_k,
                               k6.tiles.data_ptr(), k6.tiles.shape[0], dst.data_ptr(),
                               out.data_ptr(), tp, kc, stages, minb, stream_of(P))
        assert err == 1                 # cudaErrorInvalidValue
    torch.cuda.synchronize()
    assert out.abs().max().item() == 0.0
    _k6_matches_plain(k6, 256, cuda)


def test_tet_f32_engine_on_card_one_launch_matches_cpu_and_refuses_cpu_points(cuda):
    T = tcl.ufc_simplex(3)
    zoo = _tet_zoo(T)
    pts = _tet_points(700)
    gpu = device_tabulator(zoo, order=1, f64=False, device=cuda)
    assert merged_macro(gpu) is None
    with pytest.raises(ValueError, match="engine on cuda:0"):
        gpu.tables(torch.as_tensor(pts))
    got = gpu.tables(torch.as_tensor(pts, device=cuda))
    assert gpu.kernel.launches == 1
    want = device_tabulator(zoo, order=1, f64=False, device="cpu").tables(pts)
    for a in want:
        assert (got[a].cpu() - want[a]).abs().max().item() <= 1e-5 * want[a].abs().max().item()


def test_tet_dual_and_f32_engines_default_to_the_card(cuda):
    from fiat_tpu_torch.ops import moments as tmo
    from fiat_tpu_torch.ops.tabulate import BatchedTabulator
    zoo = [tfe.Lagrange(tcl.ufc_simplex(3), 2)]
    tab = device_tabulator(zoo, order=1, f64=False)
    assert tab.device == cuda and tab.kernel.At.device == cuda
    eng = tmo.moment_engine(BatchedTabulator(zoo, order=0))
    assert eng.device == cuda and eng.moments.slots.device == cuda



# -- K3's sd = 3 stage: macro elements on tetrahedra, f64 and float32 ---------

def _tet_k3(zoo, order, cuda, dtype=torch.float64):
    from fiat_tpu_torch.ops.fused_zoo import _merge_macro_programs
    from fiat_tpu_torch.ops.macro_oneshot import MacroOneShot
    from fiat_tpu_torch.ops.tabulate import BatchedTabulator
    st = BatchedTabulator(zoo, order=order, device="cpu").state()
    merged = _merge_macro_programs(st["macro_programs"], st["scale"], st["affine_map"], order)
    return MacroOneShot(**merged, device=cuda, dtype=dtype)


def _bar(mo, P, want, A=None):
    """The largest difference K3 may have from its plain version: 1e-13 of
    max |plain| in f64; in float32, 1e-6 of the rows' rounding scale, the
    largest sum of |terms| a row adds up (max |A| @ |B| over the plain
    version's masked operand B).  sv_macro_tet's rows at order 0 sum terms
    up to 133x their value, where the float32 plain version is itself
    1.5e-5 of max |plain| from exact arithmetic."""
    if mo.dtype == torch.float64:
        return 1e-13 * want.abs().max().item()
    A = mo.A if A is None else A
    return 1e-6 * (A.abs() @ mo.operand(P)[0].abs()).max().item()


@pytest.mark.parametrize("npts", [1, 1077, 100_000])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("order", [0, 1])
def test_tet_macro_kernel_matches_plain(cuda, order, dtype, npts):
    """K3's sd = 3 stage against its plain version on sv_macro_tet (632 x
    288 at order 1, 21 row chunks), random points plus the tie points (the
    float32 binning, tolerance 1e-5, repeats the plain one bit for bit)."""
    mo = _tet_k3(_sv_zoo(tcl.ufc_simplex(3)), order, cuda, dtype)
    assert mo.sd == 3 and len(mo.nexp) == 32
    pts = np.vstack([_tet_points(npts, seed=npts + order), _tet_special_points()])
    P = torch.as_tensor(pts, device=cuda).to(dtype)
    got = mo(P)
    torch.cuda.synchronize()
    assert mo.launches == 1 and tuple(got.shape) == (mo.rows, len(pts))
    want = mo.plain(P)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= _bar(mo, P, want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tet_macro_kernel_one_row_per_program_matches_plain(cuda, dtype):
    """The interpolation's W: one row per program over its own columns."""
    mo = _tet_k3(_sv_zoo(tcl.ufc_simplex(3)), 0, cuda, dtype)
    rng = np.random.default_rng(12)
    W = rng.standard_normal((len(mo.geom), mo.K)) * np.repeat(
        np.eye(len(mo.geom)), [sum(mo.nexp[c0:c1]) for _, _, c0, c1, _ in mo.progs.cpu().numpy()],
        axis=1)
    P = torch.as_tensor(np.vstack([_tet_points(3001), _tet_special_points()]),
                        device=cuda).to(dtype)
    Wt = torch.as_tensor(W, device=cuda).to(dtype)
    got = mo(P, A=Wt)
    torch.cuda.synchronize()
    assert mo.launches == 1 and tuple(got.shape) == (len(mo.geom), P.shape[0])
    want = mo.plain(P, A=Wt)
    assert (got - want).abs().max().item() <= _bar(mo, P, want, Wt)


@pytest.mark.parametrize("zoo", sorted(_K7_ZOOS))
def test_tet_macro_kernel_matches_k7_on_its_arrays(cuda, zoo):
    """K3's sd = 3 stage on K7's merged arrays (the f64 engine's), reading
    no Phi, against K7 on the same points; the 44-subcell zoo too (K3 bins
    program by program, so a zoo takes any number of subcells)."""
    from fiat_tpu_torch.ops.macro_oneshot import MacroOneShot
    fz = device_tabulator(_K7_ZOOS[zoo](tcl.ufc_simplex(3)), order=1, device=cuda)
    k7, rec = merged_macro(fz), fz.recurrence
    args = (k7.A.cpu().numpy(), list(enumerate(k7.nexp)), k7.geom, k7.parent_map, rec.degree,
            rec.scale, (rec.A, rec.b))
    k3 = MacroOneShot(*args, device=cuda)
    P = torch.as_tensor(np.vstack([_tet_points(5001), _tet_special_points()]), device=cuda)
    got, want = k3(P), k7(P, rec(P))
    torch.cuda.synchronize()
    assert k3.launches == 1
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-13


def test_tet_macro_f32_engine_on_card_one_launch_each_matches_cpu(cuda):
    """sv_macro_tet's f32 tables: one K6 and one K3 float32 launch a pass,
    against the CPU engine and the card's f64 tables (macro rows where both
    binnings put a point in the same subcells)."""
    zoo = _sv_zoo(tcl.ufc_simplex(3))
    pts = np.vstack([_tet_points(900), _tet_special_points()])
    gpu = device_tabulator(zoo, order=1, f64=False, device=cuda)
    assert merged_macro(gpu).sd == 3 and merged_macro(gpu).name == "K3"
    with pytest.raises(ValueError, match="engine on cuda:0"):
        gpu.tables(torch.as_tensor(pts))
    got = gpu.tables(torch.as_tensor(pts, device=cuda))
    assert (gpu.kernel.launches, merged_macro(gpu).launches) == (1, 1)
    want = device_tabulator(zoo, order=1, f64=False, device="cpu").tables(pts)
    P = torch.as_tensor(pts, device=cuda)
    f64 = device_tabulator(zoo, order=1, device=cuda)(P)
    keep, pr = merged_macro(gpu).same_subcells(P), gpu.plain_rows
    for a in want:
        scale = want[a].abs().max().item() + 1.0
        assert (got[a].cpu() - want[a]).abs().max().item() <= 1e-5 * scale
        assert (got[a][:pr].double() - f64[a][:pr]).abs().max().item() <= 5e-6 * scale
        assert (got[a][pr:, keep].double() - f64[a][pr:, keep]).abs().max().item() <= 5e-5 * scale


@pytest.mark.parametrize("order", [1, 2])
def test_c1_macro_zoos_on_card_match_host(cuda, order):
    """bench.py's c1_macro_zoo / c1_macro_hessians on K3's sd = 2 stage:
    the order-2 A (198 x 138, 213.5 KB in f64) fills nearly all of a
    block's shared memory."""
    T = tcl.ufc_simplex(2)
    zoo = [tfe.CubicHermite(T), tfe.Morley(T), tfe.Argyris(T, 5), tfe.Bell(T),
           tfe.HsiehCloughTocher(T, 3), tfe.QuadraticPowellSabin6(T),
           tfe.QuadraticPowellSabin12(T)]
    tab = device_tabulator(zoo, order=order, device=cuda)
    assert merged_macro(tab).name == "K3" and len(merged_macro(tab).nexp) == 21
    pts = np.vstack([_points(1500, seed=order), _special_points()])
    P = torch.as_tensor(pts, device=cuda)
    got = merged_macro(tab)(P)
    torch.cuda.synchronize()
    want = merged_macro(tab).plain(P)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-13
    per = tab.unpack(tab.block_tables(P))
    assert (tab.recurrence.launches, tab.matmul.launches, merged_macro(tab).launches) == (1, 1, 2)
    for el, g in zip(zoo, per):
        host = el.tabulate(order, pts)
        for a in host:
            assert np.abs(g[a].cpu().numpy() - host[a]).max() <= 1e-10


def _c1_zoo(T):
    return [tfe.CubicHermite(T), tfe.Morley(T), tfe.Argyris(T, 5), tfe.Bell(T),
            tfe.HsiehCloughTocher(T, 3), tfe.QuadraticPowellSabin6(T),
            tfe.QuadraticPowellSabin12(T)]


def test_c1_macro_zoo_order3_on_card_matches_plain_and_host(cuda):
    """The C1 zoo at order 3: K3's A (330 x 138, 355.8 KB in f64) is past a
    block's shared memory, which holds a row chunk of it; the kernel
    launches, matches its plain version and the pass matches host."""
    zoo = _c1_zoo(tcl.ufc_simplex(2))
    tab = device_tabulator(zoo, order=3, device=cuda)
    mo = merged_macro(tab)
    assert mo.name == "K3" and (mo.rows, mo.K) == (330, 138) and mo.rows * mo.K * 8 > 227 * 1024
    pts = np.vstack([_points(2500, seed=3), _special_points()])
    P = torch.as_tensor(pts, device=cuda)
    got = mo(P)
    torch.cuda.synchronize()
    assert mo.launches == 1
    want = mo.plain(P)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-13
    per = tab.unpack(tab.block_tables(P))
    assert (tab.recurrence.launches, tab.matmul.launches, mo.launches) == (1, 1, 2)
    for el, g in zip(zoo, per):
        host = el.tabulate(3, pts)
        for a in host:
            assert np.abs(g[a].cpu().numpy() - host[a]).max() <= 1e-10


@pytest.mark.parametrize("npts", [1, 1077, 100_000])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_c1_macro_kernel_matches_plain_at_every_tile_count(cuda, dtype, npts):
    """K3 on the C1 zoo at order 2 (8 row chunks, ragged tails of 8 and 22
    rows): one point, a partial tile, and 1e5 points, where each block walks
    several tiles with its staged chunk."""
    from fiat_tpu_torch.ops.macro_oneshot import tiles_per_block
    zoo = _c1_zoo(tcl.ufc_simplex(2))
    mo = merged_macro(device_tabulator(zoo, order=2, f64=dtype == torch.float64, device=cuda))
    assert mo.chunks[:, 2].tolist() == [32, 32, 8, 32, 22, 32, 32, 8]
    pts = np.vstack([_points(npts, seed=npts), _special_points()])
    P = torch.as_tensor(pts, device=cuda).to(dtype)
    assert tiles_per_block(P.shape[0], mo.chunks.shape[0]) == (6 if npts == 100_000 else 1)
    got = mo(P)
    torch.cuda.synchronize()
    assert mo.launches == 1 and torch.isfinite(got).all()
    want = mo.plain(P)
    assert (got - want).abs().max().item() <= _bar(mo, P, want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("zoo", ["full_zoo_macro", "c1"])
def test_macro_kernel_one_row_per_program_matches_plain(cuda, zoo, dtype):
    """The small chunk height on triangles: one row per program (the
    interpolation's W), every program's one-row chunk in one block."""
    T = tcl.ufc_simplex(2)
    els = _macro_zoo(T) if zoo == "full_zoo_macro" else _c1_zoo(T)
    mo = merged_macro(device_tabulator(els, order=0, f64=dtype == torch.float64, device=cuda))
    assert mo.chunks_one[:, 2].tolist() == [1] * len(mo.geom) and mo.cpb_one == len(mo.geom)
    rng = np.random.default_rng(13)
    W = rng.standard_normal((len(mo.geom), mo.K)) * np.repeat(
        np.eye(len(mo.geom)), [sum(mo.nexp[c0:c1]) for _, _, c0, c1, _ in mo.progs.cpu().numpy()],
        axis=1)
    P = torch.as_tensor(np.vstack([_points(5001), _special_points()]), device=cuda).to(dtype)
    Wt = torch.as_tensor(W, device=cuda).to(dtype)
    got = mo(P, A=Wt)
    torch.cuda.synchronize()
    assert mo.launches == 1 and tuple(got.shape) == (len(mo.geom), P.shape[0])
    want = mo.plain(P, A=Wt)
    assert (got - want).abs().max().item() <= _bar(mo, P, want, Wt)


def test_macro_kernel_streams_the_tables_past_shared_memory(cuda):
    """Lagrange 9 on Powell-Sabin-12 splits beside P1: K3's tables chunk and
    Phi tile (235,840 bytes in f64) pass the card's 227 KB, so the plan
    streams the chunk through a ring of slices; the tables launch K3, match
    its plain version, and the interpolation's one row a program (resident)
    launches K3 and matches its plain version and the CPU engine.  The
    element is ill-conditioned: the folded W reaches 7.5e8 and a value sums
    terms up to 3.4e9 for a result near 1, so the bars are of that rounding
    scale (max |A| @ |B| row by row)."""
    from fiat_tpu_torch.ops.moments import MomentEngine
    from fiat_tpu_torch.ops.tabulate import BatchedTabulator
    T = tcl.ufc_simplex(2)
    zoo = [tfe.Lagrange(T, 1), tfe.Lagrange(T, 9, variant="powell-sabin(12)")]
    pts = np.vstack([_points(3000, seed=9), _special_points()])
    P = torch.as_tensor(pts, device=cuda)
    mo = merged_macro(device_tabulator(zoo, order=0, device=cuda))
    assert mo.name == "K3" and not mo.plan[3] and mo.smem <= 227 * 1024
    got, want = mo(P), mo.plain(P)
    torch.cuda.synchronize()
    assert mo.launches == 1
    scale = (mo.A.abs() @ mo.operand(P)[0].abs()).amax(dim=1, keepdim=True)
    assert bool(((got - want).abs() <= 1e-13 * scale).all())
    gpu = MomentEngine(BatchedTabulator(zoo, order=0, device="cpu"), device=cuda)
    cpu = MomentEngine(BatchedTabulator(zoo, order=0, device="cpu"), device="cpu")
    c = np.random.default_rng(5).random(gpu.rows) - 0.5
    C = torch.as_tensor(c, device=cuda)
    u = gpu.interpolate_rows(P, C)
    torch.cuda.synchronize()
    assert (gpu.recurrence.launches, merged_macro(gpu).launches) == (1, 1)
    W = gpu.program_columns[0] * (C @ gpu.matrix)[gpu.nexp:]
    got, want = merged_macro(gpu)(P, A=W), merged_macro(gpu).plain(P, A=W)
    scale = (W.abs() @ merged_macro(gpu).operand(P)[0].abs()).max().item()
    assert (got - want).abs().max().item() <= 1e-13 * scale
    assert (u.cpu() - cpu.interpolate_rows(pts, c)).abs().max().item() <= 1e-13 * scale


# -- the nodal simplicial families: width 1, tensor-valued rows ----------------

@pytest.mark.parametrize("npts", [1, 1077])
@pytest.mark.parametrize("sd", [2, 3])
def test_families_zoos_on_card_one_launch_each_match_plain_and_host(cuda, sd, npts):
    """chip_smoke.py's families_tri / families_tet (contraction width 1 for
    the degree-0 rows, (sd, sd)-valued rows) through every engine on the
    card: K1 and K2, K45, K1 for interpolation and K6 launch once a pass
    each and match their plain versions, the CPU engines and host."""
    import sys
    from pathlib import Path
    from fiat_tpu_torch.ops import moments as mo
    from fiat_tpu_torch.ops.tabulate import BatchedTabulator
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    specs, comps = ((chip_smoke.FAMILIES_TRI, chip_smoke.COMPOSITES_TRI) if sd == 2
                    else (chip_smoke.FAMILIES_TET, chip_smoke.COMPOSITES_TET))
    zoo = chip_smoke.families_zoo(specs, comps, tcl.ufc_simplex(sd))
    pts = _points(npts) if sd == 2 else _tet_points(npts)
    P = torch.as_tensor(pts, device=cuda)

    tab = device_tabulator(zoo, order=1, device=cuda)
    assert tab.widths[0] == 1
    got = tab.unpack(tab.block_tables(P))
    assert (tab.recurrence.launches, tab.matmul.launches) == (1, 1)
    tab.matmul.launches = 0
    _k2_matches_plain(tab.matmul, tab.recurrence.plain(P))
    for el, g in zip(zoo, got):
        want = el.tabulate(1, pts)
        for a in want:
            assert np.abs(g[a].cpu().numpy() - want[a]).max() <= 1e-10

    gpu = mo.moment_engine(BatchedTabulator(zoo, order=0, device=cuda))
    cpu = mo.MomentEngine(BatchedTabulator(zoo, order=0, device="cpu"), device="cpu")
    rng = np.random.default_rng(sd)
    wf, c = rng.random(npts), rng.random(gpu.rows) - 0.5
    M = gpu.moment_rows(P, torch.as_tensor(wf, device=cuda))
    u = gpu.interpolate_rows(P, torch.as_tensor(c, device=cuda))
    assert (gpu.moments.launches, gpu.recurrence.launches) == (1, 1)
    want = cpu.moment_rows(pts, wf)
    assert (M.cpu() - want).abs().max().item() <= 1e-12 * (want.abs().max().item() + 1)
    want = cpu.interpolate_rows(pts, c)
    assert (u.cpu() - want).abs().max().item() <= 1e-12 * (want.abs().max().item() + 1)

    f32 = device_tabulator(zoo, order=1, f64=False, device=cuda)
    tables = f32.tables(P)
    assert f32.kernel.launches == 1 and merged_macro(f32) is None
    want = device_tabulator(zoo, order=1, f64=False, device="cpu").tables(pts)
    for a in want:
        assert (tables[a].cpu() - want[a]).abs().max().item() \
            <= 1e-5 * (want[a].abs().max().item() + 1)


def _dg0_macro_zoo(sd):
    """DG 0 beside Lagrange 2 on a split: the zoo's degree-0 basis has
    scale 1, the program's parent not, so it takes the per-program route."""
    K = tcl.ufc_simplex(sd)
    variant = "alfeld" if sd == 2 else "worsey-farin"
    return [tfe.DiscontinuousLagrange(K, 0), tfe.Lagrange(K, 2, variant=variant)]


@pytest.mark.parametrize("sd", [2, 3])
def test_per_program_route_on_the_card(cuda, sd):
    """The per-program route (a K3 of its own on the triangle, a K7 with its
    own K1 on the tetrahedron; a K45 of its own for moments) on the card
    against the same engines' plain versions on the CPU, one launch each."""
    from fiat_tpu_torch.ops import moments as mo
    from fiat_tpu_torch.ops.tabulate import BatchedTabulator

    zoo = _dg0_macro_zoo(sd)
    rng = np.random.default_rng(40 + sd)
    pts = rng.random((3001, sd))
    pts = pts / (pts.sum(axis=1)[:, None] + 1e-9) * rng.random((3001, 1))
    P = torch.as_tensor(pts, device=cuda)
    tab = device_tabulator(zoo, order=1, device=cuda)
    (r,) = tab.macro_routes
    got = tab.block_tables(P)
    assert (r.name, r.engine.launches, tab.recurrence.launches) == (
        "K3" if sd == 2 else "K7", 1, 1)
    assert r.recurrence is None if sd == 2 else r.recurrence.launches == 1
    want = device_tabulator(zoo, order=1, device="cpu").block_tables(pts)
    for a in want:
        for g, w in zip(got[a], want[a]):
            assert (g.cpu() - w).abs().max().item() <= 1e-13 * max(1.0, w.abs().max().item())
    eng = mo.moment_engine(BatchedTabulator(zoo, order=0, device=cuda))
    wf = rng.random(len(pts))
    M = eng.moment_rows(P, torch.as_tensor(wf, device=cuda))
    assert [pm.launches for pm in eng.moment_kernels] == [1, 1]
    want = mo.MomentEngine(BatchedTabulator(zoo, order=0, device="cpu"),
                           device="cpu").moment_rows(pts, wf)
    assert (M.cpu() - want).abs().max().item() <= 1e-12 * (want.abs().max().item() + 1)


def test_variant_parent_route_and_jets_on_the_card(cuda):
    """HCT on a "dual" parent (``rebase_program``): K2 on its masked parent
    on the card against the plain version; ``derivs="jets"`` on the card
    keys the value table alone, K1 + K2 + K3 once each."""
    import copy
    from fiat_tpu_torch.ops.fused_zoo import FusedZooTabulator
    from fiat_tpu_torch.ops.tabulate import BatchedTabulator, rebase_program

    T = tcl.ufc_simplex(2)
    zoo = [tfe.Lagrange(T, 3), tfe.HsiehCloughTocher(T, 3), tfe.QuadraticPowellSabin6(T)]
    pts = _points(2048)
    P = torch.as_tensor(pts, device=cuda)
    st = BatchedTabulator(zoo, order=1, device="cpu").state()
    pes = copy.copy(st["macro_programs"][0].parent_es)
    pes.variant = "dual"
    st["macro_programs"] = [rebase_program(st["macro_programs"][0], pes),
                            *st["macro_programs"][1:]]
    tab = FusedZooTabulator.from_arrays(**st, device=cuda)
    assert [r.name for r in tab.macro_routes] == ["K3", "K2"]
    got = tab.block_tables(P)
    assert [r.engine.launches for r in tab.macro_routes] == [1, 1]
    want = FusedZooTabulator.from_arrays(**st, device="cpu").block_tables(pts)
    for a in want:
        for g, w in zip(got[a], want[a]):
            assert (g.cpu() - w).abs().max().item() <= 1e-13 * max(1.0, w.abs().max().item())

    jets = device_tabulator(zoo, order=1, derivs="jets", device=cuda)
    blocks = jets.block_tables(P)
    assert set(blocks) == {(0, 0)}
    launches = (jets.recurrence.launches, jets.matmul.launches, merged_macro(jets).launches)
    assert launches == (1, 1, 1)
    want = device_tabulator(zoo, order=1, derivs="jets", device="cpu").block_tables(pts)
    for g, w in zip(blocks[(0, 0)], want[(0, 0)]):
        assert (g.cpu() - w).abs().max().item() <= 1e-13 * max(1.0, w.abs().max().item())


@pytest.mark.parametrize("n,backend", [(1, "nccl"), (2, "gloo")])
def test_sharded_steps_on_the_card(cuda, n, backend):
    """Every sharded step in a spawned world on the card (NCCL for one
    rank; gloo for two ranks on one card) against a gloo world of one on
    the CPU."""
    from fiat_tpu_torch.parallel import sharding as sh

    spec = (2, sh.FLAGSHIP[1] + [("HsiehCloughTocher", 3)])
    rng = np.random.default_rng(9)
    pts = rng.random((4000, 2)) * 0.5
    w, f = np.ones(4000) / 4000, rng.random(4000)
    rows = sum(el.space_dimension() * int(np.prod(el.value_shape(), dtype=int))
               for el in sh.build_zoo(spec))
    c = rng.random(rows) - 0.5
    (got, launches), *_ = sh.spawn_world(n, sh.run_steps,
                                         (spec, pts, w, f, c, (1, n), pts[:64], "cuda"),
                                         backend=backend, device="cuda")
    (want, _), = sh.spawn_world(1, sh.run_steps, (spec, pts, w, f, c, (1, 1), pts[:64]))
    assert launches["moments"] == {"K45": 1} and launches["fused"]["K2"] == 1
    rows = len(want["moments"])
    for key in ("moments", "interpolation", "moments_2d"):
        scale = max(1.0, float(np.abs(want[key]).max()))
        assert np.abs(got[key][:len(want[key])] - want[key]).max() <= 1e-12 * scale, key
    assert not np.any(got["moments_2d"][rows:])
    for mine, ref in zip(got["fused"], want["fused"]):
        for a in ref:
            assert np.abs(mine[a] - ref[a]).max() <= 1e-13 * max(1.0, np.abs(ref[a]).max())
