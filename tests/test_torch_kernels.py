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
    """Contraction width 150 needs more shared memory than a block may
    have: the C entry's error surfaces as a raise, with no launch."""
    mm = BucketMatmul([np.ones((4, 150))], cuda)
    with pytest.raises(RuntimeError, match="contraction width 150"):
        mm(torch.ones((150, 256), dtype=torch.float64, device=cuda))
    assert mm.launches == 0
    # the refused launch leaves no error behind for the next one to report
    ok = BucketMatmul([np.ones((4, 10))], cuda)
    ok(torch.ones((10, 256), dtype=torch.float64, device=cuda))
    assert ok.launches == 1


def test_engine_device_checks(cuda):
    T = tcl.ufc_simplex(2)
    zoo = [tfe.Lagrange(T, 2)]
    pts = torch.as_tensor(_points(300))
    with pytest.raises(ValueError, match="engine on cpu"):
        device_tabulator(zoo, order=1).block_tables(pts.to(cuda))
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
    cpu = device_tabulator(zoo, order=1)
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
    assert [g["unique"] for g in fz.macro.geom] == [order == 0, False]
    P = torch.as_tensor(_points(3001, seed=order), device=cuda)
    got = fz.macro(P)
    torch.cuda.synchronize()
    assert fz.macro.launches == 1
    want = fz.macro.plain(P)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-13


@pytest.mark.parametrize("order", [0, 1])
def test_macro_kernel_on_facet_barycentre_and_centre_points(cuda, order):
    fz = device_tabulator(_macro_zoo(tcl.ufc_simplex(2)), order=order, device=cuda)
    P = torch.as_tensor(_special_points(), device=cuda)
    got = fz.macro(P)
    want = fz.macro.plain(P)
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
    assert gpu.macro(torch.as_tensor(pts)).device.type == "cpu"
    assert gpu.macro.launches == 0
    got = gpu.unpack(gpu.block_tables(torch.as_tensor(pts, device=cuda)))
    assert (gpu.recurrence.launches, gpu.matmul.launches, gpu.macro.launches) == (1, 1, 1)
    for el, g in zip(zoo, got):
        want = el.tabulate(1, pts)
        for a in want:
            assert np.abs(g[a].cpu().numpy() - want[a]).max() <= 1e-10
