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
