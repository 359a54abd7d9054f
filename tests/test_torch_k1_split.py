"""K1's row groups: several threads a point on the triangle and the
tetrahedron, each running the recurrence of one group of the point's
stage-1 rows (csrc/recurrence.cu, ops/recurrence.py ``deal_rows``).

On the CPU: the host's deal covers every stage-1 row once for every group
count the wrapper may pick, within the balance it promises, and a replay of
the kernel's loop run group by group, each group's values scattered to
their rows, is the plain version bit for bit.  On the card (marker
``cuda``, skipped without one): the kernel against its plain version under
every plan.  This file imports neither JAX nor fiat_tpu:
python -m pytest tests/test_torch_k1_split.py -m cuda -q --noconftest
"""

import math

import numpy as np
import pytest
import torch

from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.core.expansions import ExpansionSet
from fiat_tpu_torch.ops.recurrence import (GROUPED_ROWS, GROUPS, POINTS, THREADS,
                                           UNROLLED_DEGREE, DubinerRecurrence, deal_balance,
                                           deal_rows, launch_plan, pack_stages, plans,
                                           row_entries)

#: unrolled and generic degrees on each cell (UNROLLED_DEGREE: 15 / 10)
DEGREES = {2: (0, 1, 2, 10, 11, 15, 16, 20, 40), 3: (0, 1, 2, 8, 10, 11, 14, 20)}
CASES = [(sd, n) for sd in DEGREES for n in DEGREES[sd]]
RTOL = 1e-13


def _points(sd, n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.random((n, sd))
    return pts / (pts.sum(axis=1)[:, None] + 1e-9) * rng.random((n, 1))


def _recurrence(sd, degree, device):
    es = ExpansionSet(tcl.ufc_simplex(sd))
    return DubinerRecurrence(sd, degree, float(es.get_scale(degree)), es.affine_mappings[0],
                             device=device)


@pytest.mark.parametrize("sd,degree", CASES)
def test_deal_covers_every_row_once_within_its_balance(sd, degree):
    sizes = row_entries(sd, degree)
    assert sum(sizes) == math.comb(degree + sd, sd) == len(pack_stages(degree, sd=sd)[1])
    for groups in [g for g in GROUPS if g <= degree + 1]:
        owner = deal_rows(sd, degree, groups)
        assert owner.dtype == np.int32 and owner.shape == (degree + 1,)
        # one group a row, every group some rows
        assert sorted(set(owner.tolist())) == list(range(groups))
        shares = np.bincount(owner, weights=sizes, minlength=groups)
        assert shares.sum() == sum(sizes)
        assert shares.max() <= deal_balance(sd, degree, groups) + 1e-9
        # largest first: each group's share is at most the lightest one's
        # plus the smallest row the heavier got last
        assert shares.max() - shares.min() <= max(sizes)
    with pytest.raises(ValueError, match="row groups"):
        deal_rows(sd, degree, degree + 2)


#: blocks an SM of K1's instantiations on the H100 (ptxas' registers at 128
#: threads a block): (grouped, points a thread) -> blocks
H100_BLOCKS = {(False, 1): 10, (True, 1): 10, (False, 2): 10, (True, 2): 6}


@pytest.mark.parametrize("sd", [2, 3])
def test_launch_plan_takes_the_fewest_waves(sd):
    """Two points a thread wherever the count is even; one row group below
    GROUPED_ROWS rows of Phi; past them the groups with the fewest waves
    for a group's share of the rows, the fewest groups on a tie; always a
    plan the kernel takes."""
    for sms in (1, 132):
        def resident(grouped, points):
            return H100_BLOCKS[grouped, points] * sms
        for degree in range(0, 45 if sd == 2 else 25):
            for npts in (0, 1, 127, 1000, 20_001, 100_000, 100_003, 10_000_000):
                groups, points = plan = launch_plan(sd, degree, npts, resident)
                assert plan in plans(degree, npts), (degree, npts, plan)
                assert points == (2 if npts % 2 == 0 else 1)
                if math.comb(degree + sd, sd) < GROUPED_ROWS:
                    assert groups == 1
                    continue
                blocks = -(-npts // (points * THREADS))

                def waves(g):
                    return math.ceil(g * blocks / resident(g > 1, points)) / g
                best = min(waves(g) for g in GROUPS if g <= degree + 1)
                assert waves(groups) == best
                assert all(waves(g) > best for g in GROUPS if g < groups)
    assert len(plans(14, 7)) == len(GROUPS) and len(plans(14, 8)) == len(GROUPS) * len(POINTS)
    assert plans(1, 8) == [(1, 1), (1, 2), (2, 1), (2, 2)]


def test_launch_plan_at_the_main_paths_points():
    """At 1e5 points on 132 SMs: 782 blocks a group at two points a thread
    fill one wave of 6 blocks an SM with two groups (the tet's generic
    stage), of 9 with three (the triangle's)."""
    def resident(blocks):
        return lambda grouped, points: blocks * 132
    assert launch_plan(3, 20, 100_000, resident(6)) == (2, 2)
    assert launch_plan(2, 20, 100_000, resident(9)) == (3, 2)
    assert launch_plan(2, 8, 100_000, resident(9)) == (1, 2)        # 45 rows


def _replay(sd, n, consts, slots, keep, ref, scale, out):
    """The kernel's loop (dubiner2_point / dubiner3_point and their
    generic forms, which share its order and arithmetic) over the
    stage-1 rows ``keep`` takes, in torch over the points ``ref`` on the
    default simplex, each value stored to out[slots[e]]."""
    c = consts.reshape(-1, 4).tolist()
    if n == 0:
        out[0] = torch.full_like(ref[:, 0], scale)
        return

    def step(k, fa, fb, fc, prev, prev2):
        return (k[0] * fa - k[1] * fb) * prev - (k[2] * fc) * prev2

    x = [ref[:, i] for i in range(sd)] + [-1.0, -1.0]
    fac = []
    for k in range(sd):
        fb = 0.5 * (x[k + 1] + x[k + 2])
        fac.append((x[k] + fb + 1.0, fb, fb * fb))
    nexp2 = (n + 1) * (n + 2) // 2
    c1, c2 = n + 1, n + 1 + nexp2
    s_prev2, s_prev = 0.0, torch.full_like(ref[:, 0], scale)
    e1 = e = 0
    for r in range(n + 1):
        if r == 0:
            r0 = s_prev * c[0][3]
        else:
            v = step(c[r], *fac[0], s_prev, s_prev2)
            r0 = v * c[r][3]
            s_prev2, s_prev = s_prev, v
        if not keep(r):
            e1 += n - r + 1
            e += n - r + 1 if sd == 2 else (n - r + 1) * (n - r + 2) // 2
            continue
        prev2, prev = 0.0, r0
        for q in range(n - r + 1):
            if sd == 2:
                v = prev if q == 0 else step(c[c1 + e], *fac[1], prev, prev2)
                out[slots[e]] = v * c[c1 + e][3]
                if q > 0:
                    prev2, prev = prev, v
                e += 1
                continue
            v = prev
            if q > 0:
                v = step(c[c1 + e1], *fac[1], prev, prev2)
                prev2, prev = prev, v
            s2, s = 0.0, v * c[c1 + e1][3]
            out[slots[e]] = s * c[c2 + e][3]
            e += 1
            for _ in range(1, n - r - q + 1):
                w = step(c[c2 + e], *fac[2], s, s2)
                out[slots[e]] = w * c[c2 + e][3]
                s2, s = s, w
                e += 1
            e1 += 1


@pytest.mark.parametrize("sd,degree", [(2, 1), (2, 10), (2, 11), (2, 20), (3, 1), (3, 8),
                                       (3, 11), (3, 14)])
def test_groups_replayed_and_scattered_are_the_plain_version_bit_for_bit(sd, degree):
    rec = _recurrence(sd, degree, "cpu")
    P = torch.as_tensor(_points(sd, 40, degree))
    want = rec.plain(P)
    ref = P @ torch.as_tensor(rec.A).T + torch.as_tensor(rec.b)
    consts, slots = pack_stages(degree, sd=sd)
    for groups in [g for g in GROUPS if g <= degree + 1]:
        owner = deal_rows(sd, degree, groups)
        got = torch.full_like(want, float("nan"))
        for g in range(groups):
            _replay(sd, degree, consts, slots, lambda r, g=g: owner[r] == g, ref, rec.scale, got)
        assert torch.equal(got, want), (groups, (got - want).abs().max().item())


def test_wrapper_plans():
    """``plan`` None takes launch_plan's at each call's points, on the
    card's occupancy; a plan set on the wrapper is what it launches with;
    the owner table is deal_rows' on the engine's device, none for one
    group."""
    rec = _recurrence(3, 14, "cpu")
    rec._resident = {(g, v): 6 * 132 for g in (False, True) for v in POINTS}
    assert rec.plan is None and rec.plan_for(100_000) == (2, 2)
    assert rec.plan_for(100_001) == launch_plan(3, 14, 100_001, rec.resident_blocks)
    rec.plan = (4, 2)
    assert rec.plan_for(7) == (4, 2)
    assert rec.owner(1) is None
    owner = rec.owner(4)
    assert owner.device.type == "cpu" and owner.tolist() == deal_rows(3, 14, 4).tolist()
    assert rec.owner(4) is owner
    assert UNROLLED_DEGREE[2] == 15 and UNROLLED_DEGREE[3] == 10


class _Entry:
    """A stand-in for a C entry of the kernel library: records its
    arguments, checks them against the entry's ctypes signature."""

    def __init__(self, argtypes):
        self.argtypes, self.calls = argtypes, []

    def __call__(self, *args):
        assert len(args) == len(self.argtypes)
        for arg, kind in zip(args, self.argtypes):
            kind(arg)
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("sd", [1, 2, 3])
def test_wrapper_passes_its_plan_to_the_c_entry(sd):
    """The launch hands the C entry the points, the constants, the deal
    (null for one row group), the plan and the map in the entry's order
    (ops/kernels.py SIGNATURES); the interval's entry takes no plan."""
    from types import SimpleNamespace
    from fiat_tpu_torch.ops.kernels import SIGNATURES
    name = f"fiat_dubiner{sd}_values"
    lib = SimpleNamespace(**{name: _Entry(SIGNATURES[name])})
    rec = _recurrence(sd, 5, "cpu")
    P = torch.as_tensor(_points(sd, 10, 1))
    phi = torch.empty((rec.nexp, 10), dtype=torch.float64)
    for plan in ([None] if sd == 1 else [(1, 2), (3, 1)]):
        rec.plan = plan
        rec._launch(lib, P, phi, 7)
        args = getattr(lib, name).calls[-1]
        assert args[:4] == (P.data_ptr(), 10, rec.consts.data_ptr(), rec.slots.data_ptr())
        assert args[-4:] == (rec.scale, 5, phi.data_ptr(), 7)
        assert args[-4 - sd * (sd + 1):-4] == (*rec.A.ravel().tolist(), *rec.b.tolist())
        if sd > 1:
            groups, points = plan
            assert args[4:7] == ((0 if groups == 1 else rec.owner(groups).data_ptr()), groups,
                                 points)
    assert rec.launches == (1 if sd == 1 else 2)


# -- on the card --------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("npts", [1, 127, 100_003])
@pytest.mark.parametrize("sd,degree", [(2, 1), (2, 10), (2, 11), (2, 20), (3, 8), (3, 10),
                                       (3, 11), (3, 14)])
def test_kernel_matches_plain_under_every_plan(cuda, sd, degree, npts):
    rec = _recurrence(sd, degree, cuda)
    P = torch.as_tensor(_points(sd, npts, degree + npts), device=cuda)
    want = rec.plain(P)
    scale = want.abs().max().item()
    for plan in [None] + plans(degree, npts):
        rec.plan = plan
        rec.launches = 0
        got = rec(P)
        torch.cuda.synchronize()
        assert rec.launches == 1 and tuple(got.shape) == (rec.nexp, npts)
        err = (got - want).abs().max().item()
        assert err <= RTOL * scale, (plan, err, scale)


@pytest.mark.cuda
def test_kernel_refuses_a_plan_it_does_not_take(cuda):
    """Two points a thread at an odd point count, or a count other than 1
    or 2, never launch: the C entry returns cudaErrorInvalidValue and the
    wrapper raises; more groups than rows are refused by the deal."""
    rec = _recurrence(2, 4, cuda)
    P = torch.as_tensor(_points(2, 101, 1), device=cuda)
    for plan in ((1, 2), (1, 3), (2, 0)):
        rec.plan = plan
        with pytest.raises(RuntimeError, match="fiat_dubiner2_values"):
            rec(P)
    rec.plan = (6, 1)
    with pytest.raises(ValueError, match="row groups"):
        rec(P)
    rec.plan = None
    want = rec.plain(P)
    assert (rec(P) - want).abs().max().item() <= RTOL * want.abs().max().item()
