"""K1: the Dubiner value recurrence as a hand-written CUDA kernel, on
intervals, triangles and tetrahedra.

Counterpart of ``fiat_tpu/ops/pallas_recurrence.py``
(``PallasSliceRecurrence``).  The TPU kernel emits the expansion
tabulation as Ozaki bf16/int8 windows of a df32 recurrence, because the
TPU has no f64; the CUDA kernel (``csrc/recurrence.cu``) computes the
f64 tabulation Phi (nexp, npts) itself, at every degree: the degrees up
to ``UNROLLED_DEGREE`` on instantiations with the recurrence unrolled,
every degree past them on one generic kernel per cell that takes the
degree at the launch.  On the triangle and the tetrahedron several
threads share a point, each running the recurrence of one group of its
stage-1 rows (``deal_rows``), and a thread may take two neighbouring
points (``launch_plan`` picks both).  See the kernel source for what
bounds it on the card and how its design meets that.

The plain version beside it is the torch path of
``core.expansions.dubiner_tabulate``; the wrapper runs it for CPU tensors
only.  For a CUDA tensor it launches the kernel or raises.
"""

import math

import numpy as np
import torch

from ..core.expansions import _stage_constants, dubiner_tabulate
from .kernels import check_launch, load_kernels, resolve_device, stream_of

#: the top of the unrolled instantiations, per spatial dimension
#: (csrc/recurrence.cu): nexp 16 on the interval, 136 on the triangle, 286
#: on the tetrahedron; every degree past them runs the generic kernel
UNROLLED_DEGREE = {1: 15, 2: 15, 3: 10}

#: the row groups (threads a point) and the points a thread the triangle's
#: and the tetrahedron's kernels take (csrc/recurrence.cu; two points a
#: thread only for an even point count), as ``chip_smoke.py --k1-cells``
#: sweeps them, and the threads a block of every K1 kernel
GROUPS = (1, 2, 3, 4, 6, 8)
POINTS = (1, 2)
THREADS = 128
#: Phi rows below which the launch is one row group: Phi is then a store of
#: a few microseconds, launch-bound (the H100 sweep: triangle 8 and tet 4,
#: at 45 and 35 rows, are fastest on one, triangle 10 at 66 on two)
GROUPED_ROWS = 64


def pack_stages(degree, variant=None, sd=2):
    """Host-packed constants of the Dubiner recurrence for the kernels:
    (consts f64, slots int32) in the layout ``csrc/dubiner1.cuh`` (sd = 1),
    ``csrc/dubiner2.cuh`` (sd = 2) or ``csrc/dubiner3.cuh`` (sd = 3)
    documents.  Stage 0 runs on one row (its output is the identity
    permutation of its levels; on the interval it is the only stage, and
    ``slots`` the identity); every later
    stage's entries are (input row, level) pairs, input rows in the order
    of their multi-indices (p, then q), levels innermost, each with the
    (a, b, c) of its level and the norm of its output row.  ``slots`` gives
    the last stage's entries their morton output rows.  The expansion
    variants ("bubble", "dual") keep the stage structure and the morton
    rows; their recurrence coefficients and norms differ."""
    if sd not in UNROLLED_DEGREE:
        raise NotImplementedError(f"the recurrence kernels cover sd = 1, 2 and 3, not sd = {sd}")
    n = degree
    if n == 0:
        return np.zeros(4), np.zeros(1, np.int32)
    a1, b1, general, perm, norms = _stage_constants(sd, n, 0, variant)
    if not np.array_equal(perm, np.arange(n + 1)):
        raise AssertionError("stage-0 output is expected in level order")
    consts = [(*_level_coeffs(a1, b1, general, i, 0), norms[i, 0]) for i in range(n + 1)]
    if sd == 1:
        return np.asarray(consts, np.float64).ravel(), np.arange(n + 1, dtype=np.int32)

    # stage 1: input row p (stage 0's level p), level q
    a1, b1, general, perm, norms = _stage_constants(sd, n, 1, variant)
    slot1 = {int(v): j for j, v in enumerate(perm)}     # q * (n + 1) + p -> output rank
    slots = []
    for p in range(n + 1):
        for q in range(n + 1 - p):
            j = slot1[q * (n + 1) + p]
            consts.append((*_level_coeffs(a1, b1, general, q, p), norms[j, 0]))
            slots.append(j)
    if sd == 3:
        # stage 2: input row (p, q) (stage 1's output rank), level r
        m_in = len(perm)
        a1, b1, general, perm, norms = _stage_constants(sd, n, 2, variant)
        slot2 = {int(v): j for j, v in enumerate(perm)}     # r * m_in + row -> output rank
        slots = []
        for p in range(n + 1):
            for q in range(n + 1 - p):
                row = slot1[q * (n + 1) + p]
                for r in range(n + 1 - p - q):
                    j = slot2[r * m_in + row]
                    consts.append((*_level_coeffs(a1, b1, general, r, row), norms[j, 0]))
                    slots.append(j)
    if sorted(slots) != list(range(len(perm))):
        raise AssertionError("the last stage's entries must cover every member once")
    return np.asarray(consts, np.float64).ravel(), np.asarray(slots, np.int32)


def row_entries(sd, degree):
    """The last-stage entries of each stage-1 row: on the triangle row r
    holds degree - r + 1, on the tetrahedron row p a triangle of
    (degree - p + 1)(degree - p + 2) / 2 (``pack_stages``' order)."""
    if sd == 2:
        return [degree - r + 1 for r in range(degree + 1)]
    if sd == 3:
        return [(degree - p + 1) * (degree - p + 2) // 2 for p in range(degree + 1)]
    raise NotImplementedError(f"the row groups cover sd = 2 and 3, not sd = {sd}")


def deal_rows(sd, degree, groups):
    """owner[r], the row group of each stage-1 row (int32, degree + 1), for
    ``groups`` threads a point: the rows dealt by entries, largest first,
    each to the group with the fewest entries so far (the lowest group on a
    tie).  Every group gets a row; the largest share is within
    ``deal_balance`` (greedy largest-first: at most 4/3 of the best
    possible deal's largest share)."""
    sizes = row_entries(sd, degree)
    if not 1 <= groups <= len(sizes):
        raise ValueError(f"{groups} row groups for {len(sizes)} stage-1 rows")
    load = [0] * groups
    owner = np.zeros(len(sizes), np.int32)
    for r in sorted(range(len(sizes)), key=lambda r: (-sizes[r], r)):
        g = min(range(groups), key=lambda g: (load[g], g))
        owner[r] = g
        load[g] += sizes[r]
    return owner


def deal_balance(sd, degree, groups):
    """The largest share of entries ``deal_rows`` promises: 4/3 of the
    lower bound on any deal's, the larger of the largest row and the
    entries over the groups (Graham's bound on largest-first)."""
    sizes = row_entries(sd, degree)
    return 4 / 3 * max(max(sizes), sum(sizes) / groups)


def launch_plan(sd, degree, npts, resident):
    """(row groups, points a thread) for K1 on the triangle or the
    tetrahedron at ``npts`` points; ``resident(grouped, points)`` is the
    blocks the card holds at once of that instantiation.  Two points a
    thread at an even point count.  Past GROUPED_ROWS rows of Phi, the row
    groups whose launch takes the fewest waves for its share of the rows:
    R groups take ceil(R b / resident) waves of blocks each 1/R of the rows
    (b the blocks a group), so one more group pays where it still fits the
    waves it fills; the fewest groups on a tie.  On the H100 this is the
    sweep's best at 1e5 points or within 3% of it (``chip_smoke.py
    --k1-cells``)."""
    points = 2 if npts % 2 == 0 else 1
    if math.comb(degree + sd, sd) < GROUPED_ROWS:
        return 1, points
    blocks = -(-npts // (points * THREADS))

    def waves(groups):
        return math.ceil(groups * blocks / resident(groups > 1, points)) / groups

    return min((g for g in GROUPS if g <= degree + 1), key=lambda g: (waves(g), g)), points


def plans(degree, npts):
    """Every (row groups, points a thread) the kernel takes at ``degree``
    and ``npts`` points."""
    return [(g, v) for g in GROUPS if g <= degree + 1 for v in POINTS if npts % v == 0]


def _level_coeffs(a1, b1, general, i, r):
    """(a, b, c) of level i, input row r (zeros where a term is absent)."""
    if i == 0:
        return 0.0, 0.0, 0.0
    if i == 1:
        return a1[r, 0], b1[r, 0], 0.0
    a, b, c = general[i]
    return a[r, 0], b[r, 0], c[r, 0]


class DubinerRecurrence:
    """``rec = DubinerRecurrence(sd, degree, scale, (A, b), device)``;
    ``phi = rec(points)`` is the (nexp, npts) float64 tabulation of the
    plain orthonormal Dubiner basis at ``points`` (npts, sd), float64,
    contiguous, mapped onto the default simplex by ``ref = A @ x + b``;
    sd is 1 (interval: the Legendre basis), 2 (triangle) or 3
    (tetrahedron).

    ``launches`` counts kernel launches (the plain CPU path adds nothing);
    ``generic`` says whether the degree runs the generic kernel (past
    ``UNROLLED_DEGREE``); ``plan`` is the (row groups, points a thread) to
    launch with on the triangle or the tetrahedron, None for
    ``launch_plan``'s at each call's points.
    """

    def __init__(self, sd, degree, scale, affine_map, device=None):
        if sd not in UNROLLED_DEGREE:
            raise NotImplementedError(
                f"The CUDA recurrence covers intervals, triangles and tetrahedra (sd = 1, 2, 3), "
                f"not sd={sd}")
        if degree < 0:
            raise ValueError(f"degree {degree} is negative")
        self.sd = sd
        self.degree = degree
        self.generic = degree > UNROLLED_DEGREE[sd]
        self.scale = float(scale)
        self.nexp = math.comb(degree + sd, sd)
        A, b = affine_map
        self.A = np.asarray(A, np.float64).reshape(sd, sd)
        self.b = np.asarray(b, np.float64).reshape(sd)
        self.device = resolve_device(device)
        consts, slots = pack_stages(degree, sd=sd)
        self.consts = torch.as_tensor(consts, device=self.device)
        self.slots = torch.as_tensor(slots, device=self.device)
        self.plan = None
        self._owners = {}
        self._resident = {}
        self.launches = 0

    def plan_for(self, npts):
        """(row groups, points a thread) of a launch at ``npts`` points."""
        return self.plan or launch_plan(self.sd, self.degree, npts, self.resident_blocks)

    def resident_blocks(self, grouped, points):
        """The blocks the card holds at once of the kernel instantiation a
        launch takes (``grouped``: more than one row group)."""
        key = (bool(grouped), points)
        if key not in self._resident:
            blocks = load_kernels().fiat_dubiner_occupancy(self.sd, self.degree, int(grouped),
                                                           points)
            check_launch("fiat_dubiner_occupancy", min(blocks, 0))
            if blocks == 0:
                raise RuntimeError(f"K1 at degree {self.degree}, sd {self.sd}: no block fits "
                                   "an SM")
            sms = torch.cuda.get_device_properties(self.device).multi_processor_count
            self._resident[key] = blocks * sms
        return self._resident[key]

    def owner(self, groups):
        """``deal_rows``' table for ``groups`` on the engine's device (None
        for one group: the kernel takes every row)."""
        if groups == 1:
            return None
        if groups not in self._owners:
            self._owners[groups] = torch.as_tensor(deal_rows(self.sd, self.degree, groups),
                                                   device=self.device)
        return self._owners[groups]

    def _check(self, points):
        if not isinstance(points, torch.Tensor):
            raise TypeError("points must be a torch.Tensor")
        if points.dtype != torch.float64:
            raise TypeError(f"points must be float64, got {points.dtype}")
        if points.dim() != 2 or points.shape[1] != self.sd:
            raise ValueError(f"points must have shape (npts, {self.sd}), got {tuple(points.shape)}")
        if not points.is_contiguous():
            raise ValueError("points must be contiguous")
        if points.shape[0] >= 2 ** 31:
            raise ValueError("too many points for one launch")

    def __call__(self, points):
        self._check(points)
        if points.device.type == "cpu":
            return self.plain(points)
        if points.device.type != "cuda" or points.device != self.consts.device:
            raise ValueError(f"points on {points.device}, engine on {self.consts.device}")
        phi = torch.empty((self.nexp, points.shape[0]), dtype=torch.float64,
                          device=points.device)
        if points.shape[0]:
            self._launch(load_kernels(), points, phi, stream_of(points))
        return phi

    def _launch(self, lib, points, phi, stream):
        """One launch of the C entry of ``lib`` writing ``phi``."""
        npts = points.shape[0]
        name = f"fiat_dubiner{self.sd}_values"
        shape = ()
        if self.sd > 1:
            groups, per_thread = self.plan_for(npts)
            owner = self.owner(groups)
            shape = (0 if owner is None else owner.data_ptr(), groups, per_thread)
        err = getattr(lib, name)(
            points.data_ptr(), npts, self.consts.data_ptr(), self.slots.data_ptr(), *shape,
            *self.A.ravel().tolist(), *self.b.tolist(), self.scale, self.degree,
            phi.data_ptr(), stream)
        check_launch(name, err)
        self.launches += 1

    def plain(self, points):
        """The same tabulation in plain PyTorch, on the points' device."""
        A = torch.as_tensor(self.A, device=points.device)
        b = torch.as_tensor(self.b, device=points.device)
        ref = points @ A.T + b
        return dubiner_tabulate(self.sd, self.degree, [ref[:, i] for i in range(self.sd)],
                                self.scale)
