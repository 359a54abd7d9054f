"""K1: the Dubiner value recurrence as a hand-written CUDA kernel, on
intervals, triangles and tetrahedra.

Counterpart of ``fiat_tpu/ops/pallas_recurrence.py``
(``PallasSliceRecurrence``).  The TPU kernel emits the expansion
tabulation as Ozaki bf16/int8 windows of a df32 recurrence, because the
TPU has no f64; the CUDA kernel (``csrc/recurrence.cu``) computes the
f64 tabulation Phi (nexp, npts) itself, at every degree: the degrees up
to ``UNROLLED_DEGREE`` on instantiations with the recurrence unrolled,
every degree past them on one generic kernel per cell that takes the
degree at the launch.  See the kernel source for what bounds it on the
card and how its design meets that.

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
    ``UNROLLED_DEGREE``).
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
        self.launches = 0

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
        npts = points.shape[0]
        phi = torch.empty((self.nexp, npts), dtype=torch.float64, device=points.device)
        if npts == 0:
            return phi
        lib = load_kernels()
        name = f"fiat_dubiner{self.sd}_values"
        err = getattr(lib, name)(
            points.data_ptr(), npts, self.consts.data_ptr(), self.slots.data_ptr(),
            *self.A.ravel().tolist(), *self.b.tolist(), self.scale, self.degree,
            phi.data_ptr(), stream_of(points))
        check_launch(name, err)
        self.launches += 1
        return phi

    def plain(self, points):
        """The same tabulation in plain PyTorch, on the points' device."""
        A = torch.as_tensor(self.A, device=points.device)
        b = torch.as_tensor(self.b, device=points.device)
        ref = points @ A.T + b
        return dubiner_tabulate(self.sd, self.degree, [ref[:, i] for i in range(self.sd)],
                                self.scale)
