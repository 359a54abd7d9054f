"""K1: the Dubiner value recurrence as a hand-written CUDA kernel.

Counterpart of ``fiat_tpu/ops/pallas_recurrence.py``
(``PallasSliceRecurrence``).  The TPU kernel emits the expansion
tabulation as Ozaki bf16/int8 windows of a df32 recurrence, because the
TPU has no f64; the CUDA kernel (``csrc/recurrence.cu``) computes the
f64 tabulation Phi (nexp, npts) itself.  See the kernel source for what
bounds it on the card and how its design meets that.

The plain version beside it is the torch path of
``core.expansions.dubiner_tabulate``; the wrapper runs it for CPU tensors
only.  For a CUDA tensor it launches the kernel or raises.
"""

import numpy as np
import torch

from ..core.expansions import _stage_constants, dubiner_tabulate
from .kernels import check_launch, load_kernels, stream_of

#: highest degree the kernel is instantiated for (csrc/recurrence.cu); the
#: kernel engine cannot pass it anyway, since K2's shared-memory tile caps the
#: contraction width at 149 (degree 15: 136, degree 16: 153)
MAX_DEGREE = 15


def pack_stages(degree, variant=None):
    """Host-packed constants of the triangle recurrence for the kernels:
    (consts f64, slots int32) in the layout ``csrc/dubiner2.cuh``
    documents.  Stage 0 runs on one row (its output is the identity
    permutation of its levels); stage-1 entries are (input row r, level i)
    with r + i <= degree, row-major, each with its morton output row.  The
    expansion variants ("bubble", "dual") keep the stage structure and the
    morton rows; their recurrence coefficients and norms differ."""
    n = degree
    consts = []
    if n == 0:
        return np.zeros(4), np.zeros(1, np.int32)
    a1, b1, general, perm, norms = _stage_constants(2, n, 0, variant)
    if not np.array_equal(perm, np.arange(n + 1)):
        raise AssertionError("stage-0 output is expected in level order")
    for i in range(n + 1):
        a, b, c = _level_coeffs(a1, b1, general, i, 0)
        consts.append((a, b, c, norms[i, 0]))

    a1, b1, general, perm, norms = _stage_constants(2, n, 1, variant)
    m_in = n + 1
    slot_of = {int(p): j for j, p in enumerate(perm)}
    slots = []
    for r in range(n + 1):
        for i in range(n + 1 - r):
            j = slot_of[i * m_in + r]
            a, b, c = _level_coeffs(a1, b1, general, i, r)
            consts.append((a, b, c, norms[j, 0]))
            slots.append(j)
    if sorted(slots) != list(range(len(perm))):
        raise AssertionError("stage-1 entries must cover every member once")
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
    """``rec = DubinerRecurrence(2, degree, scale, (A, b), device)``;
    ``phi = rec(points)`` is the (nexp, npts) float64 tabulation of the
    plain orthonormal Dubiner basis at ``points`` (npts, 2), float64,
    contiguous, mapped onto the default triangle by ``ref = A @ x + b``.

    ``launches`` counts kernel launches (the plain CPU path adds nothing).
    """

    def __init__(self, sd, degree, scale, affine_map, device=None):
        if sd != 2:
            raise NotImplementedError(
                f"The CUDA recurrence covers triangles (sd=2), not sd={sd}; "
                "tetrahedra are queued in ROADMAP.md")
        if not 0 <= degree <= MAX_DEGREE:
            raise NotImplementedError(f"degree {degree} outside 0..{MAX_DEGREE}")
        self.sd = sd
        self.degree = degree
        self.scale = float(scale)
        self.nexp = (degree + 1) * (degree + 2) // 2
        A, b = affine_map
        self.A = np.asarray(A, np.float64).reshape(sd, sd)
        self.b = np.asarray(b, np.float64).reshape(sd)
        self.device = torch.device("cpu" if device is None else device)
        consts, slots = pack_stages(degree)
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
        err = lib.fiat_dubiner2_values(
            points.data_ptr(), npts, self.consts.data_ptr(), self.slots.data_ptr(),
            *self.A.ravel().tolist(), *self.b.tolist(), self.scale, self.degree,
            phi.data_ptr(), stream_of(points))
        check_launch("fiat_dubiner2_values", err)
        self.launches += 1
        return phi

    def plain(self, points):
        """The same tabulation in plain PyTorch, on the points' device."""
        A = torch.as_tensor(self.A, device=points.device)
        b = torch.as_tensor(self.b, device=points.device)
        ref = points @ A.T + b
        return dubiner_tabulate(self.sd, self.degree, [ref[:, i] for i in range(self.sd)],
                                self.scale)
