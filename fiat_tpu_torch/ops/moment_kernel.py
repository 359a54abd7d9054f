"""K45: the plain and masked moments of a zoo in one CUDA launch, on
triangles and tetrahedra.

Counterpart of ``fiat_tpu/ops/pallas_recurrence.py`` ``PallasPairMoments``
(K4) and ``PallasMaskedPairMoments`` (K5).  The TPU kernels reach f64 sums
through df32 pairs, Ozaki windows and exact window reductions, and are two
kernels; Hopper has native FP64, so one kernel (``csrc/moments.cu``)
computes both in f64: per point the Dubiner recurrence, the subcell masks
of every macro program (``csrc/binning.cuh``, shared with K3 and K7), and
the weighted sums of both, reduced per block; the wrapper sums the
per-block partials.

The plain version beside it is the eager recurrence times the weights plus
``subcell_masks`` x phi times the weights; the wrapper runs it for CPU
tensors only.  For a CUDA tensor it launches the kernel or raises.
"""

import math

import numpy as np
import torch

from ..core.expansions import dubiner_tabulate, subcell_masks
from .kernels import check_launch, load_kernels, resolve_device, stream_of
from .macro_oneshot import BINNING_TOL, MAX_PIECES, pack_geometry
from .recurrence import pack_stages

#: highest degree the kernel is instantiated for (csrc/moments.cu), on the
#: triangle and on the tetrahedron
MAX_DEGREE = 10
#: threads per block (csrc/moments.cu THREADS) and at most how many resident
#: blocks per SM the grid is sized for (the kernel loops over the points;
#: every lane keeps a double per output row in shared memory, 67.6 KB a
#: block on full_zoo, so three fit an SM)
THREADS = 64
BLOCKS_PER_SM = 3
#: shared memory of one SM and of one block, and what the card reserves
#: for each resident block (bytes)
SM_SMEM = 233472
BLOCK_SMEM = 232448
BLOCK_RESERVED = 1024
#: output rows whose per-lane accumulators fit one block's shared memory
MAX_ROWS = BLOCK_SMEM // (THREADS * 8)


class PairMoments:
    """``pm = PairMoments(degree, nplain, scale, affine_map, geom,
    parent_map, pieces, device)``; ``out = pm(points, wf)`` is the float64
    vector of every moment over ``points`` (npts, sd) with weights ``wf``
    (npts,), sd 2 or 3 as ``affine_map`` says:

      * ``out[:nplain]``: pw[k] = sum_q phi_k(x_q) wf_q, the degree-``degree``
        Dubiner basis (scale ``scale``, cell map ``affine_map``);
      * then per subcell ("piece") c of every macro program, in program and
        subcell order, ``pieces[c][1]`` values
        bw[c, k] = sum_q mask_c(x_q) recip(x_q) phi_k(x_q) wf_q, with the
        masks and averaging reciprocal of K3's binning (``geom``: per
        program {"maps", "unique", "rows"}; ``parent_map``: the parent's
        rescaled barycentric map).  The parent basis is the leading members
        of the same recurrence; the caller checks that it is (same cell,
        same scale).

    ``launches`` counts kernel launches (the plain CPU path adds nothing).
    """

    def __init__(self, degree, nplain, scale, affine_map, geom=(), parent_map=None, pieces=(),
                 device=None):
        Af, bf = affine_map
        self.sd = np.asarray(Af).shape[0]
        if self.sd not in (2, 3):
            raise NotImplementedError(
                f"K45 covers triangles and tetrahedra (sd = 2, 3), not sd = {self.sd}")
        self.affine = np.concatenate([np.asarray(Af, np.float64).ravel(),
                                      np.asarray(bf, np.float64).ravel()])
        self.degree = int(degree)
        if not 0 <= self.degree <= MAX_DEGREE:
            raise NotImplementedError(f"moments degree {degree} outside 0..{MAX_DEGREE}")
        self.nexp = math.comb(self.degree + self.sd, self.sd)
        self.nplain = int(nplain)
        self.piece_nexp = [int(n) for _, n in pieces]
        if len(self.piece_nexp) > MAX_PIECES:
            raise NotImplementedError(
                f"{len(self.piece_nexp)} subcells: K45 takes at most {MAX_PIECES}")
        if self.nplain > self.nexp or max(self.piece_nexp, default=0) > self.nexp:
            raise ValueError("a row reads more members than the recurrence makes")
        self.geom = list(geom)
        self.parent_map = parent_map
        self.rows = self.nplain + sum(self.piece_nexp)
        if self.rows > MAX_ROWS:
            raise NotImplementedError(f"{self.rows} moment rows: K45 keeps at most {MAX_ROWS}")
        self.scale = float(scale)
        self.device = resolve_device(device)

        def as_t(a, dtype=torch.float64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=self.device)

        if self.geom:
            maps, progs, pieces_t = pack_geometry(self.geom, parent_map, self.piece_nexp)
        else:
            maps = np.zeros((1, self.sd + 1, self.sd + 1))
            progs, pieces_t = np.zeros((0, 5)), np.zeros((0, 2))
        self.maps = as_t(maps)
        self.progs = as_t(progs, torch.int32)
        self.pieces = as_t(pieces_t, torch.int32)
        consts, slots = pack_stages(self.degree, sd=self.sd)
        self.consts = as_t(consts)
        self.slots = as_t(slots, torch.int32)      # read by the sd = 3 stage only
        self.device = self.consts.device       # "cuda" resolved to its index
        # accumulators of one block, and the blocks an SM holds at once
        self.smem = THREADS * 8 * self.rows
        self.blocks_per_sm = max(1, min(BLOCKS_PER_SM,
                                        SM_SMEM // (self.smem + BLOCK_RESERVED)))
        self.launches = 0

    def _check(self, points, wf):
        for name, t in (("points", points), ("wf", wf)):
            if not isinstance(t, torch.Tensor):
                raise TypeError(f"{name} must be a torch.Tensor")
            if t.dtype != torch.float64:
                raise TypeError(f"{name} must be float64, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if points.dim() != 2 or points.shape[1] != self.sd:
            raise ValueError(f"points must have shape (npts, {self.sd}), got "
                             f"{tuple(points.shape)}")
        if tuple(wf.shape) != (points.shape[0],):
            raise ValueError(f"wf must have shape ({points.shape[0]},), got {tuple(wf.shape)}")
        if wf.device != points.device:
            raise ValueError(f"wf on {wf.device}, points on {points.device}")
        if points.shape[0] >= 2 ** 31:
            raise ValueError("too many points for one launch")

    def __call__(self, points, wf):
        self._check(points, wf)
        if points.device.type == "cpu":
            return self.plain(points, wf)
        if points.device.type != "cuda" or points.device != self.device:
            raise ValueError(f"points on {points.device}, engine on {self.device}")
        npts = points.shape[0]
        if npts == 0:
            return torch.zeros(self.rows, dtype=torch.float64, device=points.device)
        sms = torch.cuda.get_device_properties(points.device).multi_processor_count
        nblocks = min(-(-npts // THREADS), self.blocks_per_sm * sms)
        partials = torch.empty((nblocks, self.rows), dtype=torch.float64, device=points.device)
        lib = load_kernels()
        if self.sd == 2:
            name, fn, tables = "fiat_pair_moments", lib.fiat_pair_moments, ()
        else:
            name, fn, tables = "fiat_pair_moments3", lib.fiat_pair_moments3, (self.slots.data_ptr(),)
        err = fn(
            points.data_ptr(), wf.data_ptr(), npts, self.consts.data_ptr(), *tables,
            *self.affine.tolist(), self.scale, BINNING_TOL[torch.float64], self.degree,
            self.nplain, self.maps.data_ptr(), len(self.piece_nexp), self.progs.data_ptr(),
            len(self.geom), self.pieces.data_ptr(), self.rows, partials.data_ptr(), nblocks,
            stream_of(points))
        check_launch(f"{name} ({self.rows} rows, degree {self.degree})", err)
        self.launches += 1
        return partials.sum(dim=0)

    def plain(self, points, wf):
        """The same moments in plain PyTorch, on the points' device."""
        return self.stack(points) @ wf

    def stack(self, points):
        """The (rows, npts) float64 matrix whose product with wf is every
        moment: Phi's plain rows, then each piece's masked rows."""
        sd = self.sd
        Af = points.new_tensor(self.affine[:sd * sd].reshape(sd, sd))
        ref = points @ Af.T + points.new_tensor(self.affine[sd * sd:])
        phi = dubiner_tabulate(sd, self.degree, [ref[:, i] for i in range(sd)], self.scale)
        parts = [phi[:self.nplain]]
        nexp = iter(self.piece_nexp)
        for g in self.geom:
            for m in subcell_masks(points, self.parent_map, g["maps"], unique=g["unique"]):
                parts.append(m * phi[:next(nexp)])
        return torch.cat(parts)
