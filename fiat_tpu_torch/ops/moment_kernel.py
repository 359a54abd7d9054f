"""K45: the plain and masked moments of a zoo in one CUDA launch, on
intervals, triangles and tetrahedra.

Counterpart of ``fiat_tpu/ops/pallas_recurrence.py`` ``PallasPairMoments``
(K4) and ``PallasMaskedPairMoments`` (K5).  The TPU kernels reach f64 sums
through df32 pairs, Ozaki windows and exact window reductions, and are two
kernels; Hopper has native FP64, so one kernel (``csrc/moments.cu``)
computes both in f64: per point the Dubiner recurrence and the subcell
masks of every macro program (``csrc/binning.cuh``, shared with K3 and
K7; program by program and 32 subcells a word, so a zoo and each of its
programs may have any number of subcells),
streamed a warp's 32 points at a time through a shared-memory slab into
sums each lane owns by member, reduced per block, and the blocks'
partials summed in groups by the last blocks to finish, in the same
launch (``csrc/moments.cu`` has the design).  Every degree: up to
``UNROLLED_DEGREE`` on instantiations with the recurrence unrolled and
its constants in the kernel's parameters, past them on one generic
instantiation per cell that takes the degree at the launch and its
constants from the device.

The plain version beside it is the eager recurrence times the weights plus
``subcell_masks`` x phi times the weights; the wrapper runs it for CPU
tensors only.  For a CUDA tensor it launches the kernel or raises.
"""

import ctypes
import math

import numpy as np
import torch

from ..core.expansions import dubiner_tabulate, subcell_masks
from .kernels import check_launch, load_kernels, resolve_device, stream_of
from .macro_oneshot import BINNING_TOL, pack_geometry
from .recurrence import pack_stages

#: the top of the unrolled instantiations per spatial dimension
#: (csrc/moments.cu, moments1.cu, moments3.cu); every degree past them runs
#: the generic one (csrc/moments.cuh)
UNROLLED_DEGREE = {1: 15, 2: 10, 3: 10}
#: warps a block the generic instantiation may take, most first: the
#: wrapper keeps the one with the most resident warps an SM (occupancy
#: query: registers and shared memory)
GENERIC_WARPS = (8, 4, 2, 1)

#: doubles of a warp's slab: 32 entries x 32 points, row stride 33
#: (csrc/moments.cuh SLAB)
SLAB = 32 * 33
#: shared memory a block may have, less the kernel's static tables (bytes)
BLOCK_SMEM = 232448 - 1024
#: blocks whose partials one block of the launch sums, before the last
#: sums those groups (csrc/moments.cuh GROUP)
GROUP = 16


def block_warps(sd, degree):
    """The most warps a block of the (sd, degree) instantiation takes
    (csrc/moments.cuh block_warps: the tetrahedron from degree 7 runs more,
    smaller blocks within its registers; the generic instantiation 8)."""
    return 4 if sd == 3 and 7 <= degree <= UNROLLED_DEGREE[3] else 8


def even_doubles(nbytes):
    """``nbytes`` of shared memory rounded up to an even count of doubles
    (csrc/moments.cuh even_doubles)."""
    return -(-nbytes // 16) * 2


def warp_doubles(piece_rows, npieces, nprogs, plain_rows=0):
    """Doubles of one warp's shared memory (csrc/moments.cuh warp_doubles):
    the slab, the tile's point mask of each piece (4 bytes) and 16-bit hit
    count of each point in each program (64 bytes a program), then one
    double per piece row and, in the generic instantiation, one per plain
    row (``plain_rows``: its plain sums)."""
    return (SLAB + even_doubles(4 * npieces + 64 * nprogs) + even_doubles(8 * piece_rows)
            + even_doubles(8 * plain_rows))


def block_smem(warps, piece_rows, npieces, nprogs, plain_rows=0):
    """Bytes of a block's shared memory (csrc/moments.cuh smem_bytes): the
    tables (first row, width and program of each piece, first and end
    piece and rule of each program: 12 bytes each), then ``warps`` warps'
    shares."""
    return 8 * (even_doubles(12 * (npieces + nprogs))
                + warps * warp_doubles(piece_rows, npieces, nprogs, plain_rows))


def grid_blocks(npts, warps, blocks_per_sm, sms):
    """K45's grid: a block for every ``warps`` tiles of 32 points, at most as
    many as the card holds at once (the blocks then loop over the tiles),
    and at least one (which writes zeros for no points)."""
    tiles = -(-npts // 32)
    return max(1, min(-(-tiles // warps), blocks_per_sm * sms))


class PairMoments:
    """``pm = PairMoments(degree, nplain, scale, affine_map, geom,
    parent_map, pieces, device)``; ``out = pm(points, wf)`` is the float64
    vector of every moment over ``points`` (npts, sd) with weights ``wf``
    (npts,), sd 1, 2 or 3 as ``affine_map`` says:

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

    A call on CUDA tensors is one launch, for any point count (none gives
    zeros), and two calls on the same inputs give the same bits.
    ``launches`` counts kernel launches (the plain CPU path adds nothing).
    """

    def __init__(self, degree, nplain, scale, affine_map, geom=(), parent_map=None, pieces=(),
                 device=None):
        Af, bf = affine_map
        self.sd = np.asarray(Af).shape[0]
        if self.sd not in UNROLLED_DEGREE:
            raise NotImplementedError(
                f"K45 covers intervals, triangles and tetrahedra (sd = 1, 2, 3), not "
                f"sd = {self.sd}")
        self.affine = np.concatenate([np.asarray(Af, np.float64).ravel(),
                                      np.asarray(bf, np.float64).ravel()])
        self.degree = int(degree)
        if self.degree < 0:
            raise ValueError(f"moments degree {degree} is negative")
        #: whether the degree runs the generic instantiation
        self.generic = self.degree > UNROLLED_DEGREE[self.sd]
        self.nexp = math.comb(self.degree + self.sd, self.sd)
        self.nplain = int(nplain)
        self.piece_nexp = [int(n) for _, n in pieces]
        if self.nplain > self.nexp or max(self.piece_nexp, default=0) > self.nexp:
            raise ValueError("a row reads more members than the recurrence makes")
        self.geom = list(geom)
        self.parent_map = parent_map
        self.rows = self.nplain + sum(self.piece_nexp)
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
        # the recurrence's constants go to the kernel in its parameters
        # (the unrolled instantiations) or through a device pointer (the
        # generic one)
        self.consts, slots = pack_stages(self.degree, sd=self.sd)
        self._consts_arg = (ctypes.c_double * len(self.consts))(*self.consts)
        self.dconsts = as_t(self.consts) if self.generic else None
        self._affine_arg = (ctypes.c_double * 12)(*self.affine)
        self.slots = as_t(slots, torch.int32)
        self.device = self.slots.device        # "cuda" resolved to its index
        # a warp's shared memory (its slab, piece masks, hit counts and
        # piece sums) and the warps a block takes beside the piece table:
        # degree 10 with 32 pieces of 286 needs 80 KB a warp, 2 a block; a
        # piece of n members costs 16 + 8 n bytes of one warp's share and 12
        # of the table, so one warp stops fitting at about 5,500 pieces of 3
        # members (csrc/moments.cu), where this raises naming shared memory
        self.piece_rows = self.rows - self.nplain
        self.nprogs = len(self.geom)
        #: plain rows whose sums sit in shared memory (the generic instantiation)
        self.plain_smem_rows = self.nplain if self.generic else 0
        self.warp_smem = 8 * warp_doubles(self.piece_rows, len(self.piece_nexp), self.nprogs,
                                          self.plain_smem_rows)
        table = block_smem(0, 0, len(self.piece_nexp), self.nprogs)
        self.warps = min(block_warps(self.sd, self.degree),
                         (BLOCK_SMEM - table) // self.warp_smem)
        if self.warps < 1:
            raise NotImplementedError(
                f"K45: one warp's {self.warp_smem} bytes of shared memory ({self.piece_rows} "
                f"piece rows, {self.plain_smem_rows} plain rows) are past a block's "
                f"{BLOCK_SMEM - table}")
        self._blocks_per_sm = self._sms = None
        self._tickets = {}
        self.launches = 0

    @property
    def smem(self):
        """Bytes of shared memory of one block."""
        return block_smem(self.warps, self.piece_rows, len(self.piece_nexp), self.nprogs,
                          self.plain_smem_rows)

    def occupancy(self, warps):
        """Blocks of ``warps`` warps an SM of the card holds at once for
        this launch (registers and shared memory both counted, by the CUDA
        runtime), or minus the CUDA error.  Needs the card."""
        return load_kernels().fiat_pair_moments_occupancy(
            self.sd, self.degree, warps, self.piece_rows, len(self.piece_nexp), self.nprogs,
            self.plain_smem_rows)

    @property
    def blocks_per_sm(self):
        """The blocks an SM of the card holds at once (registers and shared
        memory both counted, by the CUDA runtime); the grid is sized to it.
        The generic instantiation first takes, of GENERIC_WARPS that fit
        shared memory, the warps a block that keep the most warps resident
        (fewer on ties: more blocks).  Needs the card."""
        if self._blocks_per_sm is None:
            if self.generic:
                fits = [w for w in GENERIC_WARPS if w <= self.warps]
                self.warps = max(fits, key=lambda w: (w * max(0, self.occupancy(w)), -w))
            n = self.occupancy(self.warps)
            if n <= 0:
                raise RuntimeError(f"K45 (degree {self.degree}, sd {self.sd}, {self.warps} "
                                   f"warps, {self.smem} bytes): no block fits an SM ({n})")
            self._blocks_per_sm = n
        return self._blocks_per_sm

    @property
    def resident_warps(self):
        """Warps resident an SM while K45 runs (needs the card)."""
        return self.blocks_per_sm * self.warps

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
        if self._sms is None:
            self._sms = torch.cuda.get_device_properties(self.device).multi_processor_count
        bps = self.blocks_per_sm      # (fixes the generic instantiation's warps first)
        nblocks = grid_blocks(npts, self.warps, bps, self._sms)
        out = torch.empty(self.rows, dtype=torch.float64, device=points.device)
        partials = torch.empty((nblocks + -(-nblocks // GROUP), self.rows), dtype=torch.float64,
                               device=points.device)
        stream = stream_of(points)
        tickets = self._tickets.get(stream)
        if tickets is None:     # one set per stream: a launch finds them 0 and leaves them 0
            most = -(-(bps * self._sms) // GROUP)
            tickets = self._tickets[stream] = torch.zeros(1 + most, dtype=torch.int32,
                                                          device=points.device)
        err = load_kernels().fiat_pair_moments(
            points.data_ptr(), wf.data_ptr(), npts, self.sd, self._consts_arg,
            None if self.dconsts is None else self.dconsts.data_ptr(),
            self.slots.data_ptr(), self._affine_arg, self.scale, BINNING_TOL[torch.float64],
            self.degree, self.nplain, self.maps.data_ptr(), len(self.piece_nexp),
            self.progs.data_ptr(), self.nprogs, self.pieces.data_ptr(), self.rows, self.warps,
            nblocks, partials.data_ptr(), tickets.data_ptr(), out.data_ptr(), stream)
        check_launch(f"fiat_pair_moments ({self.rows} rows, degree {self.degree}, sd {self.sd})",
                     err)
        self.launches += 1
        return out

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
