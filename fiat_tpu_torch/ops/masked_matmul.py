"""K7: the macro (split-complex) elements of a zoo as one masked change of
basis over the zoo's shared Dubiner basis, in one CUDA launch.

Counterpart of ``fiat_tpu/ops/pallas_multiword.py``
(``FusedMaskedMultiword.apply_pair_masked``) together with its two XLA
neighbours in ``FusedZooTabulator._specials_merged``: the binning masks of
``partition_of_unity_masks`` before it and the 1 / cover-count multiply after
it.  The merged change of basis ``A`` (rows, sum_c nexp_c) multiplies B,
whose rows for subcell ("piece") c are ``mask_c * Phi[:nexp_c]``, with Phi
the (nexp, npts) f64 tabulation K1 made for K2, read by prefix.  The kernel
(``csrc/masked_matmul.cu``) bins each point itself, once per program, and
multiplies only the pieces it bins into (the others add exact zeros), with
each warp's points dealt to its lanes in subcell order, the block's Phi
prefix staged in shared memory and A streamed through a ring of
bulk-copied slices of its row chunks (``macro_oneshot.chunk_table`` and
``slice_table``, K3's layout; the plan sizes both,
``MaskedMatmul.plan_for``); the TPU kernel's df32
pairs, Ozaki windows, one-hot G/E assembly dots and int8 selects are TPU
workarounds and are not ported.

The plain version beside it is ``subcell_masks`` -> ``cat(m * Phi[:nexp_c])``
-> ``A @ B`` -> times 1 / cover count.  The wrapper runs it for CPU tensors
only; for a CUDA tensor it launches the kernel or raises.
"""

import numpy as np
import torch

from ..core.expansions import subcell_masks
from .kernels import check_launch, load_kernels, resolve_device, stream_of
from .macro_oneshot import (BINNING_TOL, CHUNK_ROWS, COLUMN_STRIDE, chunk_table, gather_slices,
                            mask_words, pack_geometry, slice_table)


def same_bins(maps, progs):
    """Per program, whether it bins a point as the program before it does:
    the same subcell maps in the same order and the same rule (unique or
    averaged), as an Alfeld P3 / DG2 pair at order 1."""
    out = [False]
    for (_, _, a0, a1, ua), (_, _, b0, b1, ub) in zip(progs[:-1], progs[1:]):
        out.append(bool(ua == ub and np.array_equal(maps[1 + a0:1 + a1], maps[1 + b0:1 + b1])))
    return out


class MaskedMatmul:
    """``mm = MaskedMatmul(A, pieces, geom, parent_map, device)``; ``out =
    mm(points, phi)`` is the (rows, npts) float64 table of every macro
    program at ``points`` (npts, sd), sd 2 or 3, from ``phi``, the zoo's
    (>= max nexp_c, npts) float64 Dubiner tabulation at the same points.

    ``A`` (rows, K) is the merged change of basis: per piece c, in program
    order, the columns ``pieces[c][1]`` wide that multiply the leading
    ``pieces[c][1]`` rows of ``phi`` on that subcell.  ``geom`` holds per
    program {"maps": [(A_c, b_c) rescaled barycentric map per subcell],
    "unique": bool, "rows": (r0, r1)}; ``parent_map`` is the parent cell's
    rescaled barycentric map (``fused_zoo._merge_macro_programs`` builds all
    of them).

    ``plan`` is the kernel's (point tile, columns of a slice, slices in the
    ring, blocks an SM), ``plan_for``'s choice; setting it rebuilds the
    slice table.  ``launches`` counts kernel launches (the plain CPU path
    adds nothing).
    """

    #: which TPU kernel this engine ports
    name = "K7"
    #: point tiles (csrc/masked_matmul.cu instantiates them; two threads a
    #: point), and by sd the threads an SM its launch bounds leave registers
    #: for (csrc ``threads_sm``)
    POINT_TILES, THREADS_SM = (256, 128, 64), {2: 512, 3: 768}
    #: the fewest slices in the ring, the most (csrc STAGES), the fewest
    #: columns of a slice (8.5 KB) where the chunk is wider, and the columns
    #: past which more, smaller blocks beat wider slices (PERF.md section 6)
    MIN_STAGES, STAGES, MIN_COLS, WIDE_COLS = 2, 4, 32, 64
    #: shared memory a block may take on sm_90, an SM's, what the SM keeps
    #: for each resident block, and the unit it allocates a block's in
    SMEM_MAX, SMEM_SM, SMEM_BLOCK, SMEM_UNIT = 232448, 233472, 1024, 128

    def __init__(self, A, pieces, geom, parent_map, device=None):
        A = np.asarray(A, np.float64)
        self.rows, self.K = A.shape
        self.geom = [dict(g, maps=[(np.asarray(Am, np.float64), np.asarray(bm, np.float64))
                                   for Am, bm in g["maps"]]) for g in geom]
        self.parent_map = tuple(np.asarray(v, np.float64) for v in parent_map)
        self.sd = self.parent_map[0].shape[1]
        if self.sd not in (2, 3):
            raise NotImplementedError(
                f"K7 covers triangle and tetrahedron parents (sd = 2, 3), not sd = {self.sd}: "
                "the interval's macro programs take K3 (macro_oneshot.one_shot_applies)")
        self.nexp = [int(n) for _, n in pieces]
        maps, progs, pieces_t = pack_geometry(self.geom, self.parent_map, self.nexp)
        if int(pieces_t[-1].sum()) != self.K:
            raise ValueError("the pieces must cover the columns of A")
        #: mask words a point keeps for the widest program (32 subcells a word)
        self.words = mask_words(progs)
        self.max_nexp = max(self.nexp)
        self.chunks = chunk_table(progs, pieces_t)
        self._progs, self._pieces = progs, pieces_t
        self._shared = same_bins(maps, progs)
        #: columns of the widest chunk: a slice needs no more
        self.chunk_cols = max(int(progs[g, 3] - progs[g, 2]) * int(kw)
                              for g, _, _, kw in self.chunks)
        self.device = resolve_device(device)

        def as_t(a, dtype=torch.float64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=self.device)

        # the kernel reads A in its slices' layout (At, built with the plan's
        # slices); the plain version reads A
        self.A = as_t(A)
        self.maps = as_t(maps)
        self.progs = as_t(progs, torch.int32)
        self.pieces = as_t(pieces_t, torch.int32)
        self.device = self.A.device       # "cuda" resolved to its index
        plan = self.plan_for(self.max_nexp, self.chunk_cols, self.sd, self.words,
                             int((progs[:, 3] - progs[:, 2]).max()))
        if plan is None:
            raise NotImplementedError(
                f"a Phi prefix of {self.max_nexp} rows and {self.words} mask words a point: "
                f"K7's smallest point tile leaves no room for a ring of A in a block's "
                f"{self.SMEM_MAX} bytes of shared memory")
        self.plan = plan
        self.launches = 0

    @property
    def plan(self):
        return self._plan

    @plan.setter
    def plan(self, plan):
        if plan[0] not in self.POINT_TILES:
            raise ValueError(f"plan {plan}: K7 is built for point tiles {self.POINT_TILES}")
        widest = int((self._progs[:, 3] - self._progs[:, 2]).max())
        if plan[1] < widest:
            raise ValueError(f"a slice of {plan[1]} columns: one k of a program of {widest} "
                             f"pieces needs {widest}")
        self._plan = tuple(plan)
        slices, gather = slice_table(self.chunks, self._progs, self._pieces, self.K, plan[1],
                                     CHUNK_ROWS, 8, self._shared)
        self.slices = torch.as_tensor(slices, device=self.device)
        self.At = gather_slices(self.A, torch.as_tensor(gather, device=self.device))

    @classmethod
    def smem_bytes(cls, kmax, tp, cols, stages, words=1):
        """Shared memory of a block of ``tp`` points (csrc ``smem_bytes``):
        the Phi tile, a ring of ``stages`` slices of ``cols`` columns, each
        point slot's factor, sorted point and ``words`` mask words, the
        mbarriers and counters."""
        return 8 * (kmax * tp + stages * cols * COLUMN_STRIDE + tp) + 4 * tp * (1 + words) + 8 * (
            3 * cls.STAGES + 1)

    @classmethod
    def fit(cls, kmax, chunk_cols, tp, blocks, words=1, widest=1):
        """(tp, slice columns, slices in the ring, blocks) with the widest
        slice, up to ``chunk_cols``, that MIN_STAGES of leave room for beside
        the Phi tile in the shared memory of ``blocks`` blocks an SM, and as
        many of those slices as fit, up to STAGES; None if that slice is
        under ``min(chunk_cols, MIN_COLS)`` columns or one k of the
        ``widest`` program."""
        col = 8 * COLUMN_STRIDE
        budget = min(cls.SMEM_MAX, (cls.SMEM_SM // blocks - cls.SMEM_BLOCK)
                     // cls.SMEM_UNIT * cls.SMEM_UNIT)
        free = budget - cls.smem_bytes(kmax, tp, 0, 0, words)
        cols = min(chunk_cols, max(0, free) // (cls.MIN_STAGES * col))
        if cols < max(min(chunk_cols, cls.MIN_COLS), widest):
            return None
        return tp, cols, min(cls.STAGES, free // (cols * col)), blocks

    @classmethod
    def candidates(cls, kmax, chunk_cols, sd, scale=1, words=1, widest=1):
        """Every plan ``fit`` takes for a Phi prefix of ``kmax`` rows,
        chunks ``chunk_cols`` columns wide, ``words`` mask words a point and
        programs of at most ``widest`` pieces in cells of dimension ``sd``:
        each point tile at each count of blocks an SM up to ``scale`` times
        the threads its launch bounds leave registers for, most first."""
        return [plan for tp in cls.POINT_TILES
                for blocks in range(scale * cls.THREADS_SM[sd] // (2 * tp), 0, -1)
                if (plan := cls.fit(kmax, chunk_cols, tp, blocks, words, widest)) is not None]

    @classmethod
    def plan_for(cls, kmax, chunk_cols, sd, words=1, widest=1):
        """Of the ``candidates``, the one that keeps most threads an SM; then
        one whose slices hold ``min(chunk_cols, WIDE_COLS)`` columns (fewer
        waits on the ring); then the most blocks an SM (one block's binning
        and ring fill beside another's products), the widest slice and the
        deepest ring; None if none fits."""
        wide = min(chunk_cols, cls.WIDE_COLS)
        return max(cls.candidates(kmax, chunk_cols, sd, words=words, widest=widest),
                   key=lambda p: (p[0] * p[3], p[1] >= wide, p[3], p[1], p[2]), default=None)

    @property
    def smem(self):
        """Shared memory of one of the plan's blocks, in bytes."""
        tp, cols, stages, _ = self.plan
        return self.smem_bytes(self.max_nexp, tp, cols, stages, self.words)

    def occupancy(self):
        """Blocks of the plan an SM holds at once on the card (registers and
        shared memory), from the CUDA runtime."""
        tp, cols, stages, _ = self.plan
        blocks = load_kernels().fiat_masked_matmul_occupancy(self.sd, self.max_nexp, tp, cols,
                                                             stages, self.words)
        check_launch("fiat_masked_matmul_occupancy", max(0, -blocks))
        return blocks

    def _check(self, points, phi):
        for name, t in (("points", points), ("phi", phi)):
            if not isinstance(t, torch.Tensor):
                raise TypeError(f"{name} must be a torch.Tensor")
            if t.dtype != torch.float64:
                raise TypeError(f"{name} must be float64, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if points.dim() != 2 or points.shape[1] != self.sd:
            raise ValueError(f"points must have shape (npts, {self.sd}), got {tuple(points.shape)}")
        if points.shape[0] >= 2 ** 31:
            raise ValueError("too many points for one launch")
        if phi.dim() != 2 or phi.shape[0] < self.max_nexp or phi.shape[1] != points.shape[0]:
            raise ValueError(f"phi must have shape (>= {self.max_nexp}, {points.shape[0]}), "
                             f"got {tuple(phi.shape)}")
        if phi.device != points.device:
            raise ValueError(f"phi on {phi.device}, points on {points.device}")

    def __call__(self, points, phi):
        self._check(points, phi)
        if points.device.type == "cpu":
            return self.plain(points, phi)
        if points.device.type != "cuda" or points.device != self.device:
            raise ValueError(f"points on {points.device}, engine on {self.device}")
        npts = points.shape[0]
        out = torch.empty((self.rows, npts), dtype=torch.float64, device=points.device)
        if npts == 0:
            return out
        lib = load_kernels()
        tp, cols, stages, _ = self.plan
        err = lib.fiat_masked_matmul(
            points.data_ptr(), npts, self.sd, BINNING_TOL[torch.float64], self.maps.data_ptr(),
            self.progs.data_ptr(), self.pieces.data_ptr(), self.slices.data_ptr(),
            self.slices.shape[0], self.At.data_ptr(), phi.data_ptr(), self.max_nexp,
            out.data_ptr(), tp, cols, stages, self.words, stream_of(points))
        check_launch(f"fiat_masked_matmul ({self.rows} x {self.K}, sd = {self.sd}, plan "
                     f"{self.plan})", err)
        self.launches += 1
        return out

    def masks(self, points):
        """Every piece's {0,1} mask row (``subcell_masks``) and every
        program's cover count (None where it keeps its first hit), on the
        points' device."""
        rows, totals = [], []
        for g in self.geom:
            masks, total = subcell_masks(points, self.parent_map, g["maps"],
                                         unique=g["unique"], raw=True)
            rows.extend(masks)
            totals.append(total)
        return rows, totals

    def masked_basis(self, masks, phi):
        """B = cat(mask_c * phi[:nexp_c]) (K, npts), the plain version's
        operand."""
        return torch.cat([m * phi[:n] for m, n in zip(masks, self.nexp)], dim=0)

    def plain(self, points, phi):
        """The same tables in plain PyTorch, on the points' device."""
        masks, totals = self.masks(points)
        out = self.A.to(points.device) @ self.masked_basis(masks, phi)
        for g, total in zip(self.geom, totals):
            if total is not None:
                r0, r1 = g["rows"]
                out[r0:r1] *= 1.0 / total
        return out
