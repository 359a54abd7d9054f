"""K3: the macro (split-complex) elements of a zoo in one CUDA launch, on
intervals, triangles and tetrahedra.

Counterpart of ``fiat_tpu/ops/pallas_multiword.py`` (``FusedMacroOneShot``,
with the binning of ``pallas_recurrence.SubcellBinning``) and, in float32,
of the macro side program of ``fiat_tpu/ops/pallas_tabulate.py``
(``PallasZooTabulator._macro_tables``).  For every point the kernel
(``csrc/macro_oneshot.cu``) bins it to the subcells of every macro program,
runs the parent-cell Dubiner recurrence, multiplies the merged change of
basis by the masked parent basis and averages over the subcells that share
the point.  The TPU kernel does this in df32 pairs and Ozaki windows;
Hopper has native FP64, so the kernel computes it in f64 (or in f32 for the
f32 engine).  On both parents the grid runs over row chunks of one program,
as K7's does, so A has no size limit; a chunk's columns reach shared memory
in slices (runs of k), kept there whole where they fit a quarter of an SM
beside the Phi tile and streamed through a ring of bulk copies where not
(``MacroOneShot.plan_for``, ``slice_table``), so no chunk has to fit a
block either; each point
multiplies only the subcells it falls in, and keeps its parent basis in its
own column of a shared-memory Phi tile (the kernel's source note says why).
A point is binned against each chunk's program alone, 32 subcells a mask
word, so a zoo and each of its programs may have any number of subcells.
One row per program (interpolation) runs an instantiation whose chunks are
one row high.  Every parent degree: up to ``UNROLLED_DEGREE`` on
instantiations with the recurrence unrolled and a point tile of their own,
past them on one generic instantiation per (cell, type, chunk height) that
takes the degree and the point tile (``GENERIC_TILES``, the widest whose
Phi tile leaves room for a plan) at the launch; where none does, the
wrapper raises ``NotImplementedError`` naming the shared memory.

The plain version beside it does the same in plain PyTorch: masks by
``core.expansions.subcell_masks`` (the body of
``partition_of_unity_masks``), the parent recurrence, a masked B,
``torch.matmul``, then the reciprocal of the cover count.  The wrapper runs
it for CPU tensors only; for a CUDA tensor it launches the kernel or raises.
"""

import ctypes
import math

import numpy as np
import torch

from ..core.expansions import dubiner_tabulate, subcell_masks
from .kernels import check_launch, load_kernels, no_tf32, resolve_device, stream_of
from .recurrence import pack_stages

#: the top of the unrolled instantiations' parent degrees, per spatial
#: dimension (csrc/macro_oneshot.cuh); every degree past them runs the
#: generic instantiation
UNROLLED_DEGREE = {1: 15, 2: 10, 3: 10}
#: the generic instantiation's point tiles, widest first (csrc
#: macro_oneshot.cuh generic_tile): a launch argument, so that a high
#: degree's Phi tile fits
GENERIC_TILES = (128, 64, 32)
#: subcells in all up to which the f64 engine takes K3 on a triangle parent,
#: and K7 past it (``one_shot_applies``)
ONE_SHOT_PIECES = 32
#: binning tolerance per working type (``subcell_masks``' defaults)
BINNING_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
#: rows of one chunk, and values per staged column, of the chunked macro
#: kernels (K3 and K7: RC_TABLES, column_stride in csrc/macro_oneshot.cu, RC,
#: RCP in csrc/masked_matmul.cu)
CHUNK_ROWS = 32
COLUMN_STRIDE = CHUNK_ROWS + 2
#: the chunk height of K3's instantiation for one row per program
#: (csrc/macro_oneshot.cu RC_ONE)
ONE_ROW_CHUNK = 1
#: shared memory one block may take on the card (bytes)
MAX_SMEM = 227 * 1024
#: point tiles one block of K3 may walk (csrc/macro_oneshot.cuh MAX_SUB), and
#: the blocks a launch keeps at least, where it can: about eight an SM on
#: the H100's 132 SMs (of 256 to 8192, 1024 timed best on the H100 on the
#: C1 zoos and full_zoo)
MAX_SUB = 8
MIN_BLOCKS = 1024
#: the fewest and the most buffers of K3's streaming ring (csrc MAX_STAGES),
#: and the bytes a streamed slice aims at, K7's 64 columns of 32 f64 rows:
#: two buffers of such slices timed fastest of the candidate rings in every
#: streamed cell on the H100 (PERF.md section 6)
MIN_STAGES, MAX_STAGES = 2, 4
SLICE_BYTES = 64 * COLUMN_STRIDE * 8
#: columns of the slice table of K3 and K7 and its flags
#: (csrc/macro_oneshot.cuh, csrc/masked_matmul.cu; K3 reads the first two)
SLICE_COLS = 11
FIRST_IN_CHUNK, LAST_IN_CHUNK, FIRST_IN_PROGRAM, SAME_BINS = 1, 2, 4, 8
#: shared memory of one buffer's full and empty mbarriers and counter
BARRIER_BYTES = 20
#: the most shared memory of a block whose chunks stay resident: a quarter
#: of an SM's, so that four blocks (16 warps) share an SM
RESIDENT_SMEM = MAX_SMEM // 4
#: the most blocks of one launch (a one-dimensional grid)
MAX_BLOCKS = 2 ** 31 - 1


def column_stride(rows):
    """Values per staged column of a chunk ``rows`` high
    (csrc/macro_oneshot.cuh ``column_stride``): ``rows + 2`` (even, so
    16-byte pairs stay aligned), or 1 for one-row chunks."""
    return rows + 2 if rows > 1 else 1


def point_tiles(sd, degree, itemsize):
    """The point tiles (threads of a block) K3 takes at a parent degree,
    widest first: past ``UNROLLED_DEGREE`` the generic instantiation's
    ``GENERIC_TILES``; else the unrolled instantiation's own
    (csrc/macro_oneshot.cuh ``point_tile``, a constant of it): 128, but 64
    on tetrahedra from degree 9 in double, whose Phi tile of 128 points
    alone passes a block's shared memory."""
    if degree > UNROLLED_DEGREE[sd]:
        return GENERIC_TILES
    return (64 if sd == 3 and degree >= 9 and itemsize == 8 else 128,)


def tiles_per_block(npts, ngroups, tp=128):
    """Point tiles of ``tp`` points each block of K3 walks with its group of
    chunks: as many as keep ``MIN_BLOCKS`` blocks in the grid, 1 to
    ``MAX_SUB``.  Fewer tiles a block fetch a resident group more often;
    more leave SMs idle at the tail."""
    tiles = -(-npts // tp)
    return max(1, min(MAX_SUB, tiles * ngroups // MIN_BLOCKS))


def mask_words(progs):
    """Mask words a point keeps for the widest program of ``progs``
    (``pack_geometry``'s): 32 subcells a word (csrc/binning.cuh
    ``words_of``)."""
    return max(-(-int(c1 - c0) // 32) for _, _, c0, c1, _ in progs)


def pack_geometry(geom, parent_map, nexp):
    """The binning tables of ``csrc/binning.cuh`` (float64 numpy/int32) on
    intervals, triangles or tetrahedra (sd = 1, 2, 3): ``maps`` (1 + pieces,
    sd + 1, sd +
    1), the parent's rescaled barycentric map first, then every subcell's,
    each row (a_0, ..., a_{sd-1}, b); ``progs`` (programs, 5) = (first row,
    end row, first piece, end piece, unique) from ``geom`` (per program
    {"maps", "unique", "rows"}); ``pieces`` (pieces, 2) = (first column,
    nexp) from the per-piece widths ``nexp``."""
    parent_map = tuple(np.asarray(v, np.float64) for v in parent_map)
    sd = parent_map[0].shape[1]
    if sd not in (1, 2, 3) or parent_map[0].shape != (sd + 1, sd):
        raise NotImplementedError(f"the macro kernels bin on intervals, triangles and "
                                  f"tetrahedra, not a parent map of shape {parent_map[0].shape}")
    nexp = [int(n) for n in nexp]
    maps, progs, c0 = [parent_map], [], 0
    for g in geom:
        maps.extend((np.asarray(Am, np.float64), np.asarray(bm, np.float64))
                    for Am, bm in g["maps"])
        r0, r1 = g["rows"]
        progs.append((r0, r1, c0, c0 + len(g["maps"]), int(bool(g["unique"]))))
        c0 += len(g["maps"])
    if c0 != len(nexp):
        raise ValueError("every subcell of every program needs one piece")
    offsets = np.concatenate([[0], np.cumsum(nexp)]).astype(int)
    maps = np.stack([np.column_stack([Am, bm]) for Am, bm in maps])
    return (maps, np.asarray(progs, np.int32).reshape(-1, 5),
            np.column_stack([offsets[:-1], nexp]).astype(np.int32).reshape(-1, 2))


def chunk_table(progs, pieces, rows=CHUNK_ROWS):
    """Every program's rows cut into chunks of at most ``rows``: int32
    (nchunks, 4) = (program, first row, rows, kw), kw the program's widest
    piece.  K3 cuts them into slices (``slice_table``), K7 lays them out the
    same way by k (``masked_matmul.chunk_layout``)."""
    chunks = []
    for g, (r0, r1, c0, c1, _) in enumerate(progs):
        kw = int(pieces[c0:c1, 1].max())
        chunks.extend((g, row, min(rows, r1 - row), kw) for row in range(r0, r1, rows))
    return np.asarray(chunks, np.int32).reshape(-1, 4)


def ceil16(nbytes):
    """``nbytes`` rounded up to a multiple of 16 (a bulk copy's unit)."""
    return -(-nbytes // 16) * 16


def slice_table(chunks, progs, pieces, K, cols, rows, itemsize, shared=None):
    """The slices of K3 and K7: every chunk of ``chunk_table(progs, pieces,
    rows)`` cut into runs of k, as many as ``cols`` columns hold (at least
    one k), in chunk order, each laid out as the kernels' shared memory
    holds it (column k * P + j for piece j of the program's P,
    ``column_stride(rows)`` values a column, so the columns of a run of k
    are one contiguous block and lanes in different pieces read columns one
    apart) and padded to 16 bytes, one after another in At.  Returns
    (slices int32 (nslices, SLICE_COLS) = (program, first row, rows, first
    k, end k, offset in At, P, flags, values, the program's first piece,
    unique), gather int64: per value of At its index in ``A.ravel()`` of an
    A of K columns, or -1 for a zero: the index of the zero that
    ``gather_slices`` appends).
    ``shared`` (per program, K7's ``masked_matmul.same_bins``) marks the
    programs that keep the masks of the one before (SAME_BINS on their
    first slice)."""
    rcp, align = column_stride(rows), 16 // itemsize
    out, gathers, offset, prev = [], [], 0, None
    for g, row, n, kw in chunks:
        c0, c1 = int(progs[g, 2]), int(progs[g, 3])
        npieces = c1 - c0
        off, width = pieces[c0:c1, 0][None, :, None], pieces[c0:c1, 1][None, :, None]
        r = np.arange(rcp)[None, None, :]
        run = max(1, cols // npieces)
        for k in range(0, kw, run):
            end = min(kw, k + run)
            ks = np.arange(k, end)[:, None, None]
            block = np.where((ks < width) & (r < n), (row + r) * K + off + ks, -1).ravel()
            size = -(-block.size // align) * align
            gathers += [block, np.full(size - block.size, -1)]
            first = k == 0 and g != prev
            flags = ((FIRST_IN_CHUNK if k == 0 else 0) | (LAST_IN_CHUNK if end == kw else 0)
                     | (FIRST_IN_PROGRAM if first else 0)
                     | (SAME_BINS if first and shared is not None and shared[g] else 0))
            out.append((g, row, n, k, end, offset, npieces, flags, size, c0,
                        int(progs[g, 4])))
            offset += size
        prev = g
    return (np.asarray(out, np.int32).reshape(-1, SLICE_COLS),
            np.concatenate(gathers).astype(np.int64))


def gather_slices(A, gather):
    """At from A (numpy or torch, any shape) by ``slice_table``'s gather:
    A's values and a zero appended, indexed (-1 takes the zero)."""
    if isinstance(A, np.ndarray):
        return np.append(A.ravel(), 0.0)[gather]
    return torch.cat([A.reshape(-1), A.new_zeros(1)])[gather]


def smem_bytes(nexp, itemsize, tp, ring, words, nbar):
    """Shared memory of a block of K3 (csrc/macro_oneshot.cuh
    ``smem_bytes``): ``ring`` values of slices, the Phi tile (``nexp`` x
    ``tp``) and a factor a point, ``words`` mask words a point, and
    ``nbar`` buffers' mbarriers."""
    return itemsize * (ring + (nexp + 1) * tp) + 4 * words * tp + BARRIER_BYTES * nbar


def tables_plan(merged, dtype=torch.float64):
    """The plan K3 would take for the merged programs' tables (``plan_for``
    over the point tiles of their parent degree), or None where no point
    tile leaves room for one; computed on the host."""
    itemsize = 8 if dtype == torch.float64 else 4
    nexp = [int(n) for _, n in merged["pieces"]]
    maps, progs, pieces_t = pack_geometry(merged["geom"], merged["parent_map"], nexp)
    sd, degree = maps.shape[1] - 1, int(merged["degree"])
    chunks = chunk_table(progs, pieces_t)
    return next((plan for tp in point_tiles(sd, degree, itemsize)
                 if (plan := MacroOneShot.plan_for(tp, math.comb(degree + sd, sd), itemsize,
                                                   CHUNK_ROWS, chunks, progs, 1,
                                                   mask_words(progs))) is not None), None)


def one_shot_applies(merged):
    """Whether K3 is the f64 engine's kernel for the merged macro programs
    (``fused_zoo._merge_macro_programs``' output).  On an interval parent
    always, whatever the number of subcells: fiat_tpu's one-shot route is
    generic in sd (``pallas_multiword.py:1026-1048``) and K7 has no sd = 1
    stage.  On a triangle parent where the programs have at most
    ``ONE_SHOT_PIECES`` subcells in all and K3's tables have a plan at the
    parent degree (``tables_plan``: every degree whose Phi tile leaves room
    at some point tile; triangle degree 38 in f64 does not).  K3 takes any
    number of subcells, but past those the f64 tables take K7, which reads
    the zoo's Phi from K1 instead of running the recurrence again; on a
    tetrahedral parent K3's sd = 3 stage runs the f32 tables and
    interpolation, and the f64 tables take K7, which the H100 measured
    faster on ``sv_macro_tet`` (PERF.md §6)."""
    shape = np.asarray(merged["parent_map"][0]).shape
    if shape == (2, 1):
        return True
    return (shape == (3, 2) and len(merged["pieces"]) <= ONE_SHOT_PIECES
            and tables_plan(merged) is not None)


class MacroOneShot:
    """``mo = MacroOneShot(A, pieces, geom, parent_map, degree, scale,
    affine_map, device, dtype)``; ``out = mo(points)`` is the (rows, npts)
    table of every macro program at ``points`` (npts, sd), sd 1, 2 or 3 as
    ``parent_map`` says, in ``dtype`` (float64, or float32 for the f32
    engine).

    ``A`` (rows, K) is the merged change of basis: per subcell ("piece") c,
    in program order, the columns ``pieces[c][1]`` wide that multiply the
    leading parent basis members on that subcell.  ``geom`` holds per
    program {"maps": [(A_c, b_c) rescaled barycentric map per subcell],
    "unique": bool, "rows": (r0, r1)}; ``parent_map`` is the parent cell's
    rescaled barycentric map; ``degree``, ``scale`` and ``affine_map`` define
    the parent recurrence (onto the default simplex by ``A x + b``).

    ``mo(points, A=W)`` runs the same kernel with another change of basis
    ``W`` (programs, K), one row per program (interpolation folds its
    coefficients into it): row g is program g's binned, averaged sum.

    ``launches`` counts kernel launches (the plain CPU path adds nothing).
    """

    #: which TPU kernel this engine ports
    name = "K3"

    def __init__(self, A, pieces, geom, parent_map, degree, scale, affine_map, device=None,
                 dtype=torch.float64):
        if dtype not in BINNING_TOL:
            raise TypeError(f"K3 runs in float64 or float32, not {dtype}")
        self.dtype = dtype
        self.tol = BINNING_TOL[dtype]
        A = np.asarray(A, np.float64)
        self.rows, self.K = A.shape
        self.degree = int(degree)
        self.geom = [dict(g, maps=[(np.asarray(Am, np.float64), np.asarray(bm, np.float64))
                                   for Am, bm in g["maps"]]) for g in geom]
        self.parent_map = tuple(np.asarray(v, np.float64) for v in parent_map)
        self.nexp = [int(n) for _, n in pieces]
        maps, progs, pieces_t = pack_geometry(self.geom, self.parent_map, self.nexp)
        self.sd = sd = self.parent_map[0].shape[1]
        if self.degree < 0:
            raise ValueError(f"macro parent degree {degree} is negative")
        #: whether the parent degree runs the generic instantiation
        self.generic = self.degree > UNROLLED_DEGREE[sd]
        if max(self.nexp) > math.comb(self.degree + sd, sd):
            raise ValueError("a subcell reads more parent members than the recurrence makes")
        if int(pieces_t[-1].sum()) != self.K:
            raise ValueError("the pieces must cover the columns of A")
        self.offsets = pieces_t[:, 0].tolist()
        self.scale = float(scale)
        Af, bf = affine_map
        self.affine = np.concatenate([np.asarray(Af, np.float64).ravel(),
                                      np.asarray(bf, np.float64).ravel()])
        self.device = resolve_device(device)

        def as_t(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), device=self.device).to(dt)

        self.A = as_t(A)
        self.maps = as_t(maps)
        self.progs = as_t(progs, torch.int32)
        self.pieces = as_t(pieces_t, torch.int32)
        consts, slots = pack_stages(self.degree, sd=sd)
        self.consts = as_t(consts)
        self.slots = as_t(slots, torch.int32)
        self.device = self.A.device       # "cuda" resolved to its index
        #: mask words a point keeps for the widest program (32 subcells a word)
        self.words = mask_words(progs)
        self._progs, self._pieces = progs, pieces_t
        # the row chunks of the tables, one a group; for ``mo(points, A=W)``
        # one row per program, every program's in one group, so the
        # recurrence runs once a point
        one = progs.copy()
        one[:, 0], one[:, 1] = np.arange(len(progs)), np.arange(1, len(progs) + 1)
        self.chunks = chunk_table(progs, pieces_t)
        self.chunks_one = chunk_table(one, pieces_t, ONE_ROW_CHUNK)
        self.cpb, self.cpb_one = 1, len(self.chunks_one)
        #: the point tiles the degree's instantiation takes (one constant
        #: of an unrolled one; the generic one's GENERIC_TILES)
        self.tiles = point_tiles(sd, self.degree, self.itemsize)
        self.plan = self._first_plan()
        self.plan_one = self._first_plan(one=True)
        if self.plan is None and self.plan_one is None:
            raise NotImplementedError(
                f"K3: a Phi tile of {self.nexp_parent} rows (parent degree {self.degree}, sd "
                f"{sd}) and {self.words} mask words a point leave no room for a ring of slices "
                f"at {self.tiles[-1]} points in a block's {MAX_SMEM} bytes of shared memory")
        self.launches = 0

    @property
    def tp(self):
        """The point tile of the tables' plan (the narrowest the degree takes
        without one)."""
        return self.tiles[-1] if self.plan is None else self.plan[0]

    def _first_plan(self, one=False):
        """``plan_for`` at the widest point tile of ``tiles`` that has one,
        or None."""
        return next((plan for tp in self.tiles
                     if (plan := self.plan_for(*self._plan_args(one, tp))) is not None), None)

    @property
    def plan(self):
        """The tables' plan: (point tile, slice columns, buffers, resident),
        ``plan_for``'s choice, or None; setting it rebuilds the tables'
        layout on next use."""
        return self._plan

    @plan.setter
    def plan(self, plan):
        self._plan, self._tab = self._checked(plan, self.chunks), None

    @property
    def plan_one(self):
        """One row a program's plan, as ``plan``."""
        return self._plan_one

    @plan_one.setter
    def plan_one(self, plan):
        self._plan_one, self._one = self._checked(plan, self.chunks_one), None

    def _checked(self, plan, chunks):
        """``plan`` if the kernel takes it for ``chunks``: the
        instantiation's point tile, slices of at least one k of the widest
        program (of whole chunks where resident) and a ring of 1 to
        MAX_STAGES buffers."""
        if plan is None:
            return None
        tp, cols, stages, resident = plan
        npieces = self._progs[chunks[:, 0], 3] - self._progs[chunks[:, 0], 2]
        need = int((npieces * chunks[:, 3]).max() if resident else npieces.max())
        if tp not in self.tiles or cols < need or not (resident or 1 <= stages <= MAX_STAGES):
            raise ValueError(f"K3 plan {plan}: {self.tiles} points, slices of at least {need} "
                             f"columns, 1 to {MAX_STAGES} buffers")
        return tuple(plan)

    @property
    def itemsize(self):
        """Bytes of one value in the working type."""
        return 8 if self.dtype == torch.float64 else 4

    @property
    def nexp_parent(self):
        """Members of the parent recurrence: the rows of the Phi tile."""
        return math.comb(self.degree + self.sd, self.sd)

    @staticmethod
    def candidates(tp, nexp, itemsize, rows, chunks, progs, cpb, words):
        """Every plan the kernel takes for ``chunks`` (``chunk_table(...,
        rows)``) taken ``cpb`` consecutive ones a block of ``tp`` points, a
        Phi tile of ``nexp`` members and ``words`` mask words a point, in
        values of ``itemsize`` bytes, within a block's MAX_SMEM, narrowest
        streaming ring first: [((tp, slice columns, buffers, resident),
        block bytes)].  Every group's chunks resident (one slice a chunk,
        fetched once a block), and rings of MIN_STAGES and MAX_STAGES
        buffers of slices of one k of the widest program, of SLICE_BYTES
        and of twice that (at most the widest chunk)."""
        col = column_stride(rows) * itemsize
        npieces = [int(progs[g, 3] - progs[g, 2]) for g in chunks[:, 0]]
        cols = [p * int(kw) for p, kw in zip(npieces, chunks[:, 3])]
        group = max(sum(ceil16(c * col) for c in cols[i:i + cpb])
                    for i in range(0, len(cols), cpb))
        most = min(cpb, len(cols))
        widths = sorted({min(max(cols), max(max(npieces), n * SLICE_BYTES // col))
                         for n in (0, 1, 2)})
        fixed = smem_bytes(nexp, itemsize, tp, 0, words, 0)
        out = [((tp, w, n, False), fixed + n * (ceil16(w * col) + BARRIER_BYTES))
               for w in widths for n in (MIN_STAGES, MAX_STAGES)]
        out.append(((tp, max(cols), most, True), fixed + group))
        return [(plan, nbytes) for plan, nbytes in out if nbytes <= MAX_SMEM]

    @classmethod
    def plan_for(cls, tp, nexp, itemsize, rows, chunks, progs, cpb, words):
        """Of the ``candidates``, the resident plan where its block takes
        at most RESIDENT_SMEM (a quarter of an SM's, so four blocks share an
        SM), else a ring of MIN_STAGES buffers of slices of SLICE_BYTES, or
        of the widest that fit; None without candidates.  On the H100 the
        resident plan was the fastest where it fits RESIDENT_SMEM and two
        buffers of SLICE_BYTES the fastest streamed (PERF.md section 6)."""
        cands = cls.candidates(tp, nexp, itemsize, rows, chunks, progs, cpb, words)
        resident = [plan for plan, nbytes in cands if plan[3] and nbytes <= RESIDENT_SMEM]
        if resident:
            return resident[0]
        widest = max(int(progs[g, 3] - progs[g, 2]) for g in chunks[:, 0])
        aim = max(widest, SLICE_BYTES // (column_stride(rows) * itemsize))
        ring = [plan for plan, _ in cands
                if not plan[3] and plan[2] == MIN_STAGES and plan[1] <= aim]
        return max(ring, key=lambda plan: plan[1],
                   default=next((plan for plan, _ in cands if plan[3]), None))

    def _plan_args(self, one=False, tp=None):
        """The arguments of ``candidates`` and ``plan_for`` for this engine's
        tables, or ``one`` row a program, at point tile ``tp`` (the first of
        ``tiles`` when None)."""
        rows, chunks, cpb = ((ONE_ROW_CHUNK, self.chunks_one, self.cpb_one) if one
                             else (CHUNK_ROWS, self.chunks, self.cpb))
        return (self.tiles[0] if tp is None else tp, self.nexp_parent, self.itemsize, rows,
                chunks, self._progs, cpb, self.words)

    def plan_candidates(self, one=False):
        """``candidates`` for this engine's tables, or ``one`` row a
        program, at every point tile the degree takes."""
        return [c for tp in self.tiles for c in self.candidates(*self._plan_args(one, tp))]

    def layout(self, one=False):
        """The launch's tables of one mode (the tables, or ``one`` row per
        program) under its plan: a dict of the slices, the groups' first
        slices, the gather of At from A's values (``slice_table``), and the
        plan's shared memory: ``ring`` values before
        the Phi tile, ``nbar`` buffers, ``buf`` values a streaming buffer,
        ``smem`` bytes.  None where the mode has no plan."""
        plan = self.plan_one if one else self.plan
        if plan is None:
            return None
        tp, cols, stages, resident = plan
        rows, chunks = (ONE_ROW_CHUNK, self.chunks_one) if one else (CHUNK_ROWS, self.chunks)
        cpb = self.cpb_one if one else self.cpb
        slices, gather = slice_table(chunks, self._progs, self._pieces, self.K, cols, rows,
                                     self.itemsize)
        # each group's first slice: the slices of its first chunk
        first = np.flatnonzero(slices[:, 7] & FIRST_IN_CHUNK)
        groups = np.append(first[::cpb], len(slices))
        align = 16 // self.itemsize
        if resident:
            ring = int(max(slices[groups[i + 1] - 1, 5] + slices[groups[i + 1] - 1, 8]
                           - slices[groups[i], 5] for i in range(len(groups) - 1)))
            nbar, buf = 0, 0
        else:
            buf = -(-cols * column_stride(rows) // align) * align
            ring, nbar = stages * buf, stages
        return {"slices": slices, "groups": groups.astype(np.int32), "gather": gather,
                "ring": ring, "nbar": nbar, "buf": buf,
                "smem": smem_bytes(self.nexp_parent, self.itemsize, tp, ring, self.words, nbar)}

    @property
    def smem(self):
        """Bytes of shared memory of a block of the tables' plan (None
        without a plan)."""
        lay = self._tables()
        return lay and lay["smem"]

    @property
    def smem_one(self):
        """Bytes of shared memory of a block of one row a program (None
        without a plan)."""
        lay = self._ones()
        return lay and lay["smem"]

    def _tables(self):
        """The tables' layout, and At, built on first use."""
        if self._tab is None:
            lay = self.layout()
            if lay is not None:
                lay["At"] = torch.as_tensor(gather_slices(self.A.cpu().numpy(), lay["gather"]),
                                            device=self.device).to(self.dtype)
                self._device_tables(lay)
            self._tab = lay
        return self._tab

    def _ones(self):
        """One row a program's layout, built on first use; At comes from
        each call's A: the kernel gathers a resident group itself, by the
        int32 table, and a streamed one is gathered before the launch."""
        if self._one is None:
            lay = self.layout(one=True)
            if lay is not None:
                dtype = torch.int32 if self.plan_one[3] else torch.int64
                lay["gather"] = torch.as_tensor(lay["gather"], dtype=dtype, device=self.device)
                self._device_tables(lay)
            self._one = lay
        return self._one

    def _device_tables(self, lay):
        lay["slices_t"] = torch.as_tensor(lay["slices"], device=self.device)
        lay["groups_t"] = torch.as_tensor(lay["groups"], device=self.device)

    def _check(self, points, A):
        if not isinstance(points, torch.Tensor):
            raise TypeError("points must be a torch.Tensor")
        if points.dtype != self.dtype:
            raise TypeError(f"points must be {self.dtype}, got {points.dtype}")
        if points.dim() != 2 or points.shape[1] != self.sd:
            raise ValueError(f"points must have shape (npts, {self.sd}), got "
                             f"{tuple(points.shape)}")
        if not points.is_contiguous():
            raise ValueError("points must be contiguous")
        if points.shape[0] >= 2 ** 31:
            raise ValueError("too many points for one launch")
        if A is not None:
            if not isinstance(A, torch.Tensor) or A.dtype != self.dtype:
                raise TypeError(f"A must be a {self.dtype} tensor")
            if tuple(A.shape) != (len(self.geom), self.K) or not A.is_contiguous():
                raise ValueError(f"A must be contiguous of shape {(len(self.geom), self.K)}, "
                                 f"got {tuple(A.shape)}")
            if A.device != points.device:
                raise ValueError(f"A on {A.device}, points on {points.device}")

    def __call__(self, points, A=None):
        self._check(points, A)
        if points.device.type == "cpu":
            return self.plain(points, A)
        if points.device.type != "cuda" or points.device != self.device:
            raise ValueError(f"points on {points.device}, engine on {self.device}")
        return self._launch(points, A)

    def _launch(self, points, A):
        """Launch the kernel on checked CUDA inputs: the (rows, npts)
        output.  Raises where the mode (the tables, or one row per program)
        has no plan (its Phi tile leaves no room for a ring even at the
        smallest point tile) or the grid would pass 2^31 - 1 blocks."""
        one = A is not None
        lay = self._ones() if one else self._tables()
        mode = "one row a program" if one else "tables"
        if lay is None:
            raise NotImplementedError(
                f"K3 {mode}: a Phi tile of {self.nexp_parent} rows and {self.words} mask words "
                f"a point leave no room for a ring of slices at {self.tiles[-1]} points in a "
                f"block's {MAX_SMEM} bytes of shared memory")
        tp, _, stages, resident = self.plan_one if one else self.plan
        npts = points.shape[0]
        out = torch.empty((A.shape[0] if one else self.rows, npts), dtype=self.dtype,
                          device=points.device)
        if npts == 0:
            return out
        ngroups = len(lay["groups"]) - 1
        sub = tiles_per_block(npts, ngroups, tp)
        nblocks = -(-(-(-npts // tp)) // sub) * ngroups
        if nblocks > MAX_BLOCKS:
            raise NotImplementedError(f"K3 {mode}: {nblocks} blocks, past a grid's {MAX_BLOCKS}")
        gather = None
        if not one:
            At = lay["At"]
        elif resident:      # the kernel gathers this call's A into its resident group
            At, gather = A, lay["gather"].data_ptr()
        else:
            At = gather_slices(A, lay["gather"])
        f64 = self.dtype == torch.float64
        fn = getattr(load_kernels(), "fiat_macro_oneshot" if f64 else "fiat_macro_oneshot_f32")
        affine = ((ctypes.c_double if f64 else ctypes.c_float) * 12)(*self.affine)
        err = fn(points.data_ptr(), npts, self.sd, self.consts.data_ptr(), self.slots.data_ptr(),
                 affine, self.scale, self.tol, self.degree, self.maps.data_ptr(),
                 self.pieces.data_ptr(), lay["slices_t"].data_ptr(),
                 lay["groups_t"].data_ptr(), ngroups, ONE_ROW_CHUNK if one else CHUNK_ROWS, sub,
                 int(resident), stages, lay["buf"], lay["ring"], lay["nbar"], self.words,
                 At.data_ptr(), gather, out.data_ptr(), tp, stream_of(points))
        check_launch(f"K3 ({out.shape[0]} x {self.K}, {self.dtype}, {mode}, plan "
                     f"{self.plan_one if one else self.plan})", err)
        self.launches += 1
        return out

    def plain(self, points, A=None):
        """The same tables in plain PyTorch, on the points' device (float32
        matrix products in full float32, never TF32)."""
        if A is None:
            A, rows = self.A.to(points.device), [g["rows"] for g in self.geom]
        else:
            rows = [(g, g + 1) for g in range(len(self.geom))]
        B, totals = self.operand(points)
        with no_tf32():
            out = A @ B
        for (r0, r1), total in zip(rows, totals):
            if total is not None:
                out[r0:r1] *= 1.0 / total
        return out

    def same_subcells(self, points):
        """(npts,) bool: whether the float32 binning (tolerance 1e-5) puts
        each point in the same subcells of every program as the float64
        binning (1e-12).  A point within 1e-5 of an interior face is averaged
        over the subcells that meet there in float32 only, so the f32 and f64
        tables of a macro element differ by design at the points where not."""
        same = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
        for g in self.geom:
            m32, _ = subcell_masks(points.float(), self.parent_map, g["maps"],
                                   unique=g["unique"], raw=True)
            m64, _ = subcell_masks(points.double(), self.parent_map, g["maps"],
                                   unique=g["unique"], raw=True)
            for a, b in zip(m32, m64):
                same &= a.double() == b
        return same

    def operand(self, points):
        """The plain version's masked parent basis B = cat(mask_c *
        phi[:nexp_c]) (K, npts) and every program's cover count (None where
        it keeps its first hit), on the points' device."""
        sd = self.sd
        Af = points.new_tensor(self.affine[:sd * sd].reshape(sd, sd))
        ref = points @ Af.T + points.new_tensor(self.affine[sd * sd:])
        phi = dubiner_tabulate(sd, self.degree, [ref[:, i] for i in range(sd)], self.scale)
        parts, totals = [], []
        nexp = iter(self.nexp)
        for g in self.geom:
            masks, total = subcell_masks(points, self.parent_map, g["maps"],
                                         unique=g["unique"], raw=True)
            parts.extend(m * phi[:next(nexp)] for m in masks)
            totals.append(total)
        return torch.cat(parts, dim=0), totals
