"""K3: the macro (split-complex) elements of a zoo in one CUDA launch, on
triangles and tetrahedra.

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
as K7's does, so A has no size limit; each point multiplies only the
subcells it falls in, and keeps its parent basis in its own column of a
shared-memory Phi tile (the kernel's source note says why).  A point is
binned against each chunk's program alone, so a zoo may have any number of
subcells (at most ``MAX_PROGRAM_PIECES`` a program).  One row per program
(interpolation) runs an instantiation whose chunks are one row high.

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

#: highest parent degree the kernel is instantiated for (csrc/macro_oneshot.cu)
MAX_DEGREE = 10
#: subcells of one program: the kernels (K3, K7, K45) bin a point program by
#: program and keep a program's masks as the bits of one word; a zoo may
#: have any number of programs
MAX_PROGRAM_PIECES = 32
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
#: points of one block of K3, each with a column of the Phi tile
#: (csrc/macro_oneshot.cu THREADS)
TILE_POINTS = 128
#: point tiles one block of K3 may walk (csrc/macro_oneshot.cu MAX_SUB), and
#: the blocks a launch keeps at least, where it can: about eight an SM on
#: the H100's 132 SMs (of 256 to 8192, 1024 timed best on the H100 on the
#: C1 zoos and full_zoo)
MAX_SUB = 8
MIN_BLOCKS = 1024


def column_stride(rows):
    """Values per staged column of a chunk ``rows`` high
    (csrc/macro_oneshot.cu ``column_stride``): ``rows + 2`` (even, so
    16-byte pairs stay aligned), or 1 for one-row chunks."""
    return rows + 2 if rows > 1 else 1


def tiles_per_block(npts, nchunks):
    """Point tiles each block of K3 walks with its staged chunk: as many as
    keep ``MIN_BLOCKS`` blocks in the grid, 1 to ``MAX_SUB``.  Fewer tiles a
    block stage the chunk more often; more leave SMs idle at the tail."""
    tiles = -(-npts // TILE_POINTS)
    return max(1, min(MAX_SUB, tiles * nchunks // MIN_BLOCKS))


def pack_geometry(geom, parent_map, nexp):
    """The binning tables of ``csrc/binning.cuh`` (float64 numpy/int32) on
    triangles or tetrahedra (sd = 2, 3): ``maps`` (1 + pieces, sd + 1, sd +
    1), the parent's rescaled barycentric map first, then every subcell's,
    each row (a_0, ..., a_{sd-1}, b); ``progs`` (programs, 5) = (first row,
    end row, first piece, end piece, unique) from ``geom`` (per program
    {"maps", "unique", "rows"}); ``pieces`` (pieces, 2) = (first column,
    nexp) from the per-piece widths ``nexp``."""
    parent_map = tuple(np.asarray(v, np.float64) for v in parent_map)
    sd = parent_map[0].shape[1]
    if sd not in (2, 3) or parent_map[0].shape != (sd + 1, sd):
        raise NotImplementedError(f"the macro kernels bin on triangles and tetrahedra, "
                                  f"not a parent map of shape {parent_map[0].shape}")
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
    """Every program's rows cut into chunks of at most ``rows``, as K3
    stages them: (chunks int32 (nchunks, 4) = (program, first row, rows,
    ps), the largest chunk's staged values).  The kernel stages piece j of
    the chunk's program ps * j columns in (ps is the program's widest piece
    rounded up to odd, so lanes in up to 8 subcells read distinct banks),
    each column ``column_stride(rows)`` values.  K7 cuts its rows into the
    same chunks (``masked_matmul.chunk_layout``, which lays them out by
    k)."""
    chunks, largest = [], 0
    for g, (r0, r1, c0, c1, _) in enumerate(progs):
        ps = int(pieces[c0:c1, 1].max()) | 1
        chunks.extend((g, row, min(rows, r1 - row), ps) for row in range(r0, r1, rows))
        largest = max(largest, (c1 - c0) * ps * column_stride(rows))
    return np.asarray(chunks, np.int32).reshape(-1, 4), largest


def group_staged(chunks, progs, rows, cpb):
    """Staged values of the largest group of ``cpb`` consecutive chunks of
    ``chunk_table(progs, pieces, rows)``, rounded up to even: where the Phi
    tile starts in a block's shared memory."""
    sizes = [int(progs[g, 3] - progs[g, 2]) * int(ps) * column_stride(rows)
             for g, _, _, ps in chunks]
    largest = max(sum(sizes[i:i + cpb]) for i in range(0, len(sizes), cpb))
    return largest + largest % 2


def one_shot_applies(merged):
    """Whether K3 is the f64 engine's kernel for the merged macro programs
    (``fused_zoo._merge_macro_programs``' output): at most
    ``ONE_SHOT_PIECES`` subcells in all, a parent degree of at most
    ``MAX_DEGREE``, and a triangle parent.  K3 takes any number of
    subcells, but past those the f64 tables take K7, which reads the zoo's
    Phi from K1 instead of running the recurrence again; on a tetrahedral
    parent K3's sd = 3 stage runs the f32 tables and interpolation, and the
    f64 tables take K7, which the H100 measured faster on ``sv_macro_tet``
    (PERF.md §6)."""
    return (np.asarray(merged["parent_map"][0]).shape == (3, 2)
            and len(merged["pieces"]) <= ONE_SHOT_PIECES
            and 0 <= merged["degree"] <= MAX_DEGREE)


class MacroOneShot:
    """``mo = MacroOneShot(A, pieces, geom, parent_map, degree, scale,
    affine_map, device, dtype)``; ``out = mo(points)`` is the (rows, npts)
    table of every macro program at ``points`` (npts, sd), sd 2 or 3 as
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
        if not 0 <= self.degree <= MAX_DEGREE:
            raise NotImplementedError(f"macro parent degree {degree} outside 0..{MAX_DEGREE}: "
                                      f"K3 is instantiated for degrees 0..{MAX_DEGREE}")
        self.geom = [dict(g, maps=[(np.asarray(Am, np.float64), np.asarray(bm, np.float64))
                                   for Am, bm in g["maps"]]) for g in geom]
        self.parent_map = tuple(np.asarray(v, np.float64) for v in parent_map)
        self.nexp = [int(n) for _, n in pieces]
        maps, progs, pieces_t = pack_geometry(self.geom, self.parent_map, self.nexp)
        widest = int((progs[:, 3] - progs[:, 2]).max())
        if widest > MAX_PROGRAM_PIECES:
            raise NotImplementedError(f"a program of {widest} subcells: K3 takes at most "
                                      f"{MAX_PROGRAM_PIECES} a program")
        self.sd = sd = self.parent_map[0].shape[1]
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
        # the row chunks of the tables and, for ``mo(points, A=W)``, one row
        # per program; shared memory of a block in each mode (values): its
        # staged chunks (rounded up to even), then the Phi tile.  A mode
        # whose block does not fit raises at its launch on the card; the
        # plain version has no such limit
        one = progs.copy()
        one[:, 0], one[:, 1] = np.arange(len(progs)), np.arange(1, len(progs) + 1)
        chunks = chunk_table(progs, pieces_t)[0]
        chunks_one = chunk_table(one, pieces_t, ONE_ROW_CHUNK)[0]
        # a block of the tables takes one chunk; one of the one-row chunks
        # takes every program's (fewer values than the largest chunk of 32
        # rows), so the recurrence runs once a point
        self.cpb, self.cpb_one = 1, len(chunks_one)
        self.phi_at = group_staged(chunks, progs, CHUNK_ROWS, self.cpb)
        self.phi_at_one = group_staged(chunks_one, progs, ONE_ROW_CHUNK, self.cpb_one)
        tile = math.comb(self.degree + sd, sd) * TILE_POINTS
        self.smem, self.smem_one = self.phi_at + tile, self.phi_at_one + tile
        self.chunks = as_t(chunks, torch.int32)
        self.chunks_one = as_t(chunks_one, torch.int32)
        self.device = self.A.device       # "cuda" resolved to its index
        self.launches = 0

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
        output.  Raises where a block of this mode (the tables, or one row
        per program) is past the card's shared memory, or the grid has too
        many blocks along the chunks."""
        one = A is not None
        chunks, rc, cpb, phi_at, smem = (
            (self.chunks_one, ONE_ROW_CHUNK, self.cpb_one, self.phi_at_one, self.smem_one) if one
            else (self.chunks, CHUNK_ROWS, self.cpb, self.phi_at, self.smem))
        nbytes = smem * self.A.element_size()
        if nbytes > MAX_SMEM:
            raise NotImplementedError(
                f"K3 {'one row a program' if one else 'tables'}: a block's row chunks and Phi "
                f"tile take {nbytes} bytes, past the {MAX_SMEM} bytes of shared memory a block")
        groups = -(-chunks.shape[0] // cpb)
        if groups > 65535:
            raise NotImplementedError(f"{groups} blocks of row chunks: K3's grid takes at most "
                                      f"65535")
        A = A if one else self.A
        npts = points.shape[0]
        out = torch.empty((A.shape[0], npts), dtype=self.dtype, device=points.device)
        if npts == 0:
            return out
        f64 = self.dtype == torch.float64
        fn = getattr(load_kernels(), "fiat_macro_oneshot" if f64 else "fiat_macro_oneshot_f32")
        affine = ((ctypes.c_double if f64 else ctypes.c_float) * 12)(*self.affine)
        err = fn(points.data_ptr(), npts, self.sd, self.consts.data_ptr(), self.slots.data_ptr(),
                 affine, self.scale, self.tol, self.degree, self.maps.data_ptr(),
                 self.progs.data_ptr(), self.pieces.data_ptr(), chunks.data_ptr(),
                 chunks.shape[0], rc, cpb, tiles_per_block(npts, groups), phi_at, A.data_ptr(),
                 self.K, out.data_ptr(), stream_of(points))
        check_launch(f"K3 ({A.shape[0]} x {self.K}, {self.dtype})", err)
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
