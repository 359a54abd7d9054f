"""K6: the f32 throughput engine (recurrence fused with the change of
basis), on intervals, triangles and tetrahedra.

Counterpart of ``fiat_tpu/ops/pallas_tabulate.py`` (``PallasZooTabulator``).
One pass runs

  1. K6 (``ZooF32Kernel``, ``csrc/zoo_f32.cu``): every plain zoo row, all
     derivative multi-indices stacked, as A_g @ Phi[:K_g] in float32, with
     Phi computed per point tile inside the kernel (it never reaches device
     memory) and every row written straight to its place in the output;
  2. K3 in float32 (``macro_oneshot.MacroOneShot``, its sd = 1, 2 or 3
     stage) for the macro elements, when the zoo holds them: fiat_tpu's
     ``_macro_tables``; one launch for each group of programs on one
     Dubiner parent (``fused_zoo.partition_macro_programs``), and a
     program on a variant parent in PyTorch (``VariantProgramF32``).

Points are cast to float32 on the device.  Plain FP32 FMAs throughout: no
TF32 and no tensor cores, as fiat_tpu's ``Precision.HIGHEST``.  The plain
version of K6 is the eager f32 recurrence and a per-group f32
``torch.matmul``; the wrapper runs it for CPU tensors only.  For a CUDA
tensor it launches the kernel or raises.
"""

import ctypes
import math

import numpy as np
import torch

from ..core.expansions import _c0_matrix, dubiner_tabulate
from .fused_zoo import (group_by_width, masked_parent, merge_group, pack_rows,
                        partition_macro_programs, unique_binning)
from .kernels import check_launch, load_kernels, no_tf32, resolve_device, stream_of
from .macro_oneshot import MacroOneShot
from .recurrence import pack_stages

#: the top of the unrolled instantiations per spatial dimension
#: (csrc/zoo_f32.cuh), as K1's; every degree past them runs the generic
#: instantiation, up to GENERIC_TOP on triangles and tetrahedra (its split of
#: the stage-1 rows between a point's two threads is a 64-bit mask)
UNROLLED_DEGREE = {1: 15, 2: 15, 3: 10}
GENERIC_TOP = 63
VARIANTS = (None, "bubble", "dual")


def k6_layout(packed, tiles, row_width, kpad, depth, tile_rows, warp_rows):
    """K6's A operand (``csrc/zoo_f32.cu``): every ``tile_rows``-row tile of
    ``pack_rows``' output transposed at its own width, the widest row it
    holds rounded up to ``depth`` (at most ``kpad``; the padding is exact
    zeros), tile after tile, so that any run of a tile's rows of k is one
    contiguous copy.  Returns (At float32 (sum of the widths, tile_rows),
    the tile table int32 (ntiles, 4 + tile_rows / warp_rows) = (first row,
    rows, width, first row of At, then the width of each ``warp_rows``-row
    slab, its widest row in ``row_width`` rounded up alike, 0 past the
    tile's rows))."""
    def even(k):
        return min(kpad, -(-int(k) // depth) * depth)

    width = [even(k) for _, _, k in tiles]
    first = np.concatenate([[0], np.cumsum(width)]).astype(int)
    padded = np.zeros((packed.shape[0], kpad))
    padded[:, :packed.shape[1]] = packed
    At = np.zeros((first[-1], tile_rows), np.float32)
    table = []
    for (r0, n, _), w, f in zip(tiles, width, first):
        At[f:f + w, :n] = padded[r0:r0 + n, :w].T
        slabs = [even(row_width[r0 + s:r0 + min(n, s + warp_rows)].max()) if s < n else 0
                 for s in range(0, tile_rows, warp_rows)]
        table.append((r0, n, w, f, *slabs))
    return At, np.asarray(table, np.int32).reshape(-1, 4 + tile_rows // warp_rows)


class ZooF32Kernel:
    """``k6 = ZooF32Kernel([A_g ...], degree, scale, affine_map, variant,
    device)``; ``k6(points, dst, out)`` writes, for every group g and row r
    of A_g, the float32 row A_g[r] @ Phi[:K_g] at ``points`` (npts, 2) into
    ``out[dst[row]]`` and returns ``out`` (rows not in ``dst`` are left as
    they were).  Phi is the degree-``degree`` Dubiner recurrence of
    ``variant`` (the bubble C0 recovery belongs in A) with ``scale`` as
    given, on the cell mapped onto the default interval, triangle or
    tetrahedron by ``affine_map`` (points (npts, sd), sd 1, 2 or 3).

    Rows are packed back to back, zero-padded to the widest K (``max_k``)
    and cut into 128-row tiles (K2's ``pack_rows``); the kernel reads the
    tiles transposed at their own widths (``At`` and the table ``tiles``,
    with each warp slab's width, ``k6_layout``, on the device); the packed
    rows ``A`` serve the plain version only and live where it last ran.
    ``plan`` is the kernel's (point tile, A rows of a chunk, chunks in the
    ring, blocks an SM), ``plan_for``'s choice.  ``mode`` is "fused" where
    a block's shared memory takes the Phi tile beside a ring of A chunks
    (up to 842 rows at 64 points), else "wide" (``csrc/zoo_f32_wide.cu``):
    K6's recurrence writes Phi to device memory (``phi_launches``), then a
    product streams it in k beside A, one block a (point tile, row tile),
    the grid in groups of ``group`` row tiles (``wide_plan``).
    ``launches`` counts the product's launches, of either mode (the plain
    CPU path adds nothing)."""

    #: rows of one kernel tile and of a warp's (csrc/zoo_f32.cuh, TR,
    #: WARP_ROWS: a warp holds 32 rows x 64 points, a lane 8 x 8)
    TILE_ROWS, WARP_ROWS = 128, 32
    #: k-steps of one turn of the product loop: widths, the Phi tile and the
    #: chunks are multiples of it
    DEPTH = 2
    #: the most A chunks in the ring and the fewest, and the fewest A rows
    #: worth a chunk
    STAGES, MIN_STAGES, KC_MIN = 4, 2, 16
    #: point tiles, widest first (a block has 4 warps along the rows of a
    #: tile, tp / 64 along the points: two threads a point)
    POINT_TILES = (128, 64)
    #: the fewest blocks an SM (one's recurrence beside another's products),
    #: the threads an SM the launch bounds leave registers for, and the most
    #: row tiles for which the narrowest point tile is preferred
    MIN_BLOCKS, THREADS_SM, FEW_TILES = 2, 512, 2
    #: shared memory a block may take on sm_90, an SM's, what the SM keeps
    #: for each resident block, and the unit it allocates a block's in
    SMEM_MAX, SMEM_SM, SMEM_BLOCK, SMEM_UNIT = 232448, 233472, 1024, 128
    #: the wide mode: its point tile, the chunks in its ring, the blocks an
    #: SM holds, and the bytes of A a group of row tiles keeps in L2
    WIDE_TP, WIDE_STAGES, WIDE_BLOCKS, WIDE_L2 = 128, 3, 2, 16 << 20

    def __init__(self, mats, degree, scale, affine_map, variant=None, device=None):
        Af, bf = affine_map
        self.sd = np.asarray(Af).shape[0]
        if self.sd not in UNROLLED_DEGREE:
            raise NotImplementedError(
                f"K6 covers intervals, triangles and tetrahedra (sd = 1, 2, 3), not "
                f"sd = {self.sd}")
        self.degree = int(degree)
        if self.degree < 0:
            raise ValueError(f"degree {degree} is negative")
        if self.sd > 1 and self.degree > GENERIC_TOP:
            raise NotImplementedError(
                f"K6: degree {degree} past {GENERIC_TOP} for sd = {self.sd} (the generic "
                "instantiation splits a point's stage-1 rows by a 64-bit mask)")
        #: whether the degree runs the generic instantiation
        self.generic = self.degree > UNROLLED_DEGREE[self.sd]
        if variant not in VARIANTS:
            raise NotImplementedError(f"expansion variant {variant!r}: K6 takes {VARIANTS}")
        self.variant = variant
        self.nexp = math.comb(self.degree + self.sd, self.sd)
        packed, tiles, self.K, self.group_rows, self.offsets = pack_rows(mats, self.TILE_ROWS)
        self.total_rows, self.max_k = packed.shape
        if self.max_k > self.nexp:
            raise ValueError(f"a row is {self.max_k} wide; the degree-{degree} basis has "
                             f"{self.nexp} members")
        self.kpad = -(-self.max_k // self.DEPTH) * self.DEPTH
        self.scale = float(scale)
        self.affine = np.concatenate([np.asarray(Af, np.float64).ravel(),
                                      np.asarray(bf, np.float64).ravel()])
        self.device = resolve_device(device)
        self.A = torch.as_tensor(packed).float()
        At, table = k6_layout(packed, tiles, np.repeat(self.K, self.group_rows), self.kpad,
                              self.DEPTH, self.TILE_ROWS, self.WARP_ROWS)
        self.plan = self.plan_for(self.kpad, len(table))
        self.mode, self.group = "fused", None
        if self.plan is None:
            self.mode = "wide"
            self.plan, self.group = self.wide_plan(self.kpad)
        self.At = torch.as_tensor(At, device=self.device)
        self.tiles = torch.as_tensor(table, device=self.device)
        consts, slots = pack_stages(self.degree, variant, sd=self.sd)
        self.consts = torch.as_tensor(consts, device=self.device).float()
        self.slots = torch.as_tensor(slots, device=self.device)   # read at sd = 3 only
        self.device = self.At.device       # "cuda" resolved to its index
        self.launches = self.phi_launches = 0

    @classmethod
    def wide_smem_bytes(cls, kc, stages):
        """Shared memory of a wide product block: the ring of ``stages`` (A
        chunk, Phi slab) pairs of ``kc`` rows (``stream_smem_bytes``)."""
        return 4 * stages * kc * (cls.TILE_ROWS + cls.WIDE_TP)

    @classmethod
    def wide_plan(cls, kpad):
        """The wide mode's ((point tile, chunk rows, chunks in the ring,
        blocks an SM), row tiles a group) for a Phi of ``kpad`` rows: the
        widest chunk, a multiple of DEPTH up to kpad, whose ring of
        WIDE_STAGES fits WIDE_BLOCKS blocks an SM, and groups of row tiles
        whose A takes about WIDE_L2 bytes."""
        budget = ((cls.SMEM_SM // cls.WIDE_BLOCKS - cls.SMEM_BLOCK)
                  // cls.SMEM_UNIT * cls.SMEM_UNIT)
        row = 4 * cls.WIDE_STAGES * (cls.TILE_ROWS + cls.WIDE_TP)
        kc = min(kpad, budget // row // cls.DEPTH * cls.DEPTH)
        group = max(1, cls.WIDE_L2 // (4 * kpad * cls.TILE_ROWS))
        return (cls.WIDE_TP, kc, cls.WIDE_STAGES, cls.WIDE_BLOCKS), group

    @classmethod
    def threads(cls, tp):
        """Threads of a block of ``tp`` points (``threads_of``)."""
        return cls.TILE_ROWS // cls.WARP_ROWS * tp // 2

    @classmethod
    def smem_bytes(cls, kpad, tp, kc, stages):
        """Shared memory of a block: the Phi tile, a ring of ``stages`` A
        chunks, and the ring's two mbarriers and counter a buffer
        (``smem_bytes``)."""
        return 4 * (kpad * tp + stages * kc * cls.TILE_ROWS) + 8 * 3 * cls.STAGES

    @classmethod
    def fit(cls, kpad, tp, blocks):
        """(tp, A chunk rows, chunks in the ring, blocks) with the widest
        chunk, a multiple of DEPTH up to kpad, that MIN_STAGES of leave room
        for beside the Phi tile in the shared memory of
        ``blocks`` blocks an SM, and as many of those chunks as fit, up to
        STAGES; None past the launch bounds' registers or if that chunk is
        under ``min(kpad, KC_MIN)`` rows."""
        if blocks * cls.threads(tp) > cls.THREADS_SM:
            return None
        chunk = 4 * cls.TILE_ROWS                 # bytes of one row of k in a chunk
        budget = min(cls.SMEM_MAX, (cls.SMEM_SM // blocks - cls.SMEM_BLOCK)
                     // cls.SMEM_UNIT * cls.SMEM_UNIT)
        free = budget - cls.smem_bytes(kpad, tp, 0, 0)
        kc = min(kpad, max(0, free) // (cls.MIN_STAGES * chunk) // cls.DEPTH * cls.DEPTH)
        if kc < min(kpad, cls.KC_MIN):
            return None
        return tp, kc, min(cls.STAGES, free // (kc * chunk)), blocks

    @classmethod
    def candidates(cls, kpad):
        """Every plan ``fit`` takes for a Phi tile of ``kpad`` rows: each
        point tile at each count of blocks an SM from the most the launch
        bounds allow down to MIN_BLOCKS; where none fits, each point tile
        at one block an SM (a Phi tile past 386 rows: the high degrees of
        the generic instantiation, tet degree 14's 680 rows at 64 points)."""
        plans = [plan for tp in cls.POINT_TILES
                 for blocks in range(cls.THREADS_SM // cls.threads(tp), cls.MIN_BLOCKS - 1, -1)
                 if (plan := cls.fit(kpad, tp, blocks)) is not None]
        return plans or [plan for tp in cls.POINT_TILES if (plan := cls.fit(kpad, tp, 1))]

    @classmethod
    def plan_for(cls, kpad, ntiles):
        """(point tile, A chunk rows, chunks in the ring, blocks an SM) for a
        Phi tile of ``kpad`` rows and ``ntiles`` row tiles: of the
        ``candidates``, the one that keeps most threads an SM, then the
        widest point tile (fewer reads of A) or, for at most FEW_TILES row
        tiles, the narrowest (more, shorter blocks, whose set-up weighs most
        when a block walks few tiles), then the widest chunk and the deepest
        ring.  None if no point tile fits even one block an SM."""
        sign = -1 if ntiles <= cls.FEW_TILES else 1
        return max(cls.candidates(kpad),
                   key=lambda p: (cls.threads(p[0]) * p[3], sign * p[0], p[1], p[2]), default=None)

    @property
    def smem(self):
        """Shared memory of one of the plan's blocks, in bytes."""
        tp, kc, stages, _ = self.plan
        if self.mode == "wide":
            return self.wide_smem_bytes(kc, stages)
        return self.smem_bytes(self.kpad, tp, kc, stages)

    def _check(self, points, dst, out):
        if not isinstance(points, torch.Tensor):
            raise TypeError("points must be a torch.Tensor")
        if points.dtype != torch.float32:
            raise TypeError(f"points must be float32, got {points.dtype}")
        if points.dim() != 2 or points.shape[1] != self.sd:
            raise ValueError(f"points must have shape (npts, {self.sd}), got "
                             f"{tuple(points.shape)}")
        if not points.is_contiguous():
            raise ValueError("points must be contiguous")
        if points.shape[0] >= 2 ** 31:
            raise ValueError("too many points for one launch")
        if dst.dtype != torch.int32 or tuple(dst.shape) != (self.total_rows,):
            raise ValueError(f"dst must be int32 of shape ({self.total_rows},)")
        if (out.dtype != torch.float32 or out.dim() != 2 or out.shape[1] != points.shape[0]
                or not out.is_contiguous()):
            raise ValueError(f"out must be contiguous float32 (rows, {points.shape[0]})")
        if dst.device != points.device or out.device != points.device:
            raise ValueError("points, dst and out must share a device")

    def __call__(self, points, dst, out):
        self._check(points, dst, out)
        if points.device.type == "cpu":
            return self.plain(points, dst, out)
        if points.device.type != "cuda" or points.device != self.device:
            raise ValueError(f"points on {points.device}, engine on {self.device}")
        npts = points.shape[0]
        if npts == 0:
            return out
        lib = load_kernels()
        if self.mode == "wide":
            return self._wide(lib, points, dst, out)
        tp, kc, stages, blocks = self.plan
        affine = (ctypes.c_float * 12)(*self.affine)
        err = lib.fiat_zoo_f32(points.data_ptr(), npts, self.sd, self.consts.data_ptr(),
                               self.slots.data_ptr(), affine, self.scale, self.degree,
                               self.At.data_ptr(), self.kpad, self.max_k, self.tiles.data_ptr(),
                               self.tiles.shape[0], dst.data_ptr(), out.data_ptr(), tp, kc,
                               stages, blocks, stream_of(points))
        check_launch(f"fiat_zoo_f32 (sd {self.sd}, degree {self.degree}, width {self.max_k}, "
                     f"plan {self.plan})", err)
        self.launches += 1
        return out

    def phi_stage(self, points):
        """The wide mode's first launch on float32 ``points`` on the card:
        Phi (kpad, the points rounded up to the point tile) float32 from
        K6's recurrence, each pair of points' columns swapped (point p in
        column p ^ 1), rows past ``max_k`` zero."""
        tp = self.plan[0]
        npts = points.shape[0]
        ld = -(-npts // tp) * tp
        phi = torch.empty((self.kpad, ld), dtype=torch.float32, device=points.device)
        affine = (ctypes.c_float * 12)(*self.affine)
        err = load_kernels().fiat_zoo_f32_phi(
            points.data_ptr(), npts, self.sd, self.consts.data_ptr(), self.slots.data_ptr(),
            affine, self.scale, self.degree, self.kpad, self.max_k, phi.data_ptr(), ld,
            stream_of(points))
        check_launch(f"fiat_zoo_f32_phi (sd {self.sd}, degree {self.degree}, {self.kpad} rows)",
                     err)
        self.phi_launches += 1
        return phi

    def _wide(self, lib, points, dst, out):
        """The wide mode's two launches: ``phi_stage``, then the product."""
        tp, kc, stages, _ = self.plan
        npts, ntiles = points.shape[0], self.tiles.shape[0]
        if -(-npts // tp) * ntiles >= 2 ** 31:
            raise ValueError(f"{npts} points x {ntiles} row tiles: too many blocks for one "
                             "launch")
        phi = self.phi_stage(points)
        err = lib.fiat_zoo_f32_stream(self.At.data_ptr(), self.kpad, self.max_k,
                                      self.tiles.data_ptr(), ntiles, phi.data_ptr(),
                                      phi.shape[1], npts, dst.data_ptr(), out.data_ptr(), kc,
                                      stages, self.group, stream_of(points))
        check_launch(f"fiat_zoo_f32_stream (width {self.max_k}, plan {self.plan}, group "
                     f"{self.group})", err)
        self.launches += 1
        return out

    def occupancy(self):
        """Blocks of the plan an SM holds at once on the card (registers and
        shared memory), from the CUDA runtime."""
        if self.mode == "wide":
            blocks = load_kernels().fiat_zoo_f32_stream_occupancy(*self.plan[1:3])
        else:
            blocks = load_kernels().fiat_zoo_f32_occupancy(self.sd, self.degree, self.kpad,
                                                           self.max_k, *self.plan)
        check_launch("fiat_zoo_f32_occupancy", max(0, -blocks))
        return blocks

    def phi(self, points):
        """The plain Phi (nexp, npts) at ``points``, on their device: the
        eager f32 recurrence on the default simplex."""
        sd = self.sd
        Af = points.new_tensor(self.affine[:sd * sd].reshape(sd, sd))
        ref = points @ Af.T + points.new_tensor(self.affine[sd * sd:])
        return dubiner_tabulate(sd, self.degree, [ref[:, i] for i in range(sd)], self.scale,
                                variant=self.variant, raw=True)

    def product(self, phi, dst, out):
        """``out[dst[row]] = A_g[r] @ phi[:K_g]`` for every packed row, one
        full-f32 matmul per group, on phi's device."""
        self.A = A = self.A.to(phi.device)
        dst = dst.long()
        with no_tf32():
            for off, K, rows in zip(self.offsets, self.K, self.group_rows):
                out[dst[off:off + rows]] = A[off:off + rows, :K] @ phi[:K]
        return out

    def plain(self, points, dst, out):
        """The same rows in plain PyTorch, on the points' device: the eager
        f32 recurrence and one full-f32 matmul per group."""
        return self.product(self.phi(points), dst, out)


class VariantProgramF32:
    """A macro program on a variant parent in the f32 engine: its masked
    parent in float32 by PyTorch, times its ``tall`` matrix in full float32
    (no TF32), the multiplicity averaged: fiat_tpu's ``_macro_tables``, an
    XLA product there too."""

    name = "torch"

    def __init__(self, program, order, device):
        self.program, self.unique = program, unique_binning(program, order)
        self.tall = torch.as_tensor(program.tall, dtype=torch.float32, device=device)

    def __call__(self, points):
        with no_tf32():
            return self.tall @ masked_parent(self.program, points, self.unique)


class F32ZooTabulator:
    """The f32 engine of a zoo of nodal elements, plain and macro
    (fiat_tpu's ``PallasZooTabulator``).

    ``tab(points)`` is the (nalpha * plain rows, npts) float32 table of the
    plain rows, alpha-major (``tab.unpack`` splits it by alpha);
    ``tab.tables(points)`` gives {alpha: (rows, npts)} float32 for the whole
    zoo in the ``BatchedTabulator`` row order (plain rows, then the macro
    elements').  ``tab.kernel`` (K6) carries its launch counts;
    ``tab.macro_routes`` lists every route of the macro programs (K3 in
    float32, ``MacroOneShot``, for a group on one Dubiner parent, the one
    on the zoo's basis first; ``VariantProgramF32`` for a program on a
    variant parent).  Intervals, triangles and tetrahedra, plain and
    macro."""

    def __init__(self, batched, device=None):
        self._setup(**batched.state(), order=batched.order, device=device)

    @classmethod
    def from_arrays(cls, *, stacked, alpha_mats, slices, max_degree, scale, affine_map,
                    plain_nexp=None, macro_programs=(), variant=None, device=None, order=None):
        """The engine from the host-built arrays of a ``BatchedTabulator``
        (``state()``, or fiat_tpu's attributes of the same names), as
        ``FusedZooTabulator.from_arrays`` takes them; ``variant`` is the
        target expansion set's (None, "bubble" or "dual").  Without
        ``plain_nexp`` (or with a variant, whose rows are not degree
        prefixes) every plain row contracts the whole basis.  ``order`` as
        ``FusedZooTabulator.from_arrays`` takes it."""
        self = cls.__new__(cls)
        self._setup(stacked=stacked, alpha_mats=alpha_mats, slices=slices,
                    max_degree=max_degree, scale=scale, affine_map=affine_map,
                    plain_nexp=plain_nexp, macro_programs=macro_programs, variant=variant,
                    device=device, order=order)
        return self

    def _setup(self, stacked, alpha_mats, slices, max_degree, scale, affine_map, plain_nexp,
               macro_programs, device, variant=None, order=None):
        self.device = resolve_device(device)
        self.sd = np.asarray(affine_map[0]).shape[0]
        if variant not in VARIANTS:
            raise NotImplementedError(f"expansion variant {variant!r}: K6 takes {VARIANTS}")
        stacked = np.asarray(stacked, np.float64)
        mats = {a: np.asarray(M, np.float64)
                for a, M in (dict(alpha_mats) or {(0,) * self.sd: stacked}).items()}
        self.alphas = list(mats)
        self.slices = [(int(lo), int(hi), tuple(shape)) for lo, hi, shape in slices]
        self.rows = max(hi for _, hi, _ in self.slices)
        self.plain_rows, nexp = stacked.shape
        self._programs = list(macro_programs)
        special = {int(idx) for p in self._programs for idx, _, _ in p.row_slices}
        zoo_scale = float(scale)
        if variant == "bubble":
            # fold the C0 recovery (phi_C0 = C0 @ phi_bubble) into the change
            # of basis, and run the recurrence with the negated scale
            c0 = _c0_matrix(self.sd, max_degree)
            mats = {a: M @ c0 for a, M in mats.items()}
            scale = -float(scale)
        if plain_nexp is None or variant is not None:
            plain_nexp = {i: nexp for i in range(len(self.slices)) if i not in special}
        _, group_mats, _, _, src = group_by_width(mats, self.alphas, self.slices, plain_nexp)
        self.kernel = ZooF32Kernel(group_mats, max_degree, scale, affine_map, variant,
                                   self.device)
        self.device = self.kernel.device        # "cuda" resolved to its index

        def rows_t(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

        # every packed row's output row: alpha-major plain rows (``__call__``)
        # and the flattened (nalpha, rows) tables (``tables``)
        self.dst_plain = rows_t(src[:, 0] * self.plain_rows + src[:, 1])
        self.dst_tables = rows_t(src[:, 0] * self.rows + src[:, 1])
        # the macro programs by route (``fused_zoo.partition_macro_programs``):
        # K3 in float32 for each group on one Dubiner parent, PyTorch in
        # float32 for a program on a variant parent (fiat_tpu's
        # ``_macro_tables`` runs every program so, in XLA)
        order = max(map(sum, self.alphas)) if order is None else order
        self.macro_routes = []
        macro_dst = []
        for kind, members, _ in partition_macro_programs(self._programs, zoo_scale,
                                                         affine_map):
            progs = [self._programs[g] for g in members]
            if kind == "merged":
                engine = MacroOneShot(**merge_group(progs, order), device=self.device,
                                      dtype=torch.float32)
            else:
                engine = VariantProgramF32(progs[0], order, self.device)
            self.macro_routes.append(engine)
            # the route's rows (program-major, alpha, element) in the tables
            for p in progs:
                for k in range(len(self.alphas)):
                    for idx, lo, hi in sorted(p.row_slices, key=lambda s: s[1]):
                        flo, fhi, _ = self.slices[idx]
                        macro_dst.extend(k * self.rows + r for r in range(flo, fhi))
        if self.macro_routes:
            self.dst_macro = torch.as_tensor(macro_dst, device=self.device)

    def _points(self, points):
        """float32 points on the engine's device (host data are moved there,
        a tensor must already be there), cast on the device."""
        if isinstance(points, torch.Tensor) and points.device != self.device:
            raise ValueError(f"points on {points.device}, engine on {self.device}")
        pts = torch.as_tensor(points, device=self.device).to(torch.float32).contiguous()
        if pts.dim() != 2 or pts.shape[1] != self.sd:
            raise ValueError(f"points must have shape (npts, {self.sd}), got {tuple(pts.shape)}")
        return pts

    def __call__(self, points):
        """(nalpha * plain rows, npts) float32, alpha-major, zoo row order."""
        pts = self._points(points)
        out = torch.empty((len(self.alphas) * self.plain_rows, pts.shape[0]),
                          dtype=torch.float32, device=self.device)
        return self.kernel(pts, self.dst_plain, out)

    def unpack(self, out):
        """{alpha: (plain rows, npts)} views of ``__call__``'s output."""
        r = self.plain_rows
        return {a: out[k * r:(k + 1) * r] for k, a in enumerate(self.alphas)}

    def tables(self, points):
        """{alpha: (rows, npts)} float32 for the whole zoo, in the
        ``BatchedTabulator`` row order: K6 writes the plain rows in place,
        K3's macro rows are copied in."""
        pts = self._points(points)
        out = torch.empty((len(self.alphas) * self.rows, pts.shape[0]),
                          dtype=torch.float32, device=self.device)
        self.kernel(pts, self.dst_tables, out)
        if self.macro_routes:
            macro = [route(pts) for route in self.macro_routes]
            out.index_copy_(0, self.dst_macro, macro[0] if len(macro) == 1 else torch.cat(macro))
        return {a: out[k * self.rows:(k + 1) * self.rows] for k, a in enumerate(self.alphas)}
