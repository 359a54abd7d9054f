"""K6: the f32 throughput engine (recurrence fused with the change of
basis), on triangles and tetrahedra.

Counterpart of ``fiat_tpu/ops/pallas_tabulate.py`` (``PallasZooTabulator``).
One pass runs

  1. K6 (``ZooF32Kernel``, ``csrc/zoo_f32.cu``): every plain zoo row, all
     derivative multi-indices stacked, as A_g @ Phi[:K_g] in float32, with
     Phi computed per point tile inside the kernel (it never reaches device
     memory) and every row written straight to its place in the output;
  2. K3 in float32 (``macro_oneshot.MacroOneShot``, its sd = 2 or sd = 3
     stage) for the macro elements, when the zoo holds them: fiat_tpu's
     ``_macro_tables``.

Points are cast to float32 on the device.  Plain FP32 FMAs throughout: no
TF32 and no tensor cores, as fiat_tpu's ``Precision.HIGHEST``.  The plain
version of K6 is the eager f32 recurrence and a per-group f32
``torch.matmul``; the wrapper runs it for CPU tensors only.  For a CUDA
tensor it launches the kernel or raises.
"""

import math

import numpy as np
import torch

from ..core.expansions import _c0_matrix, dubiner_tabulate
from .fused_zoo import _merge_macro_programs, group_by_width, pack_rows, transposed_tiles
from .kernels import check_launch, load_kernels, no_tf32, resolve_device, stream_of
from .macro_oneshot import MacroOneShot
from .recurrence import pack_stages

#: highest degree the kernel is instantiated for per spatial dimension
#: (csrc/zoo_f32.cu), as K1
MAX_DEGREE = {2: 15, 3: 10}
VARIANTS = (None, "bubble", "dual")


def tile_points(sd, degree):
    """Points of one block's Phi tile (csrc/zoo_f32.cu ``tile_points``): 256,
    or 128 on the tetrahedron from degree 9, where 256 points of Phi would
    not fit a block's shared memory."""
    return 128 if sd == 3 and degree >= 9 else 256


class ZooF32Kernel:
    """``k6 = ZooF32Kernel([A_g ...], degree, scale, affine_map, variant,
    device)``; ``k6(points, dst, out)`` writes, for every group g and row r
    of A_g, the float32 row A_g[r] @ Phi[:K_g] at ``points`` (npts, 2) into
    ``out[dst[row]]`` and returns ``out`` (rows not in ``dst`` are left as
    they were).  Phi is the degree-``degree`` Dubiner recurrence of
    ``variant`` (the bubble C0 recovery belongs in A) with ``scale`` as
    given, on the cell mapped onto the default triangle or tetrahedron by
    ``affine_map`` (points (npts, sd), sd 2 or 3).

    Rows are packed back to back, zero-padded to the widest K and cut into
    64-row tiles (K2's layout).  The kernel reads the tiles transposed
    (``At``, on the device); the packed rows ``A`` serve the plain version
    only and live where it last ran.  ``launches`` counts kernel launches
    (the plain CPU path adds nothing)."""

    #: rows of one kernel tile (csrc/zoo_f32.cu, TR)
    TILE_ROWS = 64

    def __init__(self, mats, degree, scale, affine_map, variant=None, device=None):
        Af, bf = affine_map
        self.sd = np.asarray(Af).shape[0]
        if self.sd not in MAX_DEGREE:
            raise NotImplementedError(
                f"K6 covers triangles and tetrahedra (sd = 2, 3), not sd = {self.sd}")
        self.degree = int(degree)
        if not 0 <= self.degree <= MAX_DEGREE[self.sd]:
            raise NotImplementedError(
                f"degree {degree} outside 0..{MAX_DEGREE[self.sd]} for sd = {self.sd}")
        if variant not in VARIANTS:
            raise NotImplementedError(f"expansion variant {variant!r}: K6 takes {VARIANTS}")
        self.variant = variant
        self.nexp = math.comb(self.degree + self.sd, self.sd)
        #: points of one block's Phi tile
        self.tile_points = tile_points(self.sd, self.degree)
        packed, tiles, self.K, self.group_rows, self.offsets = pack_rows(mats, self.TILE_ROWS)
        self.total_rows, self.max_k = packed.shape
        if self.max_k > self.nexp:
            raise ValueError(f"a row is {self.max_k} wide; the degree-{degree} basis has "
                             f"{self.nexp} members")
        self.scale = float(scale)
        self.affine = np.concatenate([np.asarray(Af, np.float64).ravel(),
                                      np.asarray(bf, np.float64).ravel()])
        self.device = resolve_device(device)
        # every row tile transposed, (tile, k, row), for the kernel's loads
        self.A = torch.as_tensor(packed).float()
        self.At = torch.as_tensor(transposed_tiles(packed, tiles, self.TILE_ROWS),
                                  device=self.device).float()
        self.tiles = torch.as_tensor(tiles, device=self.device)
        # shared memory of a block: the Phi tile and one transposed A tile
        self.smem = 4 * (self.nexp * self.tile_points + self.max_k * (self.TILE_ROWS + 4))
        consts, slots = pack_stages(self.degree, variant, sd=self.sd)
        self.consts = torch.as_tensor(consts, device=self.device).float()
        self.slots = torch.as_tensor(slots, device=self.device)   # read at sd = 3 only
        self.device = self.At.device       # "cuda" resolved to its index
        self.launches = 0

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
        common = (self.scale, self.degree, self.At.data_ptr(), self.max_k, self.tiles.data_ptr(),
                  self.tiles.shape[0], dst.data_ptr(), out.data_ptr(),
                  self.splits(npts, points.device))
        if self.sd == 2:
            name = "fiat_zoo_f32"
            err = lib.fiat_zoo_f32(points.data_ptr(), npts, self.consts.data_ptr(),
                                   *self.affine.tolist(), *common, stream_of(points))
        else:
            name = "fiat_zoo3_f32"
            err = lib.fiat_zoo3_f32(points.data_ptr(), npts, self.consts.data_ptr(),
                                    self.slots.data_ptr(), *self.affine.tolist(), *common,
                                    self.tile_points, stream_of(points))
        check_launch(f"{name} (degree {self.degree}, width {self.max_k})", err)
        self.launches += 1
        return out

    def splits(self, npts, device):
        """Blocks per point tile, each taking every splits-th row tile: the
        split (at most 4) whose blocks fill their last wave on the card best
        (two blocks fit an SM while their shared memory allows, as the
        kernel's launch bounds ask)."""
        ptiles = -(-npts // self.tile_points)
        per_sm = max(1, min(2, 232448 // self.smem))
        slots = per_sm * torch.cuda.get_device_properties(device).multi_processor_count

        def fill(s):
            waves = ptiles * s / slots
            return waves / np.ceil(waves)
        return max(range(1, min(4, self.tiles.shape[0]) + 1), key=lambda s: (fill(s), -s))

    def plain(self, points, dst, out):
        """The same rows in plain PyTorch, on the points' device: the eager
        f32 recurrence and one full-f32 matmul per group."""
        sd = self.sd
        Af = points.new_tensor(self.affine[:sd * sd].reshape(sd, sd))
        ref = points @ Af.T + points.new_tensor(self.affine[sd * sd:])
        phi = dubiner_tabulate(sd, self.degree, [ref[:, i] for i in range(sd)], self.scale,
                               variant=self.variant, raw=True)
        self.A = A = self.A.to(points.device)
        dst = dst.long()
        with no_tf32():
            for off, K, rows in zip(self.offsets, self.K, self.group_rows):
                out[dst[off:off + rows]] = A[off:off + rows, :K] @ phi[:K]
        return out


class F32ZooTabulator:
    """The f32 engine of a zoo of nodal elements, plain and macro
    (fiat_tpu's ``PallasZooTabulator``).

    ``tab(points)`` is the (nalpha * plain rows, npts) float32 table of the
    plain rows, alpha-major (``tab.unpack`` splits it by alpha);
    ``tab.tables(points)`` gives {alpha: (rows, npts)} float32 for the whole
    zoo in the ``BatchedTabulator`` row order (plain rows, then the macro
    elements').  ``tab.kernel`` (K6) and ``tab.macro`` (K3 in float32; None
    without macro elements) carry the launch counts.  Triangles and
    tetrahedra, plain and macro."""

    def __init__(self, batched, device=None):
        self._setup(**batched.state(), device=device)

    @classmethod
    def from_arrays(cls, *, stacked, alpha_mats, slices, max_degree, scale, affine_map,
                    plain_nexp=None, macro_programs=(), variant=None, device=None):
        """The engine from the host-built arrays of a ``BatchedTabulator``
        (``state()``, or fiat_tpu's attributes of the same names), as
        ``FusedZooTabulator.from_arrays`` takes them; ``variant`` is the
        target expansion set's (None, "bubble" or "dual").  Without
        ``plain_nexp`` (or with a variant, whose rows are not degree
        prefixes) every plain row contracts the whole basis."""
        self = cls.__new__(cls)
        self._setup(stacked=stacked, alpha_mats=alpha_mats, slices=slices,
                    max_degree=max_degree, scale=scale, affine_map=affine_map,
                    plain_nexp=plain_nexp, macro_programs=macro_programs, variant=variant,
                    device=device)
        return self

    def _setup(self, stacked, alpha_mats, slices, max_degree, scale, affine_map, plain_nexp,
               macro_programs, device, variant=None):
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
        self.macro = None
        if self._programs:
            self.macro = MacroOneShot(**_merge_macro_programs(
                self._programs, zoo_scale, affine_map, max(map(sum, self.alphas))),
                device=self.device, dtype=torch.float32)
            # K3's rows (program-major, alpha, element) in the tables
            macro_dst = []
            for p in self._programs:
                for k in range(len(self.alphas)):
                    for idx, lo, hi in sorted(p.row_slices, key=lambda s: s[1]):
                        flo, fhi, _ = self.slices[idx]
                        macro_dst.extend(k * self.rows + r for r in range(flo, fhi))
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
        if self.macro is not None:
            out.index_copy_(0, self.dst_macro, self.macro(pts))
        return {a: out[k * self.rows:(k + 1) * self.rows] for k, a in enumerate(self.alphas)}
