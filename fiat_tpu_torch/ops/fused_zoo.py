"""The fused zoo engine: K1 recurrence (or K8 Bernstein features) + K2
bucketed change of basis + K3 or K7 for the macro elements.

Counterpart of ``fiat_tpu/ops/pallas_multiword.py`` (``FusedZooTabulator``
over ``FusedMultiwordMatmul`` and ``FusedMacroOneShot``).  One pass runs

  1. K1 (``recurrence.DubinerRecurrence``): Phi (nexp, npts) in f64, on
     intervals, triangles and tetrahedra; or, with ``features="bernstein"`` on a zoo
     of one contraction width and no macro elements, K8
     (``bernstein.BernsteinFeatures``): the Bernstein features, with the
     Dubiner <- Bernstein conversion folded into K2's rows on the host;
  2. K2 (``BucketMatmul``, ``csrc/bucket_matmul.cu``): for every group of
     zoo rows sharing a contraction width K_g (a degree-d element only
     touches the degree-d morton prefix of the basis), the alpha-stacked
     change-of-basis rows A_g times Phi[:K_g], all groups in one launch;
  3. when the zoo holds macro elements, the merged tables of every macro
     program (subcell binning, masked change of basis, multiplicity average)
     in one launch: K3 (``macro_oneshot.MacroOneShot``,
     ``csrc/macro_oneshot.cu``, with its own parent recurrence) where
     ``macro_oneshot.one_shot_applies`` (an interval parent, always, as
     fiat_tpu's one-shot route; a triangle parent, at most 32 subcells in
     all, parent degree at most 10: a measured routing rule, not a cap;
     both kernels take programs of any number of subcells), else
     K7
     (``masked_matmul.MaskedMatmul``, ``csrc/masked_matmul.cu``), which
     reads the parent basis as a prefix of K1's Phi; K1 then runs at the
     larger of the plain and macro degrees.  Macro programs that do not
     share the zoo's parent basis take fiat_tpu's per-program fallback
     (``macro_fms``) by route (``partition_macro_programs``): a K3 or K7
     launch for each group of programs on one Dubiner parent (a K7 group
     off the zoo's basis with a K1 of its own), and for a program on a
     variant parent its masked parent in PyTorch times its tall matrix on
     K2.

The TPU engine reaches f64 on the bf16 MXU through df32 pairs, Ozaki
windows and TwoSum combines; Hopper has native FP64, so no kernel carries
any of that, and the pair surfaces (``pair_blocks``,
``unpack_pairs``, ``pair_tables``) collapse into the f64 blocks here.

The plain version of K2 is a per-group ``torch.matmul`` in f64; the
wrapper runs it for CPU tensors only.  For a CUDA tensor it launches the
kernel or raises.
"""

import numpy as np
import torch

from ..core.expansions import dubiner_tabulate, partition_of_unity_masks
from .bernstein import BernsteinFeatures, bernstein_operand
from .kernels import check_launch, load_kernels, resolve_device, stream_of
from .macro_oneshot import MacroOneShot, one_shot_applies
from .masked_matmul import MaskedMatmul
from .recurrence import DubinerRecurrence


def pack_rows(mats, tile_rows):
    """The rows of every group matrix back to back, zero-padded to the
    widest K, and cut into ``tile_rows``-row tiles, each contracting to the
    widest row it holds (the padding is exact zeros): (packed (rows, max
    K), tiles int32 (ntiles, 3) = (first row, rows, K), K per group, rows
    per group, first row per group plus the total)."""
    K = [int(M.shape[1]) for M in mats]
    rows = [int(M.shape[0]) for M in mats]
    offsets = np.concatenate([[0], np.cumsum(rows)]).astype(int).tolist()
    packed = np.zeros((offsets[-1], max(K)))
    width = np.zeros(offsets[-1], int)
    for M, off, k, n in zip(mats, offsets, K, rows):
        packed[off:off + n, :k] = M
        width[off:off + n] = k
    tiles = [(r0, min(tile_rows, offsets[-1] - r0), int(width[r0:r0 + tile_rows].max()))
             for r0 in range(0, offsets[-1], tile_rows)]
    return packed, np.asarray(tiles, np.int32).reshape(-1, 3), K, rows, offsets


def transposed_tiles(packed, tiles, tile_rows):
    """Every row tile of ``pack_rows``' output transposed, zero-padded to
    ``tile_rows`` rows: (ntiles, max K, tile_rows), the layout the kernels
    copy a tile into shared memory from."""
    At = np.zeros((len(tiles), packed.shape[1], tile_rows))
    for t, (r0, n, _) in enumerate(tiles):
        At[t, :, :n] = packed[r0:r0 + n].T
    return At


def k2_swizzle(k):
    """Column c of row k of K2's shared-memory Phi and A tiles lies at
    c ^ k2_swizzle(k) (``csrc/bucket_matmul.cu`` ``swizzle``)."""
    return (k & 3) << 2


def k2_staging_stride(wn):
    """Row stride, in doubles, of a warp's C staging area for a warp tile of
    ``wn`` points: 8 mod 16 (``staging_stride``)."""
    return (wn + 15) // 16 * 16 + 8


def swizzled_tiles(At):
    """K2's A operand: the transposed row tiles ``At`` (ntiles, kpad, 64)
    with row k's column m at m ^ k2_swizzle(k), the kernel's shared-memory
    layout, so that a chunk of rows is one contiguous copy (C-contiguous)."""
    k = np.arange(At.shape[1])[:, None]
    return np.ascontiguousarray(np.take_along_axis(
        At, (np.arange(At.shape[2])[None, :] ^ k2_swizzle(k))[None], axis=2))


class BucketMatmul:
    """``mm = BucketMatmul([A_g ...], device)``; ``C = mm(phi)`` is the
    (sum_g rows_g, npts) float64 stack of A_g @ phi[:K_g], K_g =
    A_g.shape[1]; ``mm.views(C)`` gives the per-group blocks (views).

    The rows of all groups are packed back to back, zero-padded to ``kpad``
    (the widest K rounded up to the MMA's depth, 4), and cut into 64-row
    tiles, each contracting up to the widest row it holds, rounded up to
    that depth (the padding is exact zeros): one launch covers every group.
    ``plan`` is the kernel's (point tile, rows of an A chunk, chunks in the
    ring, blocks an SM holds).  ``mode`` is "resident" where a block's
    shared memory takes the Phi tile beside a ring of A chunks (K up to
    792), else "streamed": Phi then comes through the ring in k beside A,
    one block a (point tile, row tile), the grid ordered in groups of
    ``group`` row tiles (``stream_plan``).  The kernel reads the tiles transposed and
    swizzled (``At``, ``swizzled_tiles``, on the device); the packed rows
    ``A`` serve the plain version only and live where it last ran.
    ``launches`` counts kernel launches (the plain CPU path adds nothing).
    """

    #: rows of one kernel tile (csrc/bucket_matmul.cu, TR)
    TILE_ROWS = 64
    #: a block's warps, WARPS_N of them along the points: a warp
    #: tile is TILE_ROWS / (WARPS / WARPS_N) rows by point tile / WARPS_N
    #: points
    WARPS, WARPS_N = 8, 4
    #: rows of C a warp stages at a time (SLAB), the most A chunks in the
    #: ring and the fewest
    SLAB, STAGES, MIN_STAGES = 8, 4, 2
    #: point tiles, widest first, and the fewest A rows worth a chunk
    POINT_TILES = (128, 64, 32)
    KC_MIN = 16
    #: the most row tiles for which a narrow contraction takes the
    #: narrowest point tile
    FEW_TILES = 16
    #: shared memory a block may take on sm_90, an SM's, and what the SM
    #: keeps for each resident block
    SMEM_MAX, SMEM_SM, SMEM_BLOCK = 232448, 233472, 1024
    #: the depth of the MMA (mma.sync m16n8k4)
    DEPTH = 4
    #: the streamed mode: its point tile, the rows of a chunk and the chunks
    #: in its ring (the fastest of the plans ``chip_smoke.py --k2-cells``
    #: times on tet GLL Lagrange 20), the blocks an SM holds, and the bytes
    #: of A a group of row tiles keeps in L2
    STREAM_TP, STREAM_KC, STREAM_STAGES, STREAM_BLOCKS, STREAM_L2 = 128, 32, 2, 2, 16 << 20

    def __init__(self, mats, device=None):
        self.device = resolve_device(device)
        packed, tiles, self.K, self.rows, self.offsets = pack_rows(mats, self.TILE_ROWS)
        self.total_rows, self.max_k = packed.shape
        self.kpad = max(1, -(-self.max_k // self.DEPTH)) * self.DEPTH
        self.plan = self.plan_for(self.kpad, len(tiles))
        self.mode, self.group = "resident", None
        if self.plan is None:
            self.mode = "streamed"
            self.plan, self.group = self.stream_plan(self.kpad)
        self.A = torch.as_tensor(packed)
        At = np.pad(transposed_tiles(packed, tiles, self.TILE_ROWS),
                    ((0, 0), (0, self.kpad - self.max_k), (0, 0)))
        self.At = torch.as_tensor(swizzled_tiles(At), device=self.device)
        self.tiles = torch.as_tensor(tiles, device=self.device)
        self.device = self.At.device       # "cuda" resolved to its index
        self.launches = 0

    @classmethod
    def smem_bytes(cls, kpad, tp, kc, stages):
        """Shared memory of a block: the Phi tile, a ring of ``stages`` A
        chunks, every warp's C staging area, and the ring's two mbarriers
        and counter a buffer (``smem_doubles``)."""
        staging = cls.WARPS * cls.SLAB * k2_staging_stride(tp // cls.WARPS_N)
        return 8 * (kpad * tp + stages * kc * cls.TILE_ROWS + staging + 3 * cls.STAGES)

    @classmethod
    def fit(cls, kpad, tp, blocks):
        """(tp, A chunk rows, chunks in the ring, blocks) with the widest
        chunk, a multiple of DEPTH up to kpad, that MIN_STAGES of leave room
        for beside the Phi tile and staging in the shared memory of
        ``blocks`` blocks an SM, and as many of those chunks as fit, up to
        STAGES; None if that chunk is under ``min(kpad, KC_MIN)`` rows."""
        chunk = 8 * cls.TILE_ROWS                 # bytes of one row of k in a chunk
        budget = min(cls.SMEM_MAX, cls.SMEM_SM // blocks - cls.SMEM_BLOCK)
        free = budget - cls.smem_bytes(kpad, tp, 0, 0)
        kc = min(kpad, max(0, free) // (cls.MIN_STAGES * chunk) // cls.DEPTH * cls.DEPTH)
        if kc < min(kpad, cls.KC_MIN):
            return None
        return tp, kc, min(cls.STAGES, free // (kc * chunk)), blocks

    @classmethod
    def plan_for(cls, kpad, ntiles):
        """(point tile, A chunk rows, chunks in the ring, blocks an SM
        holds) for a contraction padded to ``kpad`` over ``ntiles`` row
        tiles.  A narrow contraction, one whose 128-point tile fits two
        blocks an SM with A's whole width in one chunk (kpad <= 44), runs
        two blocks an SM (registers capped to let them), so that one block's
        Phi loads and C stores overlap the other's products; its point tile
        is the narrowest (more, shorter blocks, whose fill and drain weigh
        most when a block walks few row tiles) for at most FEW_TILES row
        tiles, else the widest (whole-line stores of C).  Any other runs one
        block an SM on the widest point tile that ``fit`` takes (fewer,
        wider chunks: each chunk is a wait on the ring).  None if no point
        tile leaves room."""
        narrow = cls.fit(kpad, cls.POINT_TILES[0], 2)
        if narrow is not None and narrow[1] == kpad:
            tp = cls.POINT_TILES[-1 if ntiles <= cls.FEW_TILES else 0]
            return cls.fit(kpad, tp, 2)
        for tp in cls.POINT_TILES:
            plan = cls.fit(kpad, tp, 1)
            if plan is not None:
                return plan
        return None

    @classmethod
    def stream_smem_bytes(cls, kc, stages):
        """Shared memory of a streamed block: the ring of ``stages`` (A
        chunk, Phi slab) pairs of ``kc`` rows, which the C staging re-uses
        (``stream_smem_doubles``)."""
        staging = cls.WARPS * cls.SLAB * k2_staging_stride(cls.STREAM_TP // cls.WARPS_N)
        return 8 * max(stages * kc * (cls.TILE_ROWS + cls.STREAM_TP), staging)

    @classmethod
    def stream_plan(cls, kpad):
        """The streamed mode's ((point tile, chunk rows, chunks in the ring,
        blocks an SM), row tiles a group) for a contraction padded to
        ``kpad``: chunks of STREAM_KC rows (kpad where narrower) in a ring of
        STREAM_STAGES, STREAM_BLOCKS blocks an SM, and groups of row tiles
        whose A takes about STREAM_L2 bytes."""
        kc = min(kpad, cls.STREAM_KC)
        group = max(1, cls.STREAM_L2 // (8 * kpad * cls.TILE_ROWS))
        return (cls.STREAM_TP, kc, cls.STREAM_STAGES, cls.STREAM_BLOCKS), group

    def _check(self, phi):
        if not isinstance(phi, torch.Tensor):
            raise TypeError("phi must be a torch.Tensor")
        if phi.dtype != torch.float64:
            raise TypeError(f"phi must be float64, got {phi.dtype}")
        if phi.dim() != 2 or phi.shape[0] < self.max_k:
            raise ValueError(f"phi must have shape (>= {self.max_k}, npts), got {tuple(phi.shape)}")
        if not phi.is_contiguous():
            raise ValueError("phi must be contiguous")
        if phi.shape[1] >= 2 ** 31:
            raise ValueError("too many points for one launch")

    def __call__(self, phi):
        self._check(phi)
        if phi.device.type == "cpu":
            return self.plain(phi)
        if phi.device.type != "cuda" or phi.device != self.device:
            raise ValueError(f"phi on {phi.device}, engine on {self.device}")
        npts = phi.shape[1]
        C = torch.empty((self.total_rows, npts), dtype=torch.float64, device=phi.device)
        if npts == 0:
            return C
        lib = load_kernels()
        tp, kc, stages, blocks = self.plan
        ntiles = self.tiles.shape[0]
        if self.mode == "streamed":
            if -(-npts // tp) * ntiles >= 2 ** 31:
                raise ValueError(f"{npts} points x {ntiles} row tiles: too many blocks for one "
                                 "launch")
            err = lib.fiat_bucket_matmul_stream(
                self.At.data_ptr(), self.kpad, self.max_k, kc, stages, self.group,
                self.tiles.data_ptr(), ntiles, phi.data_ptr(), npts, npts, C.data_ptr(),
                stream_of(phi))
        else:
            err = lib.fiat_bucket_matmul(self.At.data_ptr(), self.kpad, self.max_k, tp, kc,
                                         stages, blocks, self.tiles.data_ptr(), ntiles,
                                         phi.data_ptr(), npts, npts, C.data_ptr(),
                                         stream_of(phi))
        check_launch(f"fiat_bucket_matmul ({self.mode}, contraction width {self.max_k})", err)
        self.launches += 1
        return C

    def plain(self, phi):
        """The same product in plain PyTorch: one f64 matmul per group."""
        self.A = A = self.A.to(phi.device)
        C = torch.empty((self.total_rows, phi.shape[1]), dtype=torch.float64, device=phi.device)
        for off, K, rows in zip(self.offsets, self.K, self.rows):
            torch.matmul(A[off:off + rows, :K], phi[:K], out=C[off:off + rows])
        return C

    def views(self, C):
        """Per-group row blocks of a stacked output (views, no copies)."""
        return [C[off:off + rows] for off, rows in zip(self.offsets, self.rows)]


class FusedZooTabulator:
    """The kernel engine of a zoo of nodal elements, plain and macro.

    ``blocks = fz.block_tables(points)`` gives {alpha: [one (rows_g, npts)
    float64 block per width group..., one block per macro element...]},
    and ``fz.unpack(blocks)`` the per-element dicts of
    ``el.tabulate(order, points)``; ``fz(points)`` gives {alpha: (rows,
    npts)} in the row order of ``BatchedTabulator``.  ``fz.recurrence``
    (K1; None on the Bernstein route), ``fz.features`` (K8; None on the
    Dubiner route) and ``fz.matmul`` (K2) carry the launch counts;
    ``fz.macro_routes`` lists every route of the macro programs
    (``MacroRoute``: its kernel and launch count in ``.engine``, K3 or K7
    as ``.name`` says, its own K1 if any), the one on the zoo's basis
    first.

    ``features``: "auto" or "dubiner" (the default) feed K2 from the
    recurrence; "bernstein" from the Bernstein features, with the
    conversion folded into K2's rows in longdouble (fiat_tpu's
    ``_Bucket(post=M)``).  The Bernstein route needs one contraction width
    and no macro elements; elsewhere it raises ``ValueError`` (fiat_tpu
    keeps the recurrence there without saying so)."""

    def __init__(self, batched, device=None, features="auto"):
        self._setup(**batched.state(), order=batched.order, device=device,
                    features=features)

    @classmethod
    def from_arrays(cls, *, stacked, alpha_mats, slices, plain_nexp, max_degree, scale,
                    affine_map, macro_programs=(), features="auto", device=None, order=None):
        """The engine from the host-built arrays of a ``BatchedTabulator``
        (``BatchedTabulator.state()``, or fiat_tpu's ``BatchedTabulator``
        attributes of the same names): ``stacked`` (plain rows, nexp);
        ``alpha_mats`` {alpha: (plain rows, nexp)} (empty at order 0);
        ``slices`` [(lo, hi, value shape)] per element; ``plain_nexp``
        {plain element: contraction width}; the target expansion set's
        ``max_degree``, ``scale`` and ``affine_map`` (A, b); and the
        ``macro_programs`` (``MacroSideProgram``s, the port's or fiat_tpu's)
        of the macro elements, which are the elements missing from
        ``plain_nexp``; ``order``, the zoo's derivative order, sets the
        binning of C0 macro bases (the highest order of ``alpha_mats`` when
        None, which under jets, where ``alpha_mats`` is empty, is 0: pass
        the tabulator's ``order`` there)."""
        self = cls.__new__(cls)
        self._setup(stacked=stacked, alpha_mats=alpha_mats, slices=slices,
                    plain_nexp=plain_nexp, max_degree=max_degree, scale=scale,
                    affine_map=affine_map, macro_programs=macro_programs, device=device,
                    features=features, order=order)
        return self

    def _setup(self, stacked, alpha_mats, slices, plain_nexp, max_degree, scale,
               affine_map, macro_programs, device, features, order=None):
        if features not in ("auto", "dubiner", "bernstein"):
            raise ValueError(f"features {features!r}: 'auto', 'dubiner' or 'bernstein'")
        self.device = resolve_device(device)
        A, _ = affine_map
        self.sd = np.asarray(A).shape[0]
        mats = dict(alpha_mats) or {(0,) * self.sd: stacked}
        self.alphas = list(mats)
        self.slices = [(int(lo), int(hi), tuple(shape)) for lo, hi, shape in slices]
        self.rows = max(hi for _, hi, _ in self.slices)
        #: macro element -> (program, row range in its program's tables),
        #: in element order (the order of their blocks)
        self._macro_loc = {int(idx): (g, int(lo), int(hi))
                           for g, prog in enumerate(macro_programs)
                           for idx, lo, hi in prog.row_slices}
        self.special = sorted(self._macro_loc)
        if set(plain_nexp) | set(self.special) != set(range(len(self.slices))):
            raise ValueError("every element needs a contraction width in plain_nexp "
                             "or a macro program")

        self.widths, group_mats, self._loc, self.group_rows, _ = group_by_width(
            mats, self.alphas, self.slices, plain_nexp)
        self.recurrence = self.features = None
        self._programs = list(macro_programs)
        order = max(map(sum, self.alphas)) if order is None else order
        rec_degree = max_degree
        #: one route per group of macro programs (``partition_macro_programs``)
        self.macro_routes = []
        for kind, members, on_zoo in partition_macro_programs(self._programs, scale,
                                                              affine_map):
            route = MacroRoute(kind, members, [self._programs[g] for g in members], order,
                               self.device, on_zoo)
            if route.name == "K7" and on_zoo:
                rec_degree = max(rec_degree, route.degree)
            self.macro_routes.append(route)
        #: macro program -> (route, first row of its tables in the route's output)
        self._route_of = {g: (k, r0) for k, r in enumerate(self.macro_routes)
                          for g, r0 in r.first_row.items()}
        if features == "bernstein":
            if len(self.widths) != 1 or self.special:
                raise ValueError(
                    "features='bernstein' needs a zoo of one contraction width and no macro "
                    f"elements (Bernstein features are not degree-graded); this zoo has widths "
                    f"{self.widths} and {len(self.special)} macro elements")
            M, bary = bernstein_operand(self.sd, max_degree, scale, affine_map)
            group_mats = [np.asarray(np.asarray(group_mats[0], np.longdouble) @ M, np.float64)]
            self.features = BernsteinFeatures(self.sd, max_degree, bary, self.device)
        else:
            self.recurrence = DubinerRecurrence(self.sd, rec_degree, scale, affine_map,
                                                self.device)
        self.matmul = BucketMatmul(group_mats, self.device)
        self.device = self.matmul.device      # "cuda" resolved to its index

    def _points(self, points):
        """Host (numpy) points go to the engine's device; a tensor must
        already be there: the engine never moves the work to another device."""
        if isinstance(points, torch.Tensor) and points.device != self.device:
            raise ValueError(f"points on {points.device}, engine on {self.device}")
        pts = torch.as_tensor(points, dtype=torch.float64, device=self.device).contiguous()
        if pts.dim() != 2 or pts.shape[1] != self.sd:
            raise ValueError(f"points must have shape (npts, {self.sd}), got {tuple(pts.shape)}")
        return pts

    def block_tables(self, points):
        """{alpha: [per-group (rows_g, npts) float64 block..., per macro
        element (rows_e, npts) block...]} (views into the kernels'
        outputs); ``unpack`` maps them to per-element dicts."""
        pts = self._points(points)
        basis = self.recurrence(pts) if self.features is None else self.features(pts)
        blocks = self.matmul.views(self.matmul(basis))
        out = {a: [blk[k * r:(k + 1) * r] for blk, r in zip(blocks, self.group_rows)]
               for k, a in enumerate(self.alphas)}
        outs = [route(pts, basis) for route in self.macro_routes]
        for i in self.special:
            g, lo, hi = self._macro_loc[i]
            route, r0 = self._route_of[g]
            r = self._programs[g].rows
            for k, a in enumerate(self.alphas):
                out[a].append(outs[route][r0 + k * r + lo:r0 + k * r + hi])
        return out

    def _table(self, i, tabs):
        """Element i's rows in a ``block_tables`` list of blocks."""
        if i in self._loc:
            g, lo, hi = self._loc[i]
            return tabs[g][lo:hi]
        return tabs[len(self.widths) + self.special.index(i)]

    def unpack(self, block_tables):
        """Per-element {alpha: tensor} views of ``block_tables`` output;
        concatenated tables (the ``__call__`` layout) are accepted too."""
        out = []
        for i, (lo, hi, shape) in enumerate(self.slices):
            elem = {}
            for a, tabs in block_tables.items():
                tab = self._table(i, tabs) if isinstance(tabs, (list, tuple)) else tabs[lo:hi]
                elem[a] = tab.reshape(shape + tuple(tab.shape[-1:]))
            out.append(elem)
        return out

    def __call__(self, points):
        """{alpha: (rows, npts)} float64 in the zoo's stacked row order."""
        order = sorted(range(len(self.slices)), key=lambda i: self.slices[i][0])
        return {a: torch.cat([self._table(i, tabs) for i in order], dim=0)
                for a, tabs in self.block_tables(points).items()}


class MacroRoute:
    """One route of a zoo's macro programs (``partition_macro_programs``):
    ``route(points, basis)`` is the (rows, npts) float64 tables of its
    programs, one after another, each alpha-major as its ``tall`` matrix.

    ``name`` is the kernel: "K3" or "K7" for merged programs
    (``one_shot_applies`` chooses), "K2" for a program on a variant parent,
    whose masked parent is tabulated in PyTorch (``masked_parent``) and
    multiplied by its ``tall`` matrix; ``engine`` is that kernel's wrapper
    (its launch count); ``recurrence`` the parent recurrence (K1) of a K7
    route off the zoo's basis, which cannot read K1's Phi of the zoo (None
    else); ``members`` the zoo's program indices and ``first_row`` each
    one's first row in the output."""

    def __init__(self, kind, members, programs, order, device, on_zoo):
        self.kind, self.members, self.on_zoo = kind, list(members), on_zoo
        self.recurrence = None
        if kind == "variant":
            self.program, = programs
            self.unique = unique_binning(self.program, order)
            self.degree = self.program.degree
            self.engine = BucketMatmul([self.program.tall], device)
            self.name, self.first_row = "K2", {self.members[0]: 0}
            return
        merged = merge_group(programs, order)
        self.degree = merged["degree"]
        if one_shot_applies(merged):
            self.engine = MacroOneShot(**merged, device=device)
        else:
            self.engine = MaskedMatmul(merged["A"], merged["pieces"], merged["geom"],
                                       merged["parent_map"], device=device)
            if not on_zoo:
                self.recurrence = DubinerRecurrence(
                    np.asarray(merged["parent_map"][0]).shape[1], merged["degree"],
                    merged["scale"], merged["affine_map"], device)
        self.name = self.engine.name
        self.first_row = {g: geo["rows"][0] for g, geo in zip(self.members, merged["geom"])}

    def __call__(self, points, basis=None):
        if self.kind == "variant":
            return self.engine(masked_parent(self.program, points, self.unique).contiguous())
        if self.name == "K3":
            return self.engine(points)
        return self.engine(points, basis if self.recurrence is None else self.recurrence(points))

    def plain(self, points, basis=None):
        """The same tables from the kernels' plain versions."""
        if self.kind == "variant":
            return self.engine.plain(masked_parent(self.program, points, self.unique))
        if self.name == "K3":
            return self.engine.plain(points)
        if self.recurrence is not None:
            basis = self.recurrence.plain(points)
        return self.engine.plain(points, basis)

    def kernels(self):
        """{label: wrapper} of the kernels this route launches."""
        out = {self.name: self.engine}
        if self.recurrence is not None:
            out["K1"] = self.recurrence
        return out


def group_by_width(mats, alphas, slices, plain_nexp):
    """The plain rows grouped by exact contraction width (a degree-d element
    only touches the degree-d morton prefix of the basis); within a group,
    elements keep their zoo order and the alphas stack row-wise.

    Returns (widths, [one (nalpha * rows_g, K_g) matrix per width], {plain
    element: (group, lo, hi) rows within one alpha's block}, [rows_g], src)
    with ``src`` (packed rows, 2) giving every packed row's (alpha index,
    zoo row).  Raises ``ValueError`` where a width would drop a coefficient."""
    widths = sorted(set(int(w) for w in plain_nexp.values()))
    loc, group_mats, group_rows, src = {}, [], [], []
    for g, K in enumerate(widths):
        members = [(i, lo, hi) for i, (lo, hi, _) in enumerate(slices)
                   if i in plain_nexp and int(plain_nexp[i]) == K]
        cursor = 0
        for i, lo, hi in members:
            loc[i] = (g, cursor, cursor + hi - lo)
            cursor += hi - lo
        parts = []
        for k, a in enumerate(alphas):
            rows = np.vstack([np.asarray(mats[a])[lo:hi] for _, lo, hi in members])
            dropped = rows[:, K:]
            if dropped.size and np.abs(dropped).max() > 1e-8 * (np.abs(rows).max() + 1.0):
                raise ValueError("width grouping would drop real coefficients")
            parts.append(rows[:, :K])
            src.extend((k, r) for _, lo, hi in members for r in range(lo, hi))
        group_mats.append(np.vstack(parts))
        group_rows.append(cursor)
    return widths, group_mats, loc, group_rows, np.asarray(src, np.int64).reshape(-1, 2)


def partition_macro_programs(programs, scale, affine_map):
    """The macro programs in routes (fiat_tpu's per-program fallback,
    ``macro_fms``, in groups): [(kind, [program indices], shares the zoo's
    basis)], the group on the zoo's basis first, the others in the order
    of their first program.

    * "merged": programs whose parents share one plain Dubiner basis (the
      same expansion-set type, cell map and scale), merged into one
      ``_merge_macro_programs`` table and run by one K3 or K7 launch (K45
      for moments).  The group on the zoo's own basis (``scale`` and
      ``affine_map``) comes first and says so: K7 reads it from K1's Phi;
      any other group has a parent recurrence of its own.
    * "variant": one program whose parent basis the recurrence cannot
      take (``parent_es.variant`` is not None): its masked parent is
      tabulated in PyTorch, as fiat_tpu's ``_macro_prepared_B`` does in
      XLA, and K2 multiplies it by the program's ``tall`` matrix.

    A zoo whose programs all share the zoo's basis, as every zoo of the
    element families does, is one merged route, fiat_tpu's merged kernel."""
    A_zoo, b_zoo = (np.asarray(v, np.float64) for v in affine_map)
    groups, routes = {}, []
    for g, p in enumerate(programs):
        pes = p.parent_es
        if pes.variant is not None:
            routes.append(["variant", [g], False])
            continue
        if len(pes.affine_mappings) != 1:
            raise NotImplementedError(
                f"macro program {g}: a parent expansion set over {len(pes.affine_mappings)} "
                "cells; a macro program's parent is one simplex")
        A, b = (np.asarray(v, np.float64) for v in pes.affine_mappings[0])
        key = (type(pes), A.tobytes(), b.tobytes(), float(pes.get_scale(max(p.degree, 1))))
        if key not in groups:
            zoo = (np.allclose(A, A_zoo) and np.allclose(b, b_zoo) and key[3] == float(scale)
                   and not any(r[2] for r in routes))
            groups[key] = ["merged", [], zoo]
            routes.append(groups[key])
        groups[key][1].append(g)
    # the group on the zoo's basis first: K7 reads it from K1's Phi
    routes.sort(key=lambda r: not r[2])
    return [tuple(r) for r in routes]


def masked_parent(program, points, unique):
    """A macro program's masked parent basis, (ncells * nexp_parent, npts)
    in the points' dtype on their device (``MacroSideProgram.b_stack``, for
    the port's programs and fiat_tpu's alike): every subcell's {0,1} mask,
    divided by the cover count unless ``unique``, times the parent's
    Dubiner tabulation with its variant."""
    pes = program.parent_es
    sd = points.shape[1]
    A, b = (np.asarray(v, np.float64) for v in pes.affine_mappings[0])
    ref = points @ points.new_tensor(A.T) + points.new_tensor(b)
    phi = dubiner_tabulate(sd, program.degree, [ref[:, i] for i in range(sd)],
                           float(pes.get_scale(program.degree)), variant=pes.variant)
    masks = partition_of_unity_masks(program.es.ref_el, points, unique=unique)
    return torch.cat([m * phi for m in masks], dim=0)


def unique_binning(program, order):
    """Whether a program's points keep their first subcell (a C0 basis at
    order 0) or average over the subcells they lie on."""
    return program.es.continuity is not None and order == 0


def _merge_macro_programs(programs, scale, affine_map, order,
                          engine="each macro engine (K3, K7)"):
    """The merged arrays of macro side programs that share one parent basis
    (fiat_tpu's ``_build_macro_merged`` / ``_build_macro_oneshot``): the
    merged tall matrix with each program's scale ratio folded in, the (row,
    nexp_parent) pieces per subcell, per-program geometry (rescaled
    barycentric maps, ``unique``, row range), the parent map, ``degree``
    and the parent ``scale`` and ``affine_map``.  ``scale`` and
    ``affine_map`` are those of the shared basis (the zoo's, for the group
    on it); programs that do not share it raise ``ValueError``:
    ``partition_macro_programs`` groups them first."""
    def refuse(why):
        raise ValueError(f"macro programs {why} do not share one parent basis, and {engine} "
                         "is built on one: partition_macro_programs groups them first")

    A_zoo, b_zoo = (np.asarray(v, np.float64) for v in affine_map)
    if any(type(p.parent_es) is not type(programs[0].parent_es) for p in programs):
        refuse("with mixed parent expansion-set types")
    for p in programs:
        pes = p.parent_es
        if pes.variant is not None:
            refuse(f"with a parent expansion variant {pes.variant!r}")
        if (len(pes.affine_mappings) != 1 or not np.allclose(pes.affine_mappings[0][0], A_zoo)
                or not np.allclose(pes.affine_mappings[0][1], b_zoo)):
            refuse("on another parent cell")
    rec_deg = max(p.degree for p in programs)
    rec_scale = float(programs[0].parent_es.get_scale(rec_deg))
    # degree-dependent normalisation (the degree-0 "exactly 1" quirk)
    # would break the shared parent basis
    if rec_scale != float(scale):
        refuse(f"whose degree-{rec_deg} parent scale {rec_scale} differs from {scale}")

    rows_t = sum(p.tall.shape[0] for p in programs)
    A = np.zeros((rows_t, sum(p.K for p in programs)))
    pieces, geom = [], []
    r0 = c0 = 0
    for p in programs:
        ratio = float(p.parent_es.get_scale(p.degree)) / rec_scale
        A[r0:r0 + p.tall.shape[0], c0:c0 + p.K] = ratio * p.tall
        ref = p.es.ref_el
        sd = ref.get_spatial_dimension()
        pieces.extend((len(pieces), p.nexp_parent) for _ in p.cells)
        geom.append({"maps": [ref.barycentric_map(entity=(sd, c), rescale=True) for c in p.cells],
                     "unique": unique_binning(p, order),
                     "rows": (r0, r0 + p.tall.shape[0])})
        r0 += p.tall.shape[0]
        c0 += p.K
    parent = programs[0].es.ref_el.get_parent()
    return dict(A=A, pieces=pieces, geom=geom, parent_map=parent.barycentric_map(rescale=True),
                degree=rec_deg, scale=rec_scale,
                affine_map=programs[0].parent_es.affine_mappings[0])


def merge_group(programs, order, engine="each macro engine (K3, K7)"):
    """``_merge_macro_programs`` of one merged route, on its own basis."""
    pes = programs[0].parent_es
    return _merge_macro_programs(programs, float(pes.get_scale(max(p.degree for p in programs))),
                                 pes.affine_mappings[0], order, engine)
