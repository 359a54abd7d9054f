"""The fused zoo engine: K1 recurrence + K2 bucketed change of basis.

Counterpart of ``fiat_tpu/ops/pallas_multiword.py`` (``FusedZooTabulator``
over ``FusedMultiwordMatmul``, for plain elements).  One pass runs

  1. K1 (``recurrence.DubinerRecurrence``): Phi (nexp, npts) in f64;
  2. K2 (``BucketMatmul``, ``csrc/bucket_matmul.cu``): for every group of
     zoo rows sharing a contraction width K_g (a degree-d element only
     touches the degree-d morton prefix of the basis), the alpha-stacked
     change-of-basis rows A_g times Phi[:K_g], all groups in one launch.

The TPU engine reaches f64 on the bf16 MXU through df32 pairs, Ozaki
windows and TwoSum combines; Hopper has native FP64, so neither kernel
carries any of that, and the pair surfaces (``pair_blocks``,
``unpack_pairs``, ``pair_tables``) collapse into the f64 blocks here.

The plain version of K2 is a per-group ``torch.matmul`` in f64; the
wrapper runs it for CPU tensors only.  For a CUDA tensor it launches the
kernel or raises.
"""

import numpy as np
import torch

from .kernels import check_launch, load_kernels, stream_of
from .recurrence import DubinerRecurrence


class BucketMatmul:
    """``mm = BucketMatmul([A_g ...], device)``; ``C = mm(phi)`` is the
    (sum_g rows_g, npts) float64 stack of A_g @ phi[:K_g], K_g =
    A_g.shape[1]; ``mm.views(C)`` gives the per-group blocks (views).

    The rows of all groups are packed back to back, zero-padded to the
    widest K, and cut into 64-row tiles, each contracting up to the widest
    row it holds (the padding is exact zeros): one launch covers every
    group.  ``launches`` counts kernel launches (the plain CPU path adds
    nothing).
    """

    #: rows of one kernel tile (csrc/bucket_matmul.cu, TR)
    TILE_ROWS = 64

    def __init__(self, mats, device=None):
        self.device = torch.device("cpu" if device is None else device)
        self.K = [int(M.shape[1]) for M in mats]
        self.rows = [int(M.shape[0]) for M in mats]
        self.offsets = np.concatenate([[0], np.cumsum(self.rows)]).astype(int).tolist()
        self.total_rows = self.offsets[-1]
        self.max_k = max(self.K)
        packed = np.zeros((self.total_rows, self.max_k))
        width = np.zeros(self.total_rows, int)
        for M, off, K, rows in zip(mats, self.offsets, self.K, self.rows):
            packed[off:off + rows, :K] = M
            width[off:off + rows] = K
        tiles = [(r0, min(self.TILE_ROWS, self.total_rows - r0),
                  int(width[r0:r0 + self.TILE_ROWS].max()))
                 for r0 in range(0, self.total_rows, self.TILE_ROWS)]
        self.A = torch.as_tensor(packed, device=self.device)
        self.tiles = torch.as_tensor(np.asarray(tiles, np.int32), device=self.device)
        self.launches = 0

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
        if phi.device.type != "cuda" or phi.device != self.A.device:
            raise ValueError(f"phi on {phi.device}, engine on {self.A.device}")
        npts = phi.shape[1]
        C = torch.empty((self.total_rows, npts), dtype=torch.float64, device=phi.device)
        if npts == 0:
            return C
        lib = load_kernels()
        err = lib.fiat_bucket_matmul(self.A.data_ptr(), self.max_k, self.tiles.data_ptr(),
                                     self.tiles.shape[0], phi.data_ptr(), npts, npts,
                                     C.data_ptr(), stream_of(phi))
        # a contraction width whose shared-memory tile exceeds the card's
        # limit fails here, at the kernel's cudaFuncSetAttribute
        check_launch(f"fiat_bucket_matmul (contraction width {self.max_k})", err)
        self.launches += 1
        return C

    def plain(self, phi):
        """The same product in plain PyTorch: one f64 matmul per group."""
        A = self.A.to(phi.device)
        C = torch.empty((self.total_rows, phi.shape[1]), dtype=torch.float64, device=phi.device)
        for off, K, rows in zip(self.offsets, self.K, self.rows):
            torch.matmul(A[off:off + rows, :K], phi[:K], out=C[off:off + rows])
        return C

    def views(self, C):
        """Per-group row blocks of a stacked output (views, no copies)."""
        return [C[off:off + rows] for off, rows in zip(self.offsets, self.rows)]


class FusedZooTabulator:
    """The kernel engine of a zoo of plain (single-cell) nodal elements.

    ``blocks = fz.block_tables(points)`` gives {alpha: [one (rows_g, npts)
    float64 block per width group]}, and ``fz.unpack(blocks)`` the
    per-element dicts of ``el.tabulate(order, points)``;
    ``fz(points)`` gives {alpha: (rows, npts)} in the row order of
    ``BatchedTabulator``.  ``fz.recurrence`` (K1) and ``fz.matmul`` (K2)
    carry the launch counts."""

    def __init__(self, batched, device=None):
        self._setup(**batched.state(), device=batched.device if device is None else device)

    @classmethod
    def from_arrays(cls, *, stacked, alpha_mats, slices, plain_nexp, max_degree, scale,
                    affine_map, device=None):
        """The engine from the host-built arrays of a ``BatchedTabulator``
        (``BatchedTabulator.state()``, or fiat_tpu's ``BatchedTabulator``
        attributes of the same names): ``stacked`` (rows, nexp);
        ``alpha_mats`` {alpha: (rows, nexp)} (empty at order 0);
        ``slices`` [(lo, hi, value shape)] per element; ``plain_nexp``
        {element: contraction width}; the target expansion set's
        ``max_degree``, ``scale`` and ``affine_map`` (A, b)."""
        self = cls.__new__(cls)
        self._setup(stacked=stacked, alpha_mats=alpha_mats, slices=slices,
                    plain_nexp=plain_nexp, max_degree=max_degree, scale=scale,
                    affine_map=affine_map, device=device)
        return self

    def _setup(self, stacked, alpha_mats, slices, plain_nexp, max_degree, scale,
               affine_map, device):
        self.device = torch.device("cpu" if device is None else device)
        A, _ = affine_map
        self.sd = np.asarray(A).shape[0]
        mats = dict(alpha_mats) or {(0,) * self.sd: stacked}
        self.alphas = list(mats)
        self.rows = np.asarray(stacked).shape[0]
        self.slices = [(int(lo), int(hi), tuple(shape)) for lo, hi, shape in slices]
        if set(plain_nexp) != set(range(len(self.slices))):
            raise ValueError("every element needs a contraction width in plain_nexp")

        # group rows by exact contraction width; within a group, elements
        # keep their zoo order and the alphas stack row-wise
        self.widths = sorted(set(int(w) for w in plain_nexp.values()))
        self._loc = {}                  # element -> (group, lo, hi)
        group_mats, self.group_rows = [], []
        for g, K in enumerate(self.widths):
            members = [(i, lo, hi) for i, (lo, hi, _) in enumerate(self.slices)
                       if int(plain_nexp[i]) == K]
            cursor = 0
            for i, lo, hi in members:
                self._loc[i] = (g, cursor, cursor + hi - lo)
                cursor += hi - lo
            parts = []
            for a in self.alphas:
                rows = np.vstack([np.asarray(mats[a])[lo:hi] for _, lo, hi in members])
                dropped = rows[:, K:]
                if dropped.size and np.abs(dropped).max() > 1e-8 * (np.abs(rows).max() + 1.0):
                    raise ValueError("width grouping would drop real coefficients")
                parts.append(rows[:, :K])
            group_mats.append(np.vstack(parts))
            self.group_rows.append(cursor)

        self.recurrence = DubinerRecurrence(self.sd, max_degree, scale, affine_map, self.device)
        self.matmul = BucketMatmul(group_mats, self.device)
        self.device = self.matmul.A.device      # "cuda" resolved to its index

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
        """{alpha: [per-group (rows_g, npts) float64 block]} (views into one
        kernel output); ``unpack`` maps them to per-element dicts."""
        phi = self.recurrence(self._points(points))
        blocks = self.matmul.views(self.matmul(phi))
        return {a: [blk[k * r:(k + 1) * r] for blk, r in zip(blocks, self.group_rows)]
                for k, a in enumerate(self.alphas)}

    def unpack(self, block_tables):
        """Per-element {alpha: tensor} views of ``block_tables`` output;
        concatenated tables (the ``__call__`` layout) are accepted too."""
        out = []
        for i, (lo, hi, shape) in enumerate(self.slices):
            elem = {}
            for a, tabs in block_tables.items():
                if isinstance(tabs, (list, tuple)):
                    g, blo, bhi = self._loc[i]
                    tab = tabs[g][blo:bhi]
                else:
                    tab = tabs[lo:hi]
                elem[a] = tab.reshape(shape + tuple(tab.shape[-1:]))
            out.append(elem)
        return out

    def __call__(self, points):
        """{alpha: (rows, npts)} float64 in the zoo's stacked row order."""
        out = {}
        for a, blocks in self.block_tables(points).items():
            parts = [None] * len(self.slices)
            for i in range(len(self.slices)):
                g, blo, bhi = self._loc[i]
                parts[i] = blocks[g][blo:bhi]
            out[a] = torch.cat(parts, dim=0)
        return out
