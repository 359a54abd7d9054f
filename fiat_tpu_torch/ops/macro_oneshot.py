"""K3: the macro (split-complex) elements of a zoo in one CUDA launch.

Counterpart of ``fiat_tpu/ops/pallas_multiword.py`` (``FusedMacroOneShot``,
with the binning of ``pallas_recurrence.SubcellBinning``).  For every point
the kernel (``csrc/macro_oneshot.cu``) bins it to the subcells of every
macro program, runs the parent-cell Dubiner recurrence, multiplies the
merged change of basis by the masked parent basis and averages over the
subcells that share the point.  The TPU kernel does this in df32 pairs and
Ozaki windows; Hopper has native FP64, so the kernel computes it in f64.

The plain version beside it does the same in plain PyTorch: masks by
``core.expansions.subcell_masks`` (the body of
``partition_of_unity_masks``), the parent recurrence, a masked B,
``torch.matmul``, then the reciprocal of the cover count.  The wrapper runs
it for CPU tensors only; for a CUDA tensor it launches the kernel or raises.
"""

import numpy as np
import torch

from ..core.expansions import dubiner_tabulate, subcell_masks
from .kernels import check_launch, load_kernels, stream_of
from .recurrence import pack_stages

#: highest parent degree the kernel is instantiated for (csrc/macro_oneshot.cu)
MAX_DEGREE = 10
#: subcells over all programs: the kernel keeps a point's masks as bits of one word
MAX_PIECES = 32


class MacroOneShot:
    """``mo = MacroOneShot(A, pieces, geom, parent_map, degree, scale,
    affine_map, device)``; ``out = mo(points)`` is the (rows, npts) float64
    table of every macro program at ``points`` (npts, 2).

    ``A`` (rows, K) is the merged change of basis: per subcell ("piece") c,
    in program order, the columns ``pieces[c][1]`` wide that multiply the
    leading parent basis members on that subcell.  ``geom`` holds per
    program {"maps": [(A_c, b_c) rescaled barycentric map per subcell],
    "unique": bool, "rows": (r0, r1)}; ``parent_map`` is the parent cell's
    rescaled barycentric map; ``degree``, ``scale`` and ``affine_map`` define
    the parent recurrence (onto the default triangle by ``A x + b``).

    ``launches`` counts kernel launches (the plain CPU path adds nothing).
    """

    def __init__(self, A, pieces, geom, parent_map, degree, scale, affine_map, device=None):
        A = np.asarray(A, np.float64)
        self.rows, self.K = A.shape
        self.degree = int(degree)
        if not 0 <= self.degree <= MAX_DEGREE:
            raise NotImplementedError(f"macro parent degree {degree} outside 0..{MAX_DEGREE}")
        self.geom = [dict(g, maps=[(np.asarray(Am, np.float64), np.asarray(bm, np.float64))
                                   for Am, bm in g["maps"]]) for g in geom]
        self.parent_map = tuple(np.asarray(v, np.float64) for v in parent_map)
        if self.parent_map[0].shape != (3, 2):
            raise NotImplementedError("K3 covers triangles (sd = 2) only")
        self.nexp = [int(n) for _, n in pieces]
        if len(self.nexp) > MAX_PIECES:
            raise NotImplementedError(f"{len(self.nexp)} subcells: K3 takes at most {MAX_PIECES}")
        if max(self.nexp) > (self.degree + 1) * (self.degree + 2) // 2:
            raise ValueError("a subcell reads more parent members than the recurrence makes")
        offsets = np.concatenate([[0], np.cumsum(self.nexp)]).astype(int)
        if offsets[-1] != self.K:
            raise ValueError("the pieces must cover the columns of A")
        self.offsets = offsets[:-1].tolist()
        self.scale = float(scale)
        Af, bf = affine_map
        self.affine = np.concatenate([np.asarray(Af, np.float64).ravel(),
                                      np.asarray(bf, np.float64).ravel()])

        maps, progs, c0 = [self.parent_map], [], 0
        for g in self.geom:
            maps.extend(g["maps"])
            r0, r1 = g["rows"]
            progs.append((r0, r1, c0, c0 + len(g["maps"]), int(bool(g["unique"]))))
            c0 += len(g["maps"])
        if c0 != len(self.nexp):
            raise ValueError("every subcell of every program needs one piece")
        self.device = torch.device("cpu" if device is None else device)

        def as_t(a, dtype=torch.float64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=self.device)

        self.A = as_t(A)
        self.maps = as_t(np.stack([np.column_stack([Am, bm]) for Am, bm in maps]))
        self.progs = as_t(np.asarray(progs, np.int32), torch.int32)
        self.pieces = as_t(np.column_stack([self.offsets, self.nexp]).astype(np.int32),
                           torch.int32)
        self.consts = as_t(pack_stages(self.degree)[0])
        self.device = self.A.device       # "cuda" resolved to its index
        self.launches = 0

    def _check(self, points):
        if not isinstance(points, torch.Tensor):
            raise TypeError("points must be a torch.Tensor")
        if points.dtype != torch.float64:
            raise TypeError(f"points must be float64, got {points.dtype}")
        if points.dim() != 2 or points.shape[1] != 2:
            raise ValueError(f"points must have shape (npts, 2), got {tuple(points.shape)}")
        if not points.is_contiguous():
            raise ValueError("points must be contiguous")
        if points.shape[0] >= 2 ** 31:
            raise ValueError("too many points for one launch")

    def __call__(self, points):
        self._check(points)
        if points.device.type == "cpu":
            return self.plain(points)
        if points.device.type != "cuda" or points.device != self.device:
            raise ValueError(f"points on {points.device}, engine on {self.device}")
        npts = points.shape[0]
        out = torch.empty((self.rows, npts), dtype=torch.float64, device=points.device)
        if npts == 0:
            return out
        lib = load_kernels()
        err = lib.fiat_macro_oneshot(
            points.data_ptr(), npts, self.consts.data_ptr(), *self.affine.tolist(), self.scale,
            self.degree, self.maps.data_ptr(), len(self.nexp), self.progs.data_ptr(),
            len(self.geom), self.pieces.data_ptr(), self.A.data_ptr(), self.rows, self.K,
            out.data_ptr(), stream_of(points))
        check_launch(f"fiat_macro_oneshot ({self.rows} x {self.K})", err)
        self.launches += 1
        return out

    def plain(self, points):
        """The same tables in plain PyTorch, on the points' device."""
        Af = points.new_tensor(self.affine[:4].reshape(2, 2))
        ref = points @ Af.T + points.new_tensor(self.affine[4:])
        phi = dubiner_tabulate(2, self.degree, [ref[:, 0], ref[:, 1]], self.scale)
        parts, totals = [], []
        nexp = iter(self.nexp)
        for g in self.geom:
            masks, total = subcell_masks(points, self.parent_map, g["maps"],
                                         unique=g["unique"], raw=True)
            parts.extend(m * phi[:next(nexp)] for m in masks)
            totals.append(total)
        out = self.A.to(points.device) @ torch.cat(parts, dim=0)
        for g, total in zip(self.geom, totals):
            if total is not None:
                r0, r1 = g["rows"]
                out[r0:r1] *= 1.0 / total
        return out
