"""K7: the macro (split-complex) elements of a zoo as one masked change of
basis over the zoo's shared Dubiner basis, in one CUDA launch.

Counterpart of ``fiat_tpu/ops/pallas_multiword.py``
(``FusedMaskedMultiword.apply_pair_masked``) together with its two XLA
neighbours in ``FusedZooTabulator._specials_merged``: the binning masks of
``partition_of_unity_masks`` before it and the 1 / cover-count multiply after
it.  The merged change of basis ``A`` (rows, sum_c nexp_c) multiplies B,
whose rows for subcell ("piece") c are ``mask_c * Phi[:nexp_c]``, with Phi
the (nexp, npts) f64 tabulation K1 made for K2, read by prefix.  The kernel
(``csrc/masked_matmul.cu``) bins each point itself and multiplies only the
pieces it bins into (the others add exact zeros); the TPU kernel's df32
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
from .macro_oneshot import BINNING_TOL, COLUMN_STRIDE, MAX_SMEM, chunk_table, pack_geometry

#: pieces of one program: the kernel keeps a point's masks as bits of one word
MAX_PROGRAM_PIECES = 32


def chunk_layout(A, progs, pieces):
    """Every program's rows cut into chunks (``macro_oneshot.chunk_table``)
    and laid out as ``csrc/masked_matmul.cu`` stages them: (chunks int32
    (nchunks, 5) = (program, first row, rows, offset in ``At``, ps), ``At``
    f64 flat, the largest chunk in doubles).  Within a chunk, piece j of the
    program starts ps * j columns in and column k of a piece holds its rows'
    A[:, off + k], ``COLUMN_STRIDE`` doubles apart."""
    table, largest = chunk_table(progs, pieces)
    chunks, blocks, offset = [], [], 0
    for g, row, n, ps in table:
        _, _, c0, c1, _ = progs[g]
        block = np.zeros((c1 - c0, ps, COLUMN_STRIDE))
        for j, (off, w) in enumerate(pieces[c0:c1]):
            block[j, :w, :n] = A[row:row + n, off:off + w].T
        chunks.append((g, row, n, offset, ps))
        blocks.append(block.ravel())
        offset += block.size
    return np.asarray(chunks, np.int32).reshape(-1, 5), np.concatenate(blocks), largest


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

    ``launches`` counts kernel launches (the plain CPU path adds nothing).
    """

    #: which TPU kernel this engine ports
    name = "K7"

    def __init__(self, A, pieces, geom, parent_map, device=None):
        A = np.asarray(A, np.float64)
        self.rows, self.K = A.shape
        self.geom = [dict(g, maps=[(np.asarray(Am, np.float64), np.asarray(bm, np.float64))
                                   for Am, bm in g["maps"]]) for g in geom]
        self.parent_map = tuple(np.asarray(v, np.float64) for v in parent_map)
        self.sd = self.parent_map[0].shape[1]
        self.nexp = [int(n) for _, n in pieces]
        maps, progs, pieces_t = pack_geometry(self.geom, self.parent_map, self.nexp)
        if int(pieces_t[-1].sum()) != self.K:
            raise ValueError("the pieces must cover the columns of A")
        widest = int((progs[:, 3] - progs[:, 2]).max())
        if widest > MAX_PROGRAM_PIECES:
            raise NotImplementedError(
                f"a program of {widest} subcells: K7 takes at most {MAX_PROGRAM_PIECES}")
        self.max_nexp = max(self.nexp)
        chunks, At, largest = chunk_layout(A, progs, pieces_t)
        if largest * 8 > MAX_SMEM:
            raise NotImplementedError(f"a chunk of {largest * 8} bytes: K7 stages at most "
                                      f"{MAX_SMEM} bytes of A in shared memory")
        if len(chunks) > 65535:
            raise NotImplementedError(f"{len(chunks)} row chunks: K7's grid takes at most 65535")
        self.smem_doubles = largest
        self.device = resolve_device(device)

        def as_t(a, dtype=torch.float64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=self.device)

        # the kernel reads A in its chunk layout (At); the plain version reads A
        self.A = as_t(A)
        self.At = as_t(At)
        self.chunks = as_t(chunks, torch.int32)
        self.maps = as_t(maps)
        self.progs = as_t(progs, torch.int32)
        self.pieces = as_t(pieces_t, torch.int32)
        self.device = self.A.device       # "cuda" resolved to its index
        self.launches = 0

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
        err = lib.fiat_masked_matmul(
            points.data_ptr(), npts, self.sd, BINNING_TOL[torch.float64], self.maps.data_ptr(),
            self.progs.data_ptr(), self.pieces.data_ptr(), self.chunks.data_ptr(),
            self.chunks.shape[0], self.At.data_ptr(), self.smem_doubles, phi.data_ptr(),
            out.data_ptr(), stream_of(points))
        check_launch(f"fiat_masked_matmul ({self.rows} x {self.K}, sd = {self.sd})", err)
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
