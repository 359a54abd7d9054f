"""Sum-factorised moments and interpolation for a fused zoo.

Counterpart of ``fiat_tpu/ops/moments.py``.  Integral consumers never need
the (rows, npts) nodal table:

    M[i] = sum_q w_q phi_i(x_q) f(x_q)
         = sum_k C[i, k] * (sum_q psi_k(x_q) w_q f(x_q))

so the orthonormal expansion is contracted against the points first and
the nodal change of basis applies to one vector.  On the card the
expansion-side sums of the plain rows and of every macro subcell come from
one launch of K45 (``moment_kernel.PairMoments``); interpolation, the
transpose, runs K1 for the plain rows and K3 with the coefficients folded
into a one-row change of basis per macro program (K3's one-row chunks,
every program's in one block).  The small products around them stay ``torch.matmul``, as fiat_tpu
leaves them to XLA.  Both directions take intervals, triangles and
tetrahedra, plain and macro.

The engine is built once per tabulator and cached on it; it runs on
``tabulator.device`` (a CUDA device, the default: the kernels; the CPU,
where the tabulator was asked for it: their plain PyTorch versions).  The
host checks of the macro programs run when the engine is built; each
kernel wrapper is built on the first call that needs it (K45 on the first
moments, K3 on the first interpolation of a macro zoo) and kept.
"""

import numpy as np
import torch

from .fused_zoo import _merge_macro_programs
from .kernels import resolve_device
from .macro_oneshot import MacroOneShot
from .moment_kernel import PairMoments
from .recurrence import DubinerRecurrence


class MomentEngine:
    """Moments and interpolation over every basis row of a zoo, in the
    ``BatchedTabulator`` row layout (plain rows, then the macro elements').

    ``moments`` (K45), ``recurrence`` (K1) and ``macro`` (K3, None without
    macro elements) carry the launch counts; ``moments`` and ``macro`` are
    built on first use, by whichever reads them first, and ``built`` says
    which of the two exist."""

    def __init__(self, batched, device=None):
        self._setup(**batched.state(), device=device)

    @classmethod
    def from_arrays(cls, *, stacked, slices, max_degree, scale, affine_map, macro_programs=(),
                    alpha_mats=None, plain_nexp=None, device=None):
        """The engine from the host-built arrays of a ``BatchedTabulator``
        (``state()``, or fiat_tpu's attributes of the same names): the
        value rows ``stacked`` (plain rows, nexp), the element ``slices``,
        the target expansion set's ``max_degree``, ``scale`` and
        ``affine_map``, and the ``macro_programs``.  ``alpha_mats`` and
        ``plain_nexp`` are accepted and not needed: moments take values."""
        self = cls.__new__(cls)
        self._setup(stacked=stacked, slices=slices, max_degree=max_degree, scale=scale,
                    affine_map=affine_map, macro_programs=macro_programs, device=device)
        return self

    def _setup(self, stacked, slices, max_degree, scale, affine_map, macro_programs, device,
               alpha_mats=None, plain_nexp=None):
        self.device = resolve_device(device)
        stacked = np.asarray(stacked, np.float64)
        self.plain_rows, self.nexp = stacked.shape
        self.slices = [(int(lo), int(hi), tuple(shape)) for lo, hi, shape in slices]
        self.rows = max(hi for _, hi, _ in self.slices)
        sd = np.asarray(affine_map[0]).shape[0]
        self.recurrence = DubinerRecurrence(sd, max_degree, scale, affine_map, self.device)
        self.device = self.recurrence.consts.device     # "cuda" resolved to its index

        programs = list(macro_programs)
        self._moments = self._macro = None
        self._merged = None
        degree, geom, parent_map, pieces = max_degree, (), None, ()
        # moments = matrix @ (K45's sums): the value rows of every plain
        # element over pw, and of every macro element over its program's
        # bw (fiat_tpu's stacked @ pw and tall[:rows] @ (bw * ratio))
        matrix = [stacked]
        if programs:
            merged = _merge_macro_programs(
                programs, scale, affine_map, 0, engine="the fused moments engine (K45)")
            self._merged = merged
            degree = max(max_degree, merged["degree"])
            geom, parent_map, pieces = merged["geom"], merged["parent_map"], merged["pieces"]
            K = merged["A"].shape[1]
            matrix = [np.hstack([stacked, np.zeros((self.plain_rows, K))]),
                      np.zeros((self.rows - self.plain_rows, self.nexp + K))]
            # a program's value rows are the first block of its tall matrix
            for p, gm in zip(programs, geom):
                r0 = gm["rows"][0]
                for idx, lo, hi in p.row_slices:
                    flo, fhi, _ = self.slices[idx]
                    if fhi - flo != hi - lo or flo < self.plain_rows:
                        raise ValueError(f"element {idx}: program rows do not match its slice")
                    matrix[1][flo - self.plain_rows:fhi - self.plain_rows, self.nexp:] = \
                        merged["A"][r0 + lo:r0 + hi]
            # program g's columns of the folded coefficients (interpolation)
            cols = np.zeros((len(programs), K))
            for g, c0 in enumerate(np.cumsum([0] + [p.K for p in programs])[:-1]):
                cols[g, c0:c0 + programs[g].K] = 1.0
            self.program_columns = torch.as_tensor(cols, device=self.device)
        self.matrix = torch.as_tensor(np.vstack(matrix), device=self.device)
        self._pair_moments = (degree, self.nexp, scale, affine_map, geom, parent_map, pieces)

    @property
    def moments(self):
        """K45 (``PairMoments``), built on first use."""
        if self._moments is None:
            self._moments = PairMoments(*self._pair_moments, self.device)
        return self._moments

    @property
    def macro(self):
        """K3 (``MacroOneShot``) for interpolation, built on first use;
        None without macro elements."""
        if self._macro is None and self._merged is not None:
            self._macro = MacroOneShot(**self._merged, device=self.device)
        return self._macro

    @property
    def built(self):
        """Which of the wrappers built on first use exist: {"moments": bool,
        "macro": bool}."""
        return {"moments": self._moments is not None, "macro": self._macro is not None}

    def _tensor(self, x, name):
        """Host (numpy) data go to the engine's device; a tensor must
        already be there: the engine never moves the work to another device."""
        if isinstance(x, torch.Tensor) and x.device != self.device:
            raise ValueError(f"{name} on {x.device}, engine on {self.device}")
        return torch.as_tensor(x, dtype=torch.float64, device=self.device).contiguous()

    def moment_rows(self, points, wf):
        """(rows,) float64: M[i] = sum_q phi_i(x_q) wf_q for every basis row."""
        return self.matrix @ self.moments(self._tensor(points, "points"), self._tensor(wf, "wf"))

    def interpolate_rows(self, points, coefficients):
        """(npts,) float64: u(x_q) = sum_i c_i phi_i(x_q)."""
        pts, c = self._tensor(points, "points"), self._tensor(coefficients, "coefficients")
        if tuple(c.shape) != (self.rows,):
            raise ValueError(f"coefficients must have shape ({self.rows},), got {tuple(c.shape)}")
        folded = c @ self.matrix            # (nexp + K,): the transpose of moment_rows
        out = folded[:self.nexp] @ self.recurrence(pts)
        if self.macro is not None:
            W = self.program_columns * folded[self.nexp:]
            out = out + self.macro(pts, A=W).sum(dim=0)
        return out


def moment_engine(tabulator):
    """The moments engine of a ``BatchedTabulator``, built once and cached
    on it (fiat_tpu caches its moment kernels the same way)."""
    eng = getattr(tabulator, "_moment_engine", None)
    if eng is None:
        eng = tabulator._moment_engine = MomentEngine(tabulator, device=tabulator.device)
    return eng


def moment_rows(tabulator, points, wf):
    """Fused moments M[i] = sum_q phi_i(x_q) wf_q over every basis row of a
    ``BatchedTabulator``'s zoo (plain rows, then the macro elements'), with
    ``wf`` the weighted integrand w_q f(x_q), shape (npts,)."""
    return moment_engine(tabulator).moment_rows(points, wf)


def zoo_moments(tabulator, points, weights, f_at_pts=None):
    """Moments of a quadrature-weighted field against every basis function
    of the zoo, computed expansion-side (the nodal table is never built).
    Returns the fused (rows,) vector; ``unpack_moments`` splits it."""
    eng = moment_engine(tabulator)
    wf = eng._tensor(weights, "weights")
    if f_at_pts is not None:
        wf = wf * eng._tensor(f_at_pts, "f_at_pts")
    return eng.moment_rows(points, wf)


def unpack_moments(tabulator, fused):
    """Per-element views of a fused moment vector, each shaped like the
    element's (ndof, *value_shape)."""
    return [fused[lo:hi].reshape(shape) for lo, hi, shape in tabulator.slices]


def interpolate_rows(tabulator, points, coefficients):
    """The transpose of ``moment_rows``: field values u(x_q) = sum_i c_i
    phi_i(x_q) at the points, for coefficients over every basis row of the
    zoo; sum-factorised, so no (rows, npts) table is built."""
    return moment_engine(tabulator).interpolate_rows(points, coefficients)
