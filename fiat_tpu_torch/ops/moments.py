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
every program's in one block).  Macro programs off the zoo's parent
basis go by route (``fused_zoo.partition_macro_programs``): a K45 and a K3
for each further group, PyTorch for a program on a variant parent.  The
small products around them stay ``torch.matmul``, as fiat_tpu leaves them
to XLA.  Both directions take intervals, triangles and tetrahedra, plain
and macro.

The engine is built once per tabulator and cached on it; it runs on
``tabulator.device`` (a CUDA device, the default: the kernels; the CPU,
where the tabulator was asked for it: their plain PyTorch versions).  The
host checks of the macro programs run when the engine is built; each
kernel wrapper is built on the first call that needs it (K45 on the first
moments, K3 on the first interpolation of a macro zoo) and kept.
"""

import numpy as np
import torch

from .fused_zoo import masked_parent, merge_group, partition_macro_programs, unique_binning
from .kernels import resolve_device
from .macro_oneshot import MacroOneShot
from .moment_kernel import PairMoments
from .recurrence import DubinerRecurrence


class MomentEngine:
    """Moments and interpolation over every basis row of a zoo, in the
    ``BatchedTabulator`` row layout (plain rows, then the macro elements').

    The macro programs go by route (``fused_zoo.partition_macro_programs``):
    the group on the zoo's parent basis shares K45's launch with the plain
    sums, any other group of one parent basis has a K45 launch of its own
    (and a K3 for interpolation), and a program on a variant parent is
    contracted in PyTorch (its masked parent by the weights), as fiat_tpu's
    engines leave such a program to XLA.

    ``moments`` (the first K45) and ``recurrence`` (K1) carry the launch
    counts; ``moment_kernels`` and ``macros`` list every K45 and K3 of the
    routes (``program_columns``: each merged route's one-row selection of
    its programs' columns).
    The K45s and K3s are built on first use, by whichever reads them first,
    and ``built`` says which exist."""

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
        # the routes in the order of the sums: the group on the zoo's basis
        # (its sums follow the plain ones in the first K45), the other
        # groups (a K45 each), the variant programs (PyTorch)
        routes = sorted(partition_macro_programs(programs, scale, affine_map),
                        key=lambda r: (not r[2], r[0] != "merged"))
        #: per K45 launch its arguments (the first also sums the plain rows)
        self._k45_args = [[max_degree, self.nexp, scale, affine_map, (), None, ()]]
        self._moments = self._macros = None
        #: per route: (kind, program indices, merged arrays or None, its
        #: columns of the sums)
        self.routes = []
        # moments = matrix @ (the sums): the value rows of every plain
        # element over pw, and of every macro element over its route's sums
        # (fiat_tpu's stacked @ pw and tall[:rows] @ (bw * ratio))
        blocks, col = [], self.nexp
        for kind, members, on_zoo in routes:
            progs = [programs[g] for g in members]
            if kind == "merged":
                merged = merge_group(progs, 0, engine="the fused moments engine (K45)")
                args = [merged["degree"], 0, merged["scale"], merged["affine_map"],
                        merged["geom"], merged["parent_map"], merged["pieces"]]
                if on_zoo:
                    args[:4] = [max(max_degree, merged["degree"]), self.nexp, scale, affine_map]
                    self._k45_args[0] = args
                else:
                    self._k45_args.append(args)
                A, firsts = merged["A"], [g["rows"][0] for g in merged["geom"]]
            else:
                merged, A, firsts = None, progs[0].tall, [0]
            self.routes.append((kind, members, merged, slice(col, col + A.shape[1])))
            blocks.extend((p, A, r0, col) for p, r0 in zip(progs, firsts))
            col += A.shape[1]
        matrix = np.zeros((self.rows, col))
        matrix[:self.plain_rows, :self.nexp] = stacked
        # a program's value rows are the first block of its tall matrix
        for p, A, r0, c0 in blocks:
            for idx, lo, hi in p.row_slices:
                flo, fhi, _ = self.slices[idx]
                if fhi - flo != hi - lo or flo < self.plain_rows:
                    raise ValueError(f"element {idx}: program rows do not match its slice")
                matrix[flo:fhi, c0:c0 + A.shape[1]] = A[r0 + lo:r0 + hi]
        self.matrix = torch.as_tensor(matrix, device=self.device)
        #: per merged route, program g's columns of its folded coefficients
        #: (interpolation: one K3 row a program)
        self.program_columns = []
        for kind, members, merged, cols in self.routes:
            if merged is None:
                continue
            pc = np.zeros((len(members), cols.stop - cols.start))
            c0 = 0
            for j, g in enumerate(members):
                pc[j, c0:c0 + programs[g].K] = 1.0
                c0 += programs[g].K
            self.program_columns.append(torch.as_tensor(pc, device=self.device))
        self._variants = [(programs[members[0]], cols)
                          for kind, members, _, cols in self.routes if kind == "variant"]

    @property
    def moment_kernels(self):
        """Every K45 (``PairMoments``) of the engine, built on first use:
        the first sums the plain rows and the group on the zoo's basis."""
        if self._moments is None:
            self._moments = [PairMoments(*args, self.device) for args in self._k45_args]
        return self._moments

    @property
    def moments(self):
        """The first K45 (the plain sums), built on first use."""
        return self.moment_kernels[0]

    @property
    def macros(self):
        """A K3 (``MacroOneShot``) per merged route, for interpolation,
        built on first use."""
        if self._macros is None:
            self._macros = [MacroOneShot(**merged, device=self.device)
                            for _, _, merged, _ in self.routes if merged is not None]
        return self._macros

    @property
    def built(self):
        """Which of the wrappers built on first use exist: {"moments": bool,
        "macro": bool}."""
        return {"moments": self._moments is not None, "macro": bool(self._macros)}

    def _tensor(self, x, name):
        """Host (numpy) data go to the engine's device; a tensor must
        already be there: the engine never moves the work to another device."""
        if isinstance(x, torch.Tensor) and x.device != self.device:
            raise ValueError(f"{name} on {x.device}, engine on {self.device}")
        return torch.as_tensor(x, dtype=torch.float64, device=self.device).contiguous()

    def sums(self, points, wf):
        """The sums the moments multiply: every K45's, then each variant
        program's masked parent by the weights."""
        out = [pm(points, wf) for pm in self.moment_kernels]
        out += [masked_parent(p, points, unique_binning(p, 0)) @ wf for p, _ in self._variants]
        return out[0] if len(out) == 1 else torch.cat(out)

    def moment_rows(self, points, wf):
        """(rows,) float64: M[i] = sum_q phi_i(x_q) wf_q for every basis row."""
        return self.matrix @ self.sums(self._tensor(points, "points"), self._tensor(wf, "wf"))

    def interpolate_rows(self, points, coefficients):
        """(npts,) float64: u(x_q) = sum_i c_i phi_i(x_q)."""
        pts, c = self._tensor(points, "points"), self._tensor(coefficients, "coefficients")
        if tuple(c.shape) != (self.rows,):
            raise ValueError(f"coefficients must have shape ({self.rows},), got {tuple(c.shape)}")
        folded = c @ self.matrix            # the transpose of moment_rows
        out = folded[:self.nexp] @ self.recurrence(pts)
        merged = [cols for _, _, m, cols in self.routes if m is not None]
        for mo, cols, pc in zip(self.macros if merged else (), merged, self.program_columns):
            out = out + mo(pts, A=pc * folded[cols]).sum(dim=0)
        for p, cols in self._variants:
            out = out + folded[cols] @ masked_parent(p, pts, unique_binning(p, 0))
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
