"""K8: Bernstein features as a hand-written CUDA kernel, the B operand that
replaces the Dubiner recurrence (K1) for single-width zoos.

Counterpart of ``fiat_tpu/ops/pallas_bernstein.py``.  The degree-d
Bernstein polynomials span the same P_d as the Dubiner basis, and each is
one product of barycentric powers,

    B_e(x) = multinomial(d; e) * prod_i lam_i(x)^e_i,

so a zoo whose rows all contract the full degree-d basis can contract
Bernstein features instead, with the change of basis M (Dubiner = M @
Bernstein, ``bernstein_conversion``) folded into its rows on the host.
Bernstein features are not degree-graded, which is why only a zoo with a
single full-width group can use them (``FusedZooTabulator(...,
features="bernstein")``).

The TPU kernel's packing (``_group_pack``'s exponent bit masks and its
f32-exactness assert), its df32 chains (``emit_bernstein``) and its window
split (``slice_split_ff``) serve the TPU's lack of f64 and are not ported:
``csrc/bernstein.cu`` computes the f64 features directly.  The plain
version beside it is fiat_tpu's ``xla_f64`` in torch; the wrapper runs it
for CPU tensors only.  For a CUDA tensor it launches the kernel or raises.
"""

import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core.cells import default_simplex
from ..core.expansions import ExpansionSet
from ..core.quadrature import make_quadrature
from .kernels import check_launch, load_kernels, resolve_device, stream_of

#: the top of the unrolled instantiations per spatial dimension
#: (csrc/bernstein.cu's switch); past them one generic instantiation takes
#: the degree at the launch
UNROLLED_DEGREE = {1: 15, 2: 15, 3: 10}
#: the highest degree per spatial dimension, fiat_tpu's (its K8 packs the
#: multinomials as exact float32 integers, below 2^24, and refuses past
#: them); past it ``features="bernstein"`` raises by name
MAX_DEGREE = {1: 26, 2: 17, 3: 15}


def bernstein_multiindices(sd, degree):
    """Barycentric exponent tuples of the degree-``degree`` Bernstein
    basis on the ``sd``-simplex, in lexicographic order of the leading
    ``sd`` exponents (the module-wide row order)."""
    if sd == 1:
        return [(a, degree - a) for a in range(degree + 1)]
    if sd == 2:
        return [(a, b, degree - a - b)
                for a in range(degree + 1)
                for b in range(degree + 1 - a)]
    if sd == 3:
        return [(a, b, c, degree - a - b - c)
                for a in range(degree + 1)
                for b in range(degree + 1 - a)
                for c in range(degree + 1 - a - b)]
    raise NotImplementedError(f"Bernstein features: sd={sd}")


def multinomial(degree, mi):
    out = math.factorial(degree)
    for e in mi:
        out //= math.factorial(e)
    return out


def ld_matmul(a, b, workers=None):
    """``a @ b`` in longdouble, bit for bit as numpy's ``matmul`` computes it
    for that type (no BLAS: each entry summed from 0 in the order of k, each
    product rounded to longdouble before it is added), but as k outer
    products, each on a block of rows in its own thread (numpy releases
    the GIL in its longdouble loops): the same additions in the same order,
    a vector operation each.  ``workers`` threads (the CPU count when
    None)."""
    a, b = np.asarray(a, np.longdouble), np.asarray(b, np.longdouble)
    out = np.zeros((a.shape[0], b.shape[1]), np.longdouble)
    workers = max(1, min(workers or os.cpu_count() or 1, a.shape[0]))
    bounds = np.linspace(0, a.shape[0], workers + 1).astype(int)

    def rows(lo, hi):
        acc, tmp = out[lo:hi], np.empty((hi - lo, b.shape[1]), np.longdouble)
        for k in range(a.shape[1]):
            np.multiply(a[lo:hi, k, None], b[k], out=tmp)
            acc += tmp

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(rows, bounds[:-1], bounds[1:]))
    return out


def bernstein_conversion(es, degree):
    """(nexp, nexp) matrix M with ``es.tabulate(degree, X) == M @
    bernstein(X)`` to ~1e-13, in longdouble: Gram projection of the scaled
    Dubiner basis onto the Bernstein basis (quadrature exact at
    2*degree), with two refinement steps against the Bernstein Gram.  The
    longdouble products go through ``ld_matmul`` (fiat_tpu's matrix, bit
    for bit, in a fraction of the time: tet degree 15's Gram matrices are
    816 x 4096 x 816)."""
    ld = np.longdouble
    cell = es.ref_el
    sd = cell.get_spatial_dimension()
    nexp = es.get_num_members(degree)
    mis = bernstein_multiindices(sd, degree)
    assert len(mis) == nexp
    Q = make_quadrature(cell, degree + 1)
    Xq = np.asarray(Q.get_points())
    W = np.asarray(Q.get_weights()).astype(ld)
    B = _bernstein_host(cell, degree, Xq, ld)
    Phi = np.asarray(es.tabulate(degree, Xq)).astype(ld)[:nexp]
    GB = ld_matmul(B * W, B.T)
    PB = ld_matmul(Phi * W, B.T)
    GB64 = GB.astype(np.float64)
    M = np.linalg.solve(GB64, PB.astype(np.float64).T).T.astype(ld)
    for _ in range(2):
        R = PB - ld_matmul(M, GB)
        M = M + np.linalg.solve(GB64, R.astype(np.float64).T).T
    return M


def _bary_map(cell):
    """Affine x -> barycentric map (A, c): lam = A x + c."""
    verts = np.asarray(cell.get_vertices())
    T = np.linalg.inv(np.vstack([verts.T, np.ones(len(verts))]))
    return T[:, :-1], T[:, -1]


def _bernstein_host(cell, degree, X, dtype=np.float64):
    """(nexp, npts) host Bernstein tabulation (tests + conversion)."""
    sd = cell.get_spatial_dimension()
    A, c = _bary_map(cell)
    lam = (np.asarray(X, dtype) @ A.T.astype(dtype) + c.astype(dtype))
    out = np.empty((len(bernstein_multiindices(sd, degree)), len(X)), dtype)
    for k, mi in enumerate(bernstein_multiindices(sd, degree)):
        row = dtype(multinomial(degree, mi))
        for i, e in enumerate(mi):
            row = row * lam[:, i] ** e
        out[k] = row
    return out


def bernstein_operand(sd, degree, scale, affine_map):
    """The engine's host arrays of the Bernstein route, for a zoo whose
    cell maps onto the default simplex by ``affine_map`` (A, b): M (nexp,
    nexp) longdouble with Phi = M @ B (Phi the degree-``degree`` Dubiner
    basis at ``scale``), and the cell's barycentric map (A_l, c_l).  Both
    come from the default simplex: the affine map takes vertex i to vertex
    i, so the Bernstein basis of the cell at x is the default simplex's at
    A x + b."""
    base = default_simplex(sd)
    es = ExpansionSet(base)
    M = bernstein_conversion(es, degree) * (float(scale) / float(es.get_scale(degree)))
    Ad, cd = _bary_map(base)
    A, b = (np.asarray(v, np.float64) for v in affine_map)
    return M, (Ad @ A, Ad @ b + cd)


class BernsteinFeatures:
    """``feat = BernsteinFeatures(sd, degree, (A, c), device)``; ``B =
    feat(points)`` is the (nexp, npts) float64 tabulation of the
    degree-``degree`` Bernstein basis at ``points`` (npts, sd), float64,
    contiguous, whose barycentric coordinates are ``lam = A @ x + c``
    (A (sd+1, sd)), rows in ``bernstein_multiindices`` order.

    ``launches`` counts kernel launches (the plain CPU path adds nothing).
    """

    def __init__(self, sd, degree, bary_map, device=None):
        if sd not in MAX_DEGREE:
            raise NotImplementedError(f"Bernstein features: sd 1-3, not sd={sd}")
        if not 0 <= degree <= MAX_DEGREE[sd]:
            raise NotImplementedError(
                f"Bernstein degree {degree} outside 0..{MAX_DEGREE[sd]} for sd = {sd} (as "
                "fiat_tpu's K8: a multinomial past 2^24)")
        self.sd = sd
        self.degree = degree
        #: whether the degree runs the generic instantiation
        self.generic = degree > UNROLLED_DEGREE[sd]
        self.nexp = math.comb(degree + sd, sd)
        self.mis = bernstein_multiindices(sd, degree)
        A, c = bary_map
        self.A = np.asarray(A, np.float64).reshape(sd + 1, sd)
        self.c = np.asarray(c, np.float64).reshape(sd + 1)
        self.device = resolve_device(device)
        self.bary = torch.as_tensor(np.concatenate([self.A.ravel(), self.c]), device=self.device)
        # exact integers in f64 (below 2^24 at MAX_DEGREE)
        self.coef = torch.as_tensor([float(multinomial(degree, mi)) for mi in self.mis],
                                    dtype=torch.float64, device=self.device)
        self.device = self.bary.device      # "cuda" resolved to its index
        self.launches = 0

    def _check(self, points):
        if not isinstance(points, torch.Tensor):
            raise TypeError("points must be a torch.Tensor")
        if points.dtype != torch.float64:
            raise TypeError(f"points must be float64, got {points.dtype}")
        if points.dim() != 2 or points.shape[1] != self.sd:
            raise ValueError(f"points must have shape (npts, {self.sd}), got {tuple(points.shape)}")
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
        out = torch.empty((self.nexp, npts), dtype=torch.float64, device=points.device)
        if npts == 0:
            return out
        err = load_kernels().fiat_bernstein_features(
            points.data_ptr(), npts, self.sd, self.degree, self.bary.data_ptr(),
            self.coef.data_ptr(), out.data_ptr(), stream_of(points))
        check_launch(f"fiat_bernstein_features (sd {self.sd}, degree {self.degree})", err)
        self.launches += 1
        return out

    def plain(self, points):
        """The same features in plain PyTorch, on the points' device
        (fiat_tpu's ``xla_f64``)."""
        lam = points @ points.new_tensor(self.A).T + points.new_tensor(self.c)
        pows = []
        for i in range(self.sd + 1):
            col = [torch.ones_like(lam[:, i])]
            for _ in range(self.degree):
                col.append(col[-1] * lam[:, i])
            pows.append(col)
        coef = self.coef.to(points.device)
        rows = []
        for k, mi in enumerate(self.mis):
            row = coef[k].expand_as(lam[:, 0])
            for i, e in enumerate(mi):
                if e:
                    row = row * pows[i][e]
            rows.append(row)
        return torch.stack(rows)
