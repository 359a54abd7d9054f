"""Recursively defined interpolation nodes on simplices.

Counterpart of ``fiat_tpu/core/recursive_nodes.py``: T. Isaac's recursive,
parameter-free node construction ("Recursive, parameter-free, explicitly
defined interpolation nodes for simplices", SISC 2020).  Host-side float64
numpy; node sets are small static data that parameterise the kernels.

Supported 1D families (on [0, 1]):
  * ``equi``          -- equispaced, including endpoints
  * ``equi_interior`` -- equispaced, excluding endpoints
  * ``lgl``           -- Lobatto-Gauss-Legendre (spectral) nodes
  * ``gl``            -- Gauss-Legendre (interior) nodes
  * ``lgc``           -- Lobatto-Gauss-Chebyshev nodes
  * ``gc``            -- Gauss-Chebyshev (interior) nodes
"""

import math
from functools import lru_cache

import numpy as np


def gauss_jacobi_rule(m, a=0.0, b=0.0):
    """Gauss-Jacobi quadrature: m points/weights on [-1, 1] for weight
    (1-x)^a (1+x)^b, via the Golub-Welsch symmetric-tridiagonal eigensolve
    followed by two Newton refinement sweeps for last-bit accuracy."""
    if m == 0:
        return np.zeros(0), np.zeros(0)
    k = np.arange(m, dtype=np.float64)
    apb = a + b
    with np.errstate(invalid="ignore", divide="ignore"):
        alpha = (b * b - a * a) / ((2 * k + apb) * (2 * k + apb + 2))
    if apb == 0 or apb == -1:
        alpha[0] = (b - a) / (apb + 2)
    beta = np.zeros(m)
    kk = k[1:]
    beta[1:] = (4 * kk * (kk + a) * (kk + b) * (kk + apb)
                / ((2 * kk + apb) ** 2 * (2 * kk + apb + 1) * (2 * kk + apb - 1)))
    if m > 1 and apb == 0:
        beta[1] = 4 * (1 + a) * (1 + b) / ((2 + apb) ** 2 * (3 + apb))
    T = np.diag(alpha) + np.diag(np.sqrt(beta[1:]), 1) + np.diag(np.sqrt(beta[1:]), -1)
    x, V = np.linalg.eigh(T)
    mu0 = 2.0 ** (apb + 1) * math.gamma(a + 1) * math.gamma(b + 1) / math.gamma(apb + 2)
    w = mu0 * V[0, :] ** 2

    for _ in range(2):
        p, dp = _jacobi_and_derivative(m, a, b, x)
        x = x - p / dp
    # w_j = G / ((1-x_j^2) [d/dx P_m^{a,b}(x_j)]^2),
    # G = 2^{a+b+1} Gamma(m+a+1) Gamma(m+b+1) / (m! Gamma(m+a+b+1)).
    if m > 1:
        _, dp = _jacobi_and_derivative(m, a, b, x)
        G = (2.0 ** (apb + 1) * math.gamma(m + a + 1) * math.gamma(m + b + 1)
             / (math.gamma(m + 1) * math.gamma(m + apb + 1)))
        w = G / ((1 - x ** 2) * dp ** 2)
    return x, w


def _jacobi_and_derivative(n, a, b, x):
    """Values and first derivatives of the Jacobi polynomial P_n^{a,b}."""
    pm1 = np.ones_like(x)
    if n == 0:
        return pm1, np.zeros_like(x)
    p = 0.5 * (a - b + (a + b + 2) * x)
    for k in range(2, n + 1):
        a1 = 2 * k * (k + a + b) * (2 * k + a + b - 2)
        a2 = (2 * k + a + b - 1) * (a * a - b * b)
        a3 = (2 * k + a + b - 2) * (2 * k + a + b - 1) * (2 * k + a + b)
        a4 = 2 * (k + a - 1) * (k + b - 1) * (2 * k + a + b)
        p, pm1 = ((a2 + a3 * x) * p - a4 * pm1) / a1, p
    if n == 1:
        dp = np.full_like(x, 0.5 * (a + b + 2))
    else:
        dpm1, _ = _jacobi_and_derivative(n - 1, a + 1, b + 1, x)
        dp = 0.5 * (a + b + n + 1) * dpm1
    return p, dp


def gauss_lobatto_jacobi_rule(m, a=0.0, b=0.0):
    """Lobatto-Gauss-Jacobi rule: m >= 2 points on [-1, 1] including both
    endpoints, exact to degree 2m-3 (for a = b = 0)."""
    if m < 2:
        raise ValueError("Lobatto rules need at least 2 points")
    xi, _ = gauss_jacobi_rule(m - 2, a + 1, b + 1)
    x = np.concatenate(([-1.0], xi, [1.0]))
    if a == 0 and b == 0:
        # classical GLL weights: w_i = 2 / (n(n+1) P_n(x_i)^2), n = m-1
        n = m - 1
        p, _ = _jacobi_and_derivative(n, 0.0, 0.0, x)
        w = 2.0 / (n * (n + 1) * p ** 2)
    else:
        # generic Lobatto weights from the Vandermonde moment system
        V = np.polynomial.legendre.legvander(x, m - 1).T
        moments = np.zeros(m)
        for j in range(m):
            c = np.zeros(j + 1)
            c[j] = 1.0
            moments[j] = _jacobi_weighted_legendre_moment(c, a, b)
        w = np.linalg.solve(V, moments)
    return x, w


def _jacobi_weighted_legendre_moment(c, a, b):
    """integral_{-1}^{1} (1-x)^a (1+x)^b  P(x) dx for Legendre series c."""
    gq, gw = gauss_jacobi_rule(len(c) // 2 + 2, a, b)
    return float(np.dot(np.polynomial.legendre.legval(gq, c), gw))


def collapsed_gauss_simplex(dim, m):
    """Collapsed (Duffy-mapped) Gauss rule with m points per direction on
    the default (-1,1)-vertex dim-simplex: a product of Gauss-Jacobi rules
    whose (1-eta_k)^k weights absorb the Duffy Jacobian powers."""
    lines = [gauss_jacobi_rule(m, float(k), 0.0) for k in range(dim)]
    pts = np.zeros((m,) * dim + (dim,))
    wts = np.ones((m,) * dim)
    etas = np.meshgrid(*[x for x, _ in lines], indexing="ij")
    for k in range(dim):
        shape = [1] * dim
        shape[k] = m
        wts = wts * (lines[k][1] / 2.0 ** k).reshape(shape)
    for k in range(dim):
        xi = 1.0 + etas[k]
        for j in range(k + 1, dim):
            xi = xi * (1.0 - etas[j]) / 2.0
        pts[..., k] = xi - 1.0
    return pts.reshape(-1, dim), wts.reshape(-1)


@lru_cache(maxsize=None)
def family_nodes_1d(family, n):
    """The n+1 nodes of a 1D family on [0, 1] for polynomial degree n."""
    if n < 0:
        raise ValueError("degree must be nonnegative")
    if family == "equi":
        if n == 0:
            return (0.5,)
        return tuple(np.linspace(0.0, 1.0, n + 1))
    if family == "equi_interior":
        h = 1.0 / (n + 1 + 1)
        return tuple(h * (1.0 + np.arange(n + 1)))
    if family == "lgl":
        if n == 0:
            return (0.5,)
        if n == 1:
            return (0.0, 1.0)
        x, _ = gauss_lobatto_jacobi_rule(n + 1)
        return tuple(0.5 * (x + 1.0))
    if family == "gl":
        x, _ = gauss_jacobi_rule(n + 1)
        return tuple(0.5 * (x + 1.0))
    if family == "gc":
        k = np.arange(n + 1)
        x = -np.cos((2 * k + 1) * np.pi / (2 * n + 2))
        return tuple(0.5 * (x + 1.0))
    if family == "lgc":
        if n == 0:
            return (0.5,)
        k = np.arange(n + 1)
        x = -np.cos(k * np.pi / n)
        return tuple(0.5 * (x + 1.0))
    raise ValueError(f"Unknown 1D node family '{family}'")


@lru_cache(maxsize=None)
def _recursive_barycentric(d, n, alpha, family):
    """Barycentric coordinates (length d+1) of the node with multi-index
    ``alpha`` (sum n) on the d-simplex, by the recursive construction."""
    assert len(alpha) == d + 1 and sum(alpha) == n
    xn = family_nodes_1d(family, n)
    if d == 0:
        return (1.0,)
    if d == 1:
        return (xn[alpha[0]], xn[alpha[1]])
    b = np.zeros(d + 1)
    wsum = 0.0
    for i in range(d + 1):
        wi = xn[n - alpha[i]]
        if wi == 0.0:
            continue
        sub = alpha[:i] + alpha[i + 1:]
        br = _recursive_barycentric(d - 1, n - alpha[i], sub, family)
        keep = [j for j in range(d + 1) if j != i]
        b[keep] += wi * np.asarray(br)
        wsum += wi
    return tuple(b / wsum)


def recursive_node(d, n, alpha, family):
    """Barycentric coordinates of node ``alpha`` as an ndarray."""
    if not isinstance(family, str):
        raise ValueError(f"Unsupported family spec {family!r}")
    return np.asarray(_recursive_barycentric(d, n, tuple(alpha), family))
