"""Orthogonal-polynomial utilities: recurrence coefficients and
Golub-Welsch quadrature.

Counterpart of ``fiat_tpu/core/orthopoly.py`` (after Gautschi's OPQ
suite): Gauss and Gauss-Lobatto rules from three-term recurrence
coefficients, Jacobi recurrences on [-1,1] and [0,1], modified Chebyshev
for general weights, and the logarithmic weight recurrence.  Host-side
construction utilities; the element rules come from
``core/recursive_nodes.py``."""

from math import gamma

import numpy as np


def gauss(alpha, beta):
    """Gauss nodes/weights from recurrence coefficients (Golub-Welsch):
    eigendecompose the symmetric Jacobi matrix; weights are beta[0]
    times the squared first components of the eigenvectors."""
    J = np.diag(np.sqrt(beta[1:]), 1) + np.diag(alpha)
    x, V = np.linalg.eigh(J, "U")
    w = beta[0] * V[0, :] ** 2
    return x, w


def lobatto(alpha, beta, xl1, xl2):
    """Lobatto nodes/weights with preassigned endpoints xl1, xl2
    (Golub 1973, section 7): modify the trailing recurrence
    coefficients so both endpoints become eigenvalues."""
    alpha = np.array(alpha, dtype=float)
    beta = np.array(beta, dtype=float)
    n = len(alpha) - 1
    en = np.zeros(n)
    en[-1] = 1
    rb = np.sqrt(beta)

    def tail_solve(shift):
        J = (np.diag(rb[1:-1], 1) + np.diag(alpha[1:] - shift)
             + np.diag(rb[1:-1], -1))
        return np.linalg.solve(J, en)

    g1 = tail_solve(xl1)
    g2 = tail_solve(xl2)
    C = np.array(((1.0, -g1[-1]), (1.0, -g2[-1])))
    ab = np.linalg.solve(C, np.array((xl1, xl2)))
    alpha[-1] = ab[0]
    beta[-1] = ab[1]
    return gauss(alpha, beta)


def rec_jacobi(N, a, b):
    """Recurrence coefficients (alpha_k, beta_k) of the monic Jacobi
    polynomials orthogonal wrt (1-x)^a (1+x)^b on [-1, 1]:
    P_{k+1} = (x - alpha_k) P_k - beta_k P_{k-1}."""
    apb = a + b
    alpha = np.zeros(N)
    beta = np.zeros(N)
    beta[0] = 2.0 ** (apb + 1) * gamma(a + 1) * gamma(b + 1) \
        / gamma(apb + 2)
    if N > 0:
        alpha[0] = (b - a) / (apb + 2)
    if N > 1:
        alpha[1] = (b ** 2 - a ** 2) / ((apb + 2) * (apb + 4))
        beta[1] = 4 * (a + 1) * (b + 1) / ((apb + 2) ** 2 * (apb + 3))
    k = np.arange(2.0, N)
    alpha[2:] = (b ** 2 - a ** 2) / ((2 * k + apb) * (2 * k + apb + 2))
    beta[2:] = (4 * k * (k + a) * (k + b) * (k + apb)
                / ((2 * k + apb) ** 2 * (2 * k + apb + 1)
                   * (2 * k + apb - 1)))
    return alpha, beta


def rec_jacobi01(N, a, b):
    """Jacobi recurrence coefficients rescaled to [0, 1]."""
    alpha, beta = rec_jacobi(N, a, b)
    alpha01 = (1 + alpha) / 2
    beta01 = beta / 4
    beta01[0] = beta[0] / 2 ** (a + b + 1)
    return alpha01, beta01


def polyval(alpha, beta, x):
    """Evaluate the (normalized-start) orthogonal polynomial sequence
    defined by (alpha, beta) at x; returns array (len(alpha)+1, len(x))
    with row k = P_k(x) of the monic recurrence started at P_0 = 1."""
    x = np.asarray(x, dtype=float)
    N = len(alpha)
    P = np.zeros((N + 1,) + x.shape)
    P[0] = 1.0
    if N > 0:
        P[1] = (x - alpha[0]) * P[0]
    for k in range(1, N):
        P[k + 1] = (x - alpha[k]) * P[k] - beta[k] * P[k - 1]
    return P


def jacobi(N, a, b, x, NOPT=1):
    """Batch-evaluate the classically normalized Jacobi polynomials
    P_k^{a,b} at x (L2-normalized if NOPT == 2); returns (len(x), N+1)."""
    from .jacobi import eval_jacobi_batch
    x = np.asarray(x, dtype=float)
    P = eval_jacobi_batch(a, b, N, x[:, None]).T  # (npts, N+1)
    if NOPT == 2:
        pnorm = np.array([2.0 ** (a + b + 1) * gamma(k + a + 1)
                          * gamma(k + b + 1)
                          / ((2 * k + a + b + 1) * gamma(k + 1)
                             * gamma(k + a + b + 1))
                          for k in range(N + 1)])
        P = P / np.sqrt(pnorm)
    return P


def mod_chebyshev(N, mom, alpham, betam):
    """Modified Chebyshev algorithm (Gautschi): recurrence coefficients
    of the polynomials orthogonal wrt a weight given by its 2N modified
    moments against the auxiliary recurrence (alpham, betam)."""
    mom = np.asarray(mom, dtype=float)
    alpha = np.zeros(N)
    beta = np.zeros(N)
    sig = np.zeros((N + 1, 2 * N))
    sig[1, :] = mom[: 2 * N]
    alpha[0] = alpham[0] + mom[1] / mom[0]
    beta[0] = mom[0]
    for k in range(1, N):
        for ell in range(k, 2 * N - k):
            sig[k + 1, ell] = (sig[k, ell + 1]
                               + (alpham[ell] - alpha[k - 1]) * sig[k, ell]
                               - beta[k - 1] * sig[k - 1, ell]
                               + betam[ell] * sig[k, ell - 1])
        alpha[k] = (alpham[k] + sig[k + 1, k + 1] / sig[k + 1, k]
                    - sig[k, k] / sig[k, k - 1])
        beta[k] = sig[k + 1, k] / sig[k, k - 1]
    return alpha, beta


def jacobiD(N, a, b, x, NOPT=1):
    """First derivatives of the Jacobi polynomials at x, via the
    derivative identity d/dx P_n^{a,b} = (n+a+b+1)/2 P_{n-1}^{a+1,b+1};
    returns (len(x), N+1)."""
    x = np.asarray(x, dtype=float)
    z = np.zeros((len(x), 1))
    if N == 0:
        return z
    inner = jacobi(N - 1, a + 1, b + 1, x, NOPT)
    return 0.5 * np.hstack((z, inner * (a + b + 2 + np.arange(N))))


def mm_log(N, a):
    """Analytic modified moments of the weight x^a log(1/x) on [0, 1]
    against monic shifted Legendre polynomials (Gautschi 1979, Math.
    Comp. 33:742-743)."""
    if a <= -1:
        raise ValueError("Parameter a must be greater than -1")
    mm = np.zeros(N)
    c = 1.0
    for n in range(N):
        if isinstance(a, (int, np.integer)) and a < n:
            num = 1.0
            for p in range(n - a, n + a + 2):
                num *= p
            mm[n] = (-1.0) ** (n - a) / num * gamma(a + 1) ** 2
        elif n == 0:
            mm[0] = 1.0 / (a + 1) ** 2
        else:
            k = np.arange(1, n + 1)
            s = np.sum(1.0 / (a + 1 + k) - 1.0 / (a + 1 - k))
            p = np.prod((a + 1 - k) / (a + 1 + k))
            mm[n] = (1.0 / (a + 1) + s) * p / (a + 1)
        mm[n] *= c
        c *= 0.5 * (n + 1) / (2 * n + 1)
    return mm


def rec_jaclog(N, a):
    """Recurrence coefficients of monic polynomials orthogonal on
    [0, 1] wrt the weight x^a * log(1/x), via modified Chebyshev
    against the shifted-Legendre basis."""
    alphaj, betaj = rec_jacobi01(2 * N, 0, 0)
    return mod_chebyshev(N, mm_log(2 * N, a), alphaj, betaj)
