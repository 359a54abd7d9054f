"""Jacobi polynomial evaluation.

Counterpart of ``fiat_tpu/core/jacobi.py``: the three-term recurrence for
P_n^{a,b} values and derivatives, batched over points (host f64 numpy).
"""

import numpy as np


def eval_jacobi(a, b, n, x):
    """P_n^{a,b}(x) by the Karniadakis & Sherwin recurrence."""
    if n == 0:
        return 0.0 * x + 1.0
    pm1 = 0.0 * x + 1.0
    p = 0.5 * (a - b + (a + b + 2.0) * x)
    for k in range(2, n + 1):
        a1 = 2.0 * k * (k + a + b) * (2.0 * k + a + b - 2.0)
        a2 = (2.0 * k + a + b - 1.0) * (a * a - b * b) / a1
        a3 = (2.0 * k + a + b - 2.0) * (2.0 * k + a + b - 1.0) * (2.0 * k + a + b) / a1
        a4 = 2.0 * (k + a - 1.0) * (k + b - 1.0) * (2.0 * k + a + b) / a1
        p, pm1 = (a2 + a3 * x) * p - a4 * pm1, p
    return p


def eval_jacobi_batch(a, b, n, xs):
    """Rows 0..n of P_k^{a,b} tabulated at the points xs (last axis is the
    coordinate axis of each point)."""
    xs = np.asarray(xs)
    x = xs.reshape(xs.shape[:-1])
    rows = [np.ones_like(x)]
    if n > 0:
        rows.append(0.5 * (a - b + (a + b + 2.0) * x))
        for k in range(2, n + 1):
            a1 = 2.0 * k * (k + a + b) * (2.0 * k + a + b - 2.0)
            a2 = (2.0 * k + a + b - 1.0) * (a * a - b * b) / a1
            a3 = (2.0 * k + a + b - 2.0) * (2.0 * k + a + b - 1.0) * (2.0 * k + a + b) / a1
            a4 = 2.0 * (k + a - 1.0) * (k + b - 1.0) * (2.0 * k + a + b) / a1
            rows.append((a2 + a3 * x) * rows[-1] - a4 * rows[-2])
    return np.stack(rows)


def eval_jacobi_deriv_batch(a, b, n, xs, order=1):
    """order-th derivatives of rows 0..n of P_k^{a,b} at points xs."""
    xs = np.asarray(xs)
    out = np.zeros((n + 1, len(xs)), xs.dtype)
    if n + 1 <= order:
        return out
    out[order:, :] = eval_jacobi_batch(a + order, b + order, n - order, xs)
    for j in range(order, n + 1):
        z = 1.0
        for l in range(order):
            z *= 0.5 * (a + b + j + 1 + l)
        out[j, :] *= z
    return out
