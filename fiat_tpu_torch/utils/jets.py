"""Truncated Taylor-jet arithmetic over numpy arrays and torch tensors.

Counterpart of ``fiat_tpu/utils/jets.py``.  A ``Jet`` carries the partial
derivatives of a quantity with respect to ``nvars`` seed variables up to a
fixed ``order``, as a dict mapping derivative multi-indices to arrays.
Running the expansion value recurrence on jets gives exact derivatives of
any order.  Components may be numpy arrays, torch tensors or Python
scalars; only ``+ - *`` and scalar multiplication are used.  The row
helpers dispatch on the component type.
"""

import math
from itertools import product

import numpy as np
import torch


class Jet:
    """Truncated derivative jet in ``nvars`` variables up to ``order``.

    Components are TAYLOR coefficients, comps[alpha] = D^alpha f / alpha!,
    so multiplication is a plain truncated convolution; ``derivative``
    folds the factorials back in."""

    __slots__ = ("nvars", "order", "comps")

    # numpy defers to Jet's operators (ndarray * Jet -> Jet.__rmul__)
    __array_ufunc__ = None

    def __init__(self, nvars, order, comps):
        self.nvars = nvars
        self.order = order
        self.comps = comps  # dict: multi-index tuple -> array/scalar

    @staticmethod
    def variable(value, gradient, nvars, order):
        """Seed jet for a quantity with the given value and (constant)
        gradient against the seed variables."""
        comps = {(0,) * nvars: value}
        if order >= 1:
            for k in range(nvars):
                g = gradient[k]
                if _is_nonzero(g):
                    comps[tuple(1 if i == k else 0 for i in range(nvars))] = g
        return Jet(nvars, order, comps)

    def _like(self, comps):
        return Jet(self.nvars, self.order, comps)

    def __add__(self, other):
        comps = dict(self.comps)
        if isinstance(other, Jet):
            for a, v in other.comps.items():
                comps[a] = comps[a] + v if a in comps else v
            return self._like(comps)
        z = (0,) * self.nvars
        comps[z] = comps.get(z, 0.0) + other
        return self._like(comps)

    __radd__ = __add__

    def __neg__(self):
        return self._like({a: -v for a, v in self.comps.items()})

    def __sub__(self, other):
        return self + (-other)

    def __rsub__(self, other):
        return (-self) + other

    def __mul__(self, other):
        if not isinstance(other, Jet):
            if _is_nonzero(other):
                return self._like({a: v * other for a, v in self.comps.items()})
            return self._like({})
        comps = {}
        for a, u in self.comps.items():
            for b, v in other.comps.items():
                g = tuple(x + y for x, y in zip(a, b))
                if sum(g) > self.order:
                    continue
                term = u * v
                comps[g] = term if comps.get(g) is None else comps[g] + term
        return self._like(comps)

    __rmul__ = __mul__

    def derivative(self, alpha):
        """D^alpha of the quantity (None if identically zero)."""
        alpha = tuple(alpha)
        c = self.comps.get(alpha)
        if c is None:
            return None
        fact = math.prod(math.factorial(a) for a in alpha)
        return c * fact if fact != 1 else c


def _is_nonzero(g):
    return not (isinstance(g, (int, float)) and g == 0)


def _zeros_like(x):
    return torch.zeros_like(x) if isinstance(x, torch.Tensor) else np.zeros(np.shape(x))


def _cat(xs):
    if any(isinstance(x, torch.Tensor) for x in xs):
        return torch.cat(xs, dim=0)
    return np.concatenate(xs, axis=0)


def take_rows(x, idx):
    """Row-gather along axis 0 (arrays, tensors, or Jets of them)."""
    if isinstance(x, Jet):
        return x._like({k: v[idx] for k, v in x.comps.items()})
    return x[idx]


def concat_rows(xs):
    """Concatenate along axis 0; for Jets, missing components are zeros."""
    if not any(isinstance(x, Jet) for x in xs):
        return _cat(xs)
    keys = set()
    for x in xs:
        keys |= set(x.comps)
    comps = {}
    for k in keys:
        rows = []
        for x in xs:
            v = x.comps.get(k)
            rows.append(_zeros_like(next(iter(x.comps.values()))) if v is None else v)
        comps[k] = _cat(rows)
    return Jet(xs[0].nvars, xs[0].order, comps)


def matapply(D, x):
    """Left-multiply rows by a static matrix (arrays, tensors, or Jets).
    A numpy ``D`` meets a tensor operand on the operand's device."""
    def apply(v):
        if isinstance(v, torch.Tensor):
            return torch.as_tensor(D, dtype=v.dtype, device=v.device) @ v
        return D @ v
    if isinstance(x, Jet):
        return x._like({k: apply(v) for k, v in x.comps.items()})
    return apply(x)


def taylor_seeds(values, jacobian, nvars, order):
    """Seed jets for coordinates: values[i] with d(values[i])/d(var k) =
    jacobian[i][k] (constants)."""
    return [Jet.variable(values[i], [float(jacobian[i][k]) for k in range(nvars)],
                         nvars, order)
            for i in range(len(values))]


def multiindices(nvars, order):
    """All multi-indices with |alpha| <= order (graded order)."""
    out = []
    for total in range(order + 1):
        for alpha in product(range(total + 1), repeat=nvars):
            if sum(alpha) == total:
                out.append(alpha)
    return out
