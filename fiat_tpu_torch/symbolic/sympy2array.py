"""Evaluate sympy expressions against array-valued symbol bindings.

Counterpart of ``fiat_tpu/symbolic/sympy2array.py`` (role of FInAT's
``finat/sympy2gem.py``): where FInAT rewrites sympy trees into gem
expression DAGs, the tree is evaluated directly on the bound arrays --
host numpy, or torch tensors on their device, where fiat_tpu binds
traced jax arrays -- as ordinary array operations.  Used by runtime
symbolic elements (DirectSerendipity) and anywhere a sympy-defined basis
must be evaluated at tensor physical geometry.  Constants become python
floats from sympy's numbers; no tensor is ever read back to the host."""

import numpy as np
import sympy
import torch

from .point_set import _is_traced


def _where(cond, a, b):
    """``np.where``, or ``torch.where`` where any operand is a tensor (the
    others join it on its device; fiat_tpu's ``np.where`` raises on a
    traced condition)."""
    tensors = [x for x in (cond, a, b) if _is_traced(x)]
    if not tensors:
        return np.where(cond, a, b)
    dev = tensors[0].device
    a, b = (x if _is_traced(x) else torch.as_tensor(x, dtype=torch.float64, device=dev)
            for x in (a, b))
    return torch.where(torch.as_tensor(cond, device=dev), a, b)


def evaluate_sympy(expr, bindings, cache=None):
    """Evaluate ``expr`` with ``bindings`` mapping sympy Symbols to
    array-like (or scalar) values.  Returns an array/scalar; arrays
    broadcast elementwise exactly as the expression tree dictates."""
    if cache is None:
        cache = {}
    return _eval(expr, bindings, cache)


def _eval(node, bindings, cache):
    key = node
    try:
        return cache[key]
    except (KeyError, TypeError):
        pass
    result = _eval_node(node, bindings, cache)
    try:
        cache[key] = result
    except TypeError:
        pass
    return result


def _eval_node(node, bindings, cache):
    if isinstance(node, (int, float)):
        return float(node)
    if isinstance(node, sympy.Symbol):
        try:
            return bindings[node]
        except KeyError:
            raise ValueError(f"Unbound symbol: {node}")
    if isinstance(node, sympy.Integer):
        return float(node)
    if isinstance(node, sympy.Float):
        return float(node)
    if isinstance(node, sympy.Rational):
        return float(node.p) / float(node.q)
    if isinstance(node, sympy.Add):
        result = _eval(node.args[0], bindings, cache)
        for arg in node.args[1:]:
            result = result + _eval(arg, bindings, cache)
        return result
    if isinstance(node, sympy.Mul):
        result = _eval(node.args[0], bindings, cache)
        for arg in node.args[1:]:
            result = result * _eval(arg, bindings, cache)
        return result
    if isinstance(node, sympy.Pow):
        base = _eval(node.base, bindings, cache)
        exp = node.exp
        if exp.is_Integer:
            n = int(exp)
            if n < 0:
                return 1.0 / (base ** (-n))
            return base ** n
        return base ** _eval(exp, bindings, cache)
    if isinstance(node, sympy.Abs):
        return abs(_eval(node.args[0], bindings, cache))
    if isinstance(node, sympy.Piecewise):
        # right-fold into nested where()
        pieces = [(_eval(e, bindings, cache), _eval(c, bindings, cache))
                  for e, c in node.args]
        result = pieces[-1][0]
        for val, cond in reversed(pieces[:-1]):
            result = _where(cond, val, result)
        return result
    if isinstance(node, (sympy.StrictLessThan, sympy.StrictGreaterThan,
                         sympy.LessThan, sympy.GreaterThan, sympy.Equality,
                         sympy.Unequality)):
        a = _eval(node.args[0], bindings, cache)
        b = _eval(node.args[1], bindings, cache)
        ops = {sympy.StrictLessThan: lambda u, v: u < v,
               sympy.StrictGreaterThan: lambda u, v: u > v,
               sympy.LessThan: lambda u, v: u <= v,
               sympy.GreaterThan: lambda u, v: u >= v,
               sympy.Equality: lambda u, v: u == v,
               sympy.Unequality: lambda u, v: u != v}
        return ops[type(node)](a, b)
    if node is sympy.true:
        return True
    if node is sympy.false:
        return False
    if isinstance(node, sympy.Expr) and node.is_number:
        return float(node)
    raise NotImplementedError(
        f"No array evaluation rule for {type(node).__name__}: {node}")
