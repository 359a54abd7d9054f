"""Shared machinery for elements defined by explicit sympy vector bases
(trimmed serendipity, BDM on cubes).

Counterpart of ``fiat_tpu/elements/sympy_vector.py``: the whole basis array
is lambdified once per derivative multi-index, in the same expression
order as fiat_tpu, and evaluated vectorised over the points."""

import numbers

import numpy as np
import sympy
from sympy import Array, diff, lambdify, symbols

from ..core.cells import flatten_reference_cube
from ..core.dualset import DualSet
from ..core.expansions import mis
from ..core.finite_element import FiniteElement

x, y, z = symbols("x y z")
variables = (x, y, z)


def tri(n):
    """The n-th triangular number (0 for n <= 0)."""
    return (n * (n + 1)) // 2 if n > 0 else 0


def cube_geometry(flat_el):
    """Per-axis hat factors and midpoint coordinates of a flat cube.

    Returns (dfac, mid) with dfac[a] = (fade-out, fade-in) linear factors
    along axis a and mid[a] = the [-1, 1]-scaled coordinate."""
    verts = flat_el.get_vertices()
    dim = flat_el.get_spatial_dimension()
    dfac, mid = [], []
    for a in range(dim):
        lo, hi = verts[0][a], verts[-1][a]
        v = variables[a]
        dfac.append(((hi - v) / (hi - lo), (v - lo) / (hi - lo)))
        mid.append(2 * v - (hi + lo))
    return dfac, mid


def _symbolize_numbers(exprs):
    """Replace bare numbers with fresh symbols so lambdify broadcasts
    (constant entries would otherwise return scalars)."""
    extra_vars = {}
    out = []
    for e in exprs:
        if isinstance(e, numbers.Real) and not isinstance(e, sympy.Expr):
            if e not in extra_vars:
                extra_vars[e] = symbols(f"num_{len(extra_vars)}")
            out.append(extra_vars[e])
        else:
            e = sympy.sympify(e)
            if e.is_number:
                val = float(e)
                if val not in extra_vars:
                    extra_vars[val] = symbols(f"num_{len(extra_vars)}")
                out.append(extra_vars[val])
            else:
                out.append(e)
    return out, extra_vars


class SympyVectorElement(FiniteElement):
    """A vector-valued element given by an explicit sympy basis list.

    ``basis_list`` is a sequence of dim-tuples of sympy expressions in
    x, y, z; ``entity_ids`` assigns consecutive basis indices to cell
    entities.  There is no Ciarlet dual: DoF functionals are implicit
    (the dual has placeholder nodes), exactly as in the reference."""

    def __init__(self, ref_el, degree, mapping, formdegree, basis_list,
                 entity_ids):
        flat_el = flatten_reference_cube(ref_el)
        dim = flat_el.get_spatial_dimension()
        self.fdim = dim
        self.flat_el = flat_el
        nbf = len(basis_list)
        assigned = sum(len(ids) for d in entity_ids.values()
                       for ids in d.values())
        assert assigned == nbf, (assigned, nbf)
        self.basis = {(0,) * dim: Array(basis_list)}
        self._tab_cache = {}
        dual = DualSet([None] * nbf, ref_el, entity_ids)
        super().__init__(ref_el=ref_el, dual=dual, order=degree,
                         formdegree=formdegree, mapping=mapping)

    def degree(self):
        return self.get_order()

    def value_shape(self):
        return (self.fdim,)

    def dual_basis(self):
        raise NotImplementedError(
            f"dual_basis is not implemented for {type(self).__name__}")

    def get_coeffs(self):
        raise NotImplementedError(
            f"get_coeffs not implemented for {type(self).__name__}")

    def _callable_for(self, alpha):
        try:
            return self._tab_cache[alpha]
        except KeyError:
            pass
        zr = (0,) * self.fdim
        if alpha == zr:
            polys = self.basis[zr]
        else:
            polys = self.basis.get(alpha)
            if polys is None:
                polys = diff(self.basis[zr], *zip(variables, alpha))
                self.basis[alpha] = polys
        flat = [e for row in polys.tolist() for e in row]
        exprs, extra_vars = _symbolize_numbers(flat)
        fn = lambdify(variables[:self.fdim] + tuple(extra_vars.values()),
                      exprs, modules="numpy", dummify=True)
        self._tab_cache[alpha] = (fn, extra_vars)
        return fn, extra_vars

    def tabulate(self, order, points, entity=None):
        if entity is None:
            entity = (self.ref_el.get_dimension(), 0)
        entity_dim, entity_id = entity
        transform = self.ref_el.get_entity_transform(entity_dim, entity_id)
        points = np.asarray(transform(points))
        npts = points.shape[0]
        nbf = self.space_dimension()

        phivals = {}
        for o in range(order + 1):
            for alpha in mis(self.fdim, o):
                fn, extra_vars = self._callable_for(alpha)
                args = [points[:, i] for i in range(self.fdim)]
                args += [np.full(npts, float(v)) for v in extra_vars]
                vals = fn(*args)
                T = np.zeros((nbf * self.fdim, npts))
                for i, v in enumerate(vals):
                    T[i] = v
                phivals[alpha] = T.reshape(nbf, self.fdim, npts)
        return phivals
