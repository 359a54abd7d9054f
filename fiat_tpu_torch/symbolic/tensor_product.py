"""Symbolic tensor-product elements (counterpart of
``fiat_tpu/symbolic/tensor_product.py``, role of FInAT's
``finat/tensor_product.py``).

THE sum-factorisation structure: each factor tabulates on its own point
axis and the merged tabulation is a single einsum outer product
(``torch.einsum`` on the device for tensor tables), so a consumer keeps
the factored form (the role of FInAT's gem products + TSFC's sum
factorisation)."""

from itertools import chain, product
from operator import methodcaller

import numpy as np
import torch

from .. import elements as fe_numeric
from ..core.cells import TensorProductCell
from ..core.expansions import mis
from ..core.orientation import make_entity_permutations_tensorproduct
from .base import FiniteElementBase
from .point_set import PointSet, PointSingleton, TensorPointSet, _is_traced


def _einsum(spec, *arrays):
    """einsum: numpy unless any operand is a tensor (the others join it on
    its device, in its dtype)."""
    tensors = [a for a in arrays if _is_traced(a)]
    if not tensors:
        return np.einsum(spec, *arrays)
    like = tensors[0]
    return torch.einsum(spec, *(torch.as_tensor(a, dtype=like.dtype, device=like.device)
                                for a in arrays))


class TensorProductElement(FiniteElementBase):

    def __init__(self, factors):
        super().__init__()
        self.factors = tuple(factors)
        nonscalar = {f.value_shape for f in self.factors} - {()}
        if len(nonscalar) > 1:
            raise NotImplementedError("Only one nonscalar factor permitted!")
        self._value_shape = nonscalar.pop() if nonscalar else ()

    @property
    def cell(self):
        return TensorProductCell(*(f.cell for f in self.factors))

    @property
    def complex(self):
        return TensorProductCell(*(f.complex for f in self.factors))

    @property
    def degree(self):
        return tuple(f.degree for f in self.factors)

    @property
    def formdegree(self):
        degrees = [f.formdegree for f in self.factors]
        return None if None in degrees else sum(degrees)

    def entity_dofs(self):
        try:
            return self._entity_dofs_cache
        except AttributeError:
            self._entity_dofs_cache = productise(
                self.factors, methodcaller("entity_dofs"))
            return self._entity_dofs_cache

    def entity_support_dofs(self):
        return productise(self.factors, methodcaller("entity_support_dofs"))

    @property
    def entity_permutations(self):
        return compose_permutations(self.factors)

    def space_dimension(self):
        n = 1
        for f in self.factors:
            n *= f.space_dimension()
        return n

    @property
    def index_shape(self):
        return tuple(chain.from_iterable(f.index_shape
                                         for f in self.factors))

    @property
    def value_shape(self):
        return self._value_shape

    @property
    def fiat_equivalent(self):
        A, B = self.factors
        return fe_numeric.TensorProductElement(A.fiat_equivalent,
                                               B.fiat_equivalent)

    def _factor_entity(self, entity):
        """(dim, id) per factor for a product-cell entity spec."""
        dims, flat_id = entity if entity is not None \
            else (self.cell.get_dimension(), 0)
        counts = [len(c.get_topology()[d])
                  for c, d in zip(self.cell.cells, dims)]
        ids = np.unravel_index(flat_id, tuple(counts))
        return list(zip(dims, ids))

    def _merge_evaluations(self, factor_results, shared_points):
        """Outer-product the factor tabulations.

        :arg shared_points: True when all factors were evaluated at the SAME
            point axis (unstructured points split by coordinate); False for
            a TensorPointSet (each factor has its own point axis)."""
        order = max(map(sum, chain(*factor_results)))
        dim_slices = TensorProductCell._split_slices(
            [c.get_spatial_dimension() for c in self.cell.cells])

        n_idx = [len(f.index_shape) for f in self.factors]
        n_val = [len(f.value_shape) for f in self.factors]

        result = {}
        dim = self.cell.get_spatial_dimension()
        for Delta in chain(*(mis(dim, o) for o in range(order + 1))):
            tabs = [fr[Delta[s]]
                    for fr, s in zip(factor_results, dim_slices)]
            result[Delta] = _outer_merge(tabs, n_idx, n_val, shared_points)
        return result

    def basis_evaluation(self, order, ps, entity=None,
                         coordinate_mapping=None):
        entities = self._factor_entity(entity)
        ps_factors = factor_point_set(self.cell,
                                      [d for d, _ in entities], ps)
        shared_points = not (isinstance(ps, TensorPointSet)
                             and len(self.cell.cells) == len(ps.factors))
        factor_results = [f.basis_evaluation(order, fps, e)
                          for f, fps, e in zip(self.factors, ps_factors,
                                               entities)]
        return self._merge_evaluations(factor_results, shared_points)

    def point_evaluation(self, order, point, entity=None,
                         coordinate_mapping=None):
        entities = self._factor_entity(entity)
        widths = [c.construct_subelement(d).get_spatial_dimension()
                  for c, (d, _) in zip(self.cell.cells, entities)]
        assert point.shape == (sum(widths),)
        factor_results = [f.point_evaluation(order, point[s], e)
                          for f, s, e in zip(
                              self.factors,
                              TensorProductCell._split_slices(widths),
                              entities)]
        return self._merge_evaluations(factor_results, shared_points=True)

    @property
    def dual_basis(self):
        qs, pss = zip(*(f.dual_basis for f in self.factors))
        # Q factors have shape (idx_f..., npts_f, vshape_f...); merged
        # Q: (idx..., npts..., vshape...)
        letters = iter("abcdefghijklmnopqrstuvwxyz")
        specs, out_idx, out_pts, out_val = [], [], [], []
        for q, f, fss in zip(qs, self.factors, pss):
            idx = [next(letters) for _ in f.index_shape]
            pts = [next(letters) for _ in fss.points_shape]
            val = [next(letters) for _ in f.value_shape]
            specs.append("".join(idx + pts + val))
            out_idx += idx
            out_pts += pts
            out_val += val
        spec = ",".join(specs) + "->" + "".join(out_idx + out_pts + out_val)
        return _einsum(spec, *qs), TensorPointSet(pss)

    @property
    def mapping(self):
        nonaffine = {f.mapping for f in self.factors} - {"affine"}
        if not nonaffine:
            return "affine"
        return nonaffine.pop() if len(nonaffine) == 1 else None


def _outer_merge(tabs, n_idx, n_val, shared_points):
    """einsum the factor tables (idx_f..., val_f..., pts_f...) into
    (idx..., val..., pts...)."""
    letters = iter("abcdefghijklmnopqrstuvwxyz")
    shared = next(letters) if shared_points else None
    specs, out_idx, out_val, out_pts = [], [], [], []
    for tab, ni, nv in zip(tabs, n_idx, n_val):
        n_pts_axes = len(tab.shape) - ni - nv
        idx = [next(letters) for _ in range(ni)]
        val = [next(letters) for _ in range(nv)]
        if shared_points:
            assert n_pts_axes in (0, 1)
            pts = [shared] * n_pts_axes
        else:
            pts = [next(letters) for _ in range(n_pts_axes)]
            out_pts += pts
        specs.append("".join(idx + val + pts))
        out_idx += idx
        out_val += val
    if shared_points:
        # the point axis is shared across factors (may be absent for
        # PointSingleton tabs)
        out_pts = [shared] if any(s.endswith(shared) for s in specs) else []
    spec = ",".join(specs) + "->" + "".join(out_idx + out_val + out_pts)
    return _einsum(spec, *tabs)


def _entity_product(tables, combine):
    """Walk the cartesian product of per-factor per-dimension entity
    tables.  For each dimension tuple, product entities are numbered
    flat in lexicographic factor-entity order and mapped to
    ``combine(dims, per-factor values)``."""
    out = {}
    for dims in product(*map(sorted, tables)):
        rows = [t[d] for t, d in zip(tables, dims)]
        combos = product(*(sorted(r) for r in rows))
        out[dims] = {
            flat: combine(dims, [r[e] for r, e in zip(rows, ent)])
            for flat, ent in enumerate(combos)}
    return out


def productise(factors, method):
    """Entity→dof maps of a product element.  The product dof numbering
    is the row-major ravel of the factor dof grid, so each product
    entity's dofs are one block gather ``grid[ix_(dofsA, dofsB, ...)]``."""
    grid = np.arange(int(np.prod([f.space_dimension() for f in factors])))
    grid = grid.reshape([f.space_dimension() for f in factors])

    def gather(_dims, dof_lists):
        block = grid[np.ix_(*[np.asarray(d, dtype=int) for d in dof_lists])]
        return block.ravel().tolist()

    return _entity_product([method(f) for f in factors], gather)


def compose_permutations(factors):
    """Orientation→dof-permutation maps of a product element: extrinsic
    axis swaps composed with the factors' intrinsic orientation maps."""
    cells = [f.cell for f in factors]

    def compose(dims, o_p_maps):
        return make_entity_permutations_tensorproduct(cells, dims, o_p_maps)

    return _entity_product([f.entity_permutations for f in factors], compose)


def factor_point_set(product_cell, product_dim, point_set):
    """Split a point set across the factor cells."""
    widths = [c.construct_subelement(d).get_spatial_dimension()
              for c, d in zip(product_cell.cells, product_dim)]

    if isinstance(point_set, TensorPointSet) \
            and len(point_set.factors) == len(product_cell.cells):
        assert [ps.dimension for ps in point_set.factors] == widths
        return point_set.factors

    assert point_set.dimension == sum(widths)
    slices = TensorProductCell._split_slices(widths)
    if isinstance(point_set, PointSingleton):
        return [PointSingleton(point_set.point[s]) for s in slices]
    if isinstance(point_set, (PointSet, TensorPointSet)):
        return [PointSet(point_set.points[:, s]) for s in slices]
    raise NotImplementedError(
        f"How to tabulate TensorProductElement on {type(point_set).__name__}?")
