"""Vector/tensor wrapper element (counterpart of
``fiat_tpu/symbolic/tensorfiniteelement.py``, role of FInAT's
``finat/tensorfiniteelement.py``): basis functions are
e_alpha (x) e_beta ... phi_i; tabulations carry the Kronecker-delta
structure as dense identity factors (on tensor tables a torch identity on
their device), and ``base_element`` exposes the factored form for
consumers that exploit it directly, e.g. the batched tabulator."""

from itertools import chain

import numpy as np
import torch

from .base import FiniteElementBase, _tensordot
from .point_set import _is_traced


def _identity_like(table, shape):
    """The identity over ``shape`` twice (shape + shape), as numpy or as a
    tensor on ``table``'s device in its dtype."""
    ncomp = int(np.prod(shape, dtype=int))
    eye = np.eye(ncomp).reshape(shape + shape)
    return table.new_tensor(eye) if _is_traced(table) else eye


def _moveaxis(array, src, dst):
    return torch.movedim(array, src, dst) if _is_traced(array) else np.moveaxis(array, src, dst)


class TensorFiniteElement(FiniteElementBase):

    def __init__(self, element, shape, transpose=False):
        super().__init__()
        self._base_element = element
        self._shape = shape
        self._transpose = transpose

    @property
    def base_element(self):
        return self._base_element

    @property
    def cell(self):
        return self._base_element.cell

    @property
    def complex(self):
        return self._base_element.complex

    @property
    def degree(self):
        return self._base_element.degree

    @property
    def formdegree(self):
        return self._base_element.formdegree

    def entity_dofs(self):
        try:
            return self._entity_dofs_cache
        except AttributeError:
            pass
        dofs = {}
        base_dofs = self._base_element.entity_dofs()
        ndof = int(np.prod(self._shape, dtype=int))

        def expand(ids):
            ids = tuple(ids)
            if self._transpose:
                space_dim = self._base_element.space_dimension()
                iterable = ((v + i * space_dim for v in ids)
                            for i in range(ndof))
            else:
                iterable = (range(v * ndof, (v + 1) * ndof) for v in ids)
            yield from chain.from_iterable(iterable)

        for dim in self.cell.get_topology().keys():
            dofs[dim] = {k: list(expand(d))
                         for k, d in base_dofs[dim].items()}
        self._entity_dofs_cache = dofs
        return dofs

    def space_dimension(self):
        return int(np.prod(self.index_shape))

    @property
    def index_shape(self):
        if self._transpose:
            return self._shape + self._base_element.index_shape
        return self._base_element.index_shape + self._shape

    @property
    def value_shape(self):
        return self._shape + self._base_element.value_shape

    def _tensorise(self, scalar_evaluation):
        """Tensorise tables: out[idx..., comp..., comp'..., vals..., pts...]
        = delta(comp, comp') * base[idx..., vals..., pts...]."""
        result = {}
        base_idx = len(self._base_element.index_shape)
        for alpha, table in scalar_evaluation.items():
            eye = _identity_like(table, self._shape)
            # base: (bidx..., bval..., pts...); out ordering depends on
            # transpose: (shape + bidx) or (bidx + shape), then
            # (shape + bval) value axes, then point axes.
            tshape = tuple(table.shape)
            b_idx_shape = tshape[:base_idx]
            rest_shape = tshape[base_idx:]
            # outer product with the identity
            out = (table.reshape(b_idx_shape + (1,) * len(self._shape)
                                 + (1,) * len(self._shape) + rest_shape)
                   * eye.reshape((1,) * len(b_idx_shape) + self._shape
                                 + self._shape + (1,) * len(rest_shape)))
            if self._transpose:
                # move the first copy of shape axes before the base index
                src = list(range(len(b_idx_shape),
                                 len(b_idx_shape) + len(self._shape)))
                dst = list(range(len(self._shape)))
                out = _moveaxis(out, src, dst)
            result[alpha] = out
        return result

    def basis_evaluation(self, order, ps, entity=None, coordinate_mapping=None):
        return self._tensorise(self._base_element.basis_evaluation(
            order, ps, entity, coordinate_mapping=coordinate_mapping))

    def point_evaluation(self, order, refcoords, entity=None,
                         coordinate_mapping=None):
        return self._tensorise(self._base_element.point_evaluation(
            order, refcoords, entity))

    @property
    def dual_basis(self):
        base_Q, x = self._base_element.dual_basis
        eye = _identity_like(base_Q, self._shape)
        nb_idx = len(self._base_element.index_shape)
        npt = len(x.points_shape)
        bshape = tuple(base_Q.shape)
        # base_Q: (bidx..., pts..., bval...) -> out:
        # (bidx..., shape..., pts..., shape..., bval...)
        Q = (base_Q.reshape(bshape[:nb_idx] + (1,) * len(self._shape)
                            + bshape[nb_idx:nb_idx + npt]
                            + (1,) * len(self._shape)
                            + bshape[nb_idx + npt:])
             * eye.reshape((1,) * nb_idx + self._shape + (1,) * npt
                           + self._shape + (1,) * (len(bshape) - nb_idx - npt)))
        if self._transpose:
            src = list(range(nb_idx, nb_idx + len(self._shape)))
            dst = list(range(len(self._shape)))
            Q = _moveaxis(Q, src, dst)
        return Q, x

    def dual_evaluation(self, fn, coordinate_mapping=None):
        # The base element contracts points and base values; the tensor
        # shape rides along as extra value axes of fn's output.
        Q, x = self.dual_basis
        Q = self.dual_transformation(Q, coordinate_mapping=coordinate_mapping)
        expr = fn(x)
        n_idx = len(self.index_shape)
        sum_axes_Q = tuple(range(n_idx, len(Q.shape)))
        sum_axes_f = tuple(range(len(expr.shape)))
        return _tensordot(Q, expr, (sum_axes_Q, sum_axes_f))

    @property
    def mapping(self):
        return self._base_element.mapping
