"""Base class of the symbolic element layer.

Counterpart of ``fiat_tpu/symbolic/base.py`` (role of FInAT's
``finat/finiteelementbase.py``): where FInAT's ``basis_evaluation`` emits
GEM expression DAGs for a downstream form compiler, the port's returns
ARRAYS -- host numpy for static points, torch tensors on the points'
device and in their dtype for tensor points (where fiat_tpu returns traced
jnp arrays under ``jax.jit``; eager torch on the device plays XLA's
role).  Tabulations are dicts alpha -> array of shape
index_shape + value_shape + points_shape.
"""

from abc import ABCMeta, abstractmethod
from functools import cached_property

import numpy as np
import torch

from .point_set import _is_traced
from .quadrature import make_quadrature


class FiniteElementBase(metaclass=ABCMeta):

    @property
    @abstractmethod
    def cell(self):
        """The reference cell of the element."""

    @property
    def complex(self):
        """The reference complex (differs from cell for macro elements)."""

    @property
    @abstractmethod
    def degree(self):
        """Degree of the embedding polynomial space (tuple for TP)."""

    @property
    @abstractmethod
    def formdegree(self):
        """FEEC form degree."""

    @abstractmethod
    def entity_dofs(self):
        """{dim: {entity: [dof ids]}}."""

    @property
    def entity_permutations(self):
        raise NotImplementedError(
            f"entity_permutations not yet implemented for {type(self)}")

    @cached_property
    def _entity_closure_dofs(self):
        from itertools import chain
        entity_dofs = self.entity_dofs()
        return {dim: {e: sorted(chain(*[entity_dofs[d][se]
                                        for d, se in sub_entities]))
                      for e, sub_entities in entities.items()}
                for dim, entities in self.cell.sub_entities.items()}

    def entity_closure_dofs(self):
        return self._entity_closure_dofs

    def is_dg(self):
        return self.entity_dofs() == self.entity_closure_dofs()

    @cached_property
    def _entity_support_dofs(self):
        esd = {}
        for entity_dim in self.cell.sub_entities.keys():
            entity_cell = self.cell.construct_subelement(entity_dim)
            quad = make_quadrature(entity_cell,
                                   (2 * np.array(self.degree)).tolist())
            weights = np.asarray(quad.weight_expression).reshape(-1)
            eps = 1e-8
            result = {}
            for f in self.entity_dofs()[entity_dim].keys():
                vals, = self.basis_evaluation(0, quad.point_set,
                                              entity=(entity_dim, f)).values()
                vals = np.asarray(vals)
                nbf = int(np.prod(self.index_shape, dtype=int))
                flat = vals.reshape(nbf, -1, len(weights))
                ints = np.einsum("icp,icp,p->i", flat, flat, weights)
                result[f] = [dof for dof, i in enumerate(ints) if i > eps]
            esd[entity_dim] = result
        return esd

    def entity_support_dofs(self):
        return self._entity_support_dofs

    @abstractmethod
    def space_dimension(self):
        """Dimension of the element space."""

    @property
    @abstractmethod
    def index_shape(self):
        """Shape of the basis-function axis/axes."""

    @property
    @abstractmethod
    def value_shape(self):
        """Value shape of the element's functions."""

    @property
    def fiat_equivalent(self):
        raise NotImplementedError(
            f"Cannot make equivalent FIAT element for {type(self).__name__}")

    @abstractmethod
    def basis_evaluation(self, order, ps, entity=None, coordinate_mapping=None):
        """Tabulate at a point set: {alpha: array of shape
        index_shape + value_shape + ps.points_shape}.  With a tensor point
        set the returned arrays are torch tensors on the points' device."""

    def point_evaluation(self, order, refcoords, entity=None,
                         coordinate_mapping=None):
        """Tabulate at a single (numpy or tensor) coordinate vector:
        {alpha: array of shape index_shape + value_shape}."""
        from .point_set import PointSingleton
        if entity is None:
            entity = (self.cell.get_dimension(), 0)
        entity_dim, _ = entity
        esd = self.cell.construct_subelement(entity_dim).get_spatial_dimension()
        assert refcoords.shape == (esd,)
        ps = PointSingleton(refcoords)
        return self.basis_evaluation(order, ps, entity=entity,
                                     coordinate_mapping=coordinate_mapping)

    @property
    def dual_basis(self):
        """(Q, x): dual weight tensor and evaluation point set.  Dual
        evaluation of fn is the contraction of Q with fn at x's points:
        Q has shape index_shape + x.points_shape + value_shape."""
        raise NotImplementedError(
            f"Dual basis not defined for element {type(self).__name__}")

    def dual_evaluation(self, fn, coordinate_mapping=None):
        """Apply the dual basis to a function.

        :arg fn: callable point_set -> array of shape
            points_shape + value_shape (a tensor or host numpy).
        :returns: array of shape index_shape (the DoF values)."""
        Q, x = self.dual_basis
        Q = self.dual_transformation(Q, coordinate_mapping=coordinate_mapping)
        expr = fn(x)
        npoint_axes = len(x.points_shape)
        nbasis_axes = len(Q.shape) - npoint_axes - (len(expr.shape) - npoint_axes)
        # contract point axes and any value axes
        sum_axes_Q = tuple(range(nbasis_axes, len(Q.shape)))
        sum_axes_f = tuple(range(len(expr.shape)))
        return _tensordot(Q, expr, (sum_axes_Q, sum_axes_f))

    def dual_transformation(self, Q, coordinate_mapping=None):
        """Reference-to-physical transformation of the dual weights."""
        return Q

    @property
    @abstractmethod
    def mapping(self):
        """Pullback type for all basis functions."""

    @cached_property
    def has_pointwise_dual_basis(self):
        """True if the dual consists only of point evaluations (the weight
        tensor is an identity pattern)."""
        try:
            Q, ps = self.dual_basis
        except NotImplementedError:
            return False
        Q = np.asarray(Q)
        flatQ = Q.reshape(int(np.prod(Q.shape[:1])), -1)
        if flatQ.shape[0] > flatQ.shape[1]:
            return False
        eye = np.zeros_like(flatQ)
        step = flatQ.shape[1] // flatQ.shape[0] if flatQ.shape[0] else 1
        # identity pattern: each row has a single unit weight
        nz = np.count_nonzero(flatQ, axis=1)
        if not np.all(nz == 1):
            return False
        return np.allclose(flatQ[flatQ != 0], 1.0)


def _tensordot(a, b, axes):
    """tensordot dispatching to torch when either operand is a tensor: the
    other joins it on its device, and both take their promoted dtype, as
    ``jnp.tensordot`` promotes under x64 (a float64 numpy operand makes a
    float32 tensor's product float64)."""
    if _is_traced(a) or _is_traced(b):
        device = (a if _is_traced(a) else b).device
        a, b = (torch.as_tensor(x, device=device) for x in (a, b))
        dtype = torch.promote_types(a.dtype, b.dtype)
        return torch.tensordot(a.to(dtype), b.to(dtype), [list(axes[0]), list(axes[1])])
    return np.tensordot(a, b, axes)


def entity_support_dofs(elem, entity_dim):
    """Entity id -> dofs with nonzero support on that entity."""
    return elem.entity_support_dofs()[entity_dim]
