"""H(div)/H(curl) wrappers for symbolic TP elements (counterpart of
``fiat_tpu/symbolic/hdivcurl.py``, role of FInAT's ``finat/hdivcurl.py``).

A wrapper embeds the scalar/2-vector TP tabulation into a spatial-vector
field by a fixed per-component row table: each output component is
either zero or (sign x one wrappee component).  The embedding is one
stack over component rows applied uniformly to tabulations and to the
dual weight tensor (``torch.stack`` on tensor tables)."""

import numpy as np
import torch

from .. import elements as fe_numeric
from ..core import cells as cl
from .base import FiniteElementBase
from .point_set import _is_traced
from .tensor_product import TensorProductElement



def _read_through(name):
    get = lambda self: getattr(self.wrappee, name)  # noqa: E731
    get.__name__ = name
    return property(get)


def _call_through(name):
    def call(self):
        return getattr(self.wrappee, name)()
    call.__name__ = name
    return call


def _embed(table, rows, at):
    """Stack component ``rows`` into axis ``at`` of ``table``.  A row is
    None (zero component) or ``(sign, comp)`` with ``comp`` indexing the
    wrappee's component axes at position ``at``."""
    n_comp = max((len(c) for r in rows if r for _, c in (r,)), default=0)
    shape = tuple(table.shape[:at]) + tuple(table.shape[at + n_comp:])
    zeros = None
    parts = []
    for row in rows:
        if row is None:
            if zeros is None:
                zeros = table.new_zeros(shape) if _is_traced(table) else np.zeros(shape)
            parts.append(zeros)
        else:
            sign, comp = row
            parts.append(sign * table[(slice(None),) * at + comp])
    if _is_traced(table):
        return torch.stack(parts, dim=at)
    return np.stack(parts, axis=at)


class WrapperElementBase(FiniteElementBase):
    """Shared machinery of the H(div)/H(curl) embeddings."""

    #: target form degree as a function of spatial dimension
    target_formdegree = None

    cell = _read_through("cell")
    complex = _read_through("complex")
    degree = _read_through("degree")
    index_shape = _read_through("index_shape")
    entity_permutations = _read_through("entity_permutations")
    entity_dofs = _call_through("entity_dofs")
    entity_closure_dofs = _call_through("entity_closure_dofs")
    entity_support_dofs = _call_through("entity_support_dofs")
    space_dimension = _call_through("space_dimension")

    def __init__(self, wrappee):
        super().__init__()
        assert isinstance(wrappee, TensorProductElement)
        kind = type(self).__name__[:-len("Element")]
        degrees = [f.formdegree for f in wrappee.factors]
        if None in degrees:
            raise ValueError(
                f"Form degree of subelement is None, cannot {kind}!")
        dim = wrappee.cell.get_spatial_dimension()
        if sum(degrees) != self.target_formdegree(dim):
            raise ValueError(f"{kind} wrapper needs a "
                             f"{self.target_formdegree(dim)}-form element!")
        self.wrappee = wrappee
        self.rows = self.component_rows(wrappee)

    @property
    def formdegree(self):
        return self.target_formdegree(self.cell.get_spatial_dimension())

    @property
    def value_shape(self):
        return (self.cell.get_spatial_dimension(),)

    def _embed_tables(self, tables):
        at = len(self.wrappee.index_shape)
        return {alpha: _embed(tab, self.rows, at)
                for alpha, tab in tables.items()}

    def basis_evaluation(self, order, ps, entity=None,
                         coordinate_mapping=None):
        return self._embed_tables(
            self.wrappee.basis_evaluation(order, ps, entity))

    def point_evaluation(self, order, refcoords, entity=None,
                         coordinate_mapping=None):
        return self._embed_tables(
            self.wrappee.point_evaluation(order, refcoords, entity))

    @property
    def dual_basis(self):
        Q, x = self.wrappee.dual_basis
        at = len(self.wrappee.index_shape) + len(x.points_shape)
        return _embed(Q, self.rows, at), x


class HDivElement(WrapperElementBase):
    """Embed an (n-1)-form TP element as an H(div) vector field."""

    target_formdegree = staticmethod(lambda dim: dim - 1)
    mapping = "contravariant piola"

    #: rows keyed by the factor form-degree pair (scalar-valued cases)
    _SCALAR_ROWS = {
        (0, 1): [(-1.0, ()), None],
        (1, 0): [None, (1.0, ())],
        (2, 0): [None, None, (1.0, ())],
    }
    #: 3D (1,1) case: rows keyed by the wrappee's own Piola mapping
    _VECTOR_ROWS = {
        "contravariant piola": [(1.0, (0,)), (1.0, (1,)), None],
        "covariant piola": [(1.0, (1,)), (-1.0, (0,)), None],
    }

    @classmethod
    def component_rows(cls, element):
        assert element.factors[1].cell.get_shape() == cl.LINE
        ks = tuple(f.formdegree for f in element.factors)
        if ks == (1, 1):
            return cls._VECTOR_ROWS[element.mapping]
        return cls._SCALAR_ROWS[ks]

    @property
    def fiat_equivalent(self):
        return fe_numeric.Hdiv(self.wrappee.fiat_equivalent)


class HCurlElement(WrapperElementBase):
    """Embed a 1-form TP element as an H(curl) vector field."""

    target_formdegree = staticmethod(lambda dim: 1)
    mapping = "covariant piola"

    _VECTOR_ROWS = {
        "covariant piola": [(1.0, (0,)), (1.0, (1,)), None],
        "contravariant piola": [(-1.0, (1,)), (1.0, (0,)), None],
    }

    @classmethod
    def component_rows(cls, element):
        assert element.factors[1].cell.get_shape() == cl.LINE
        if element.mapping == "affine":
            dim = element.cell.get_spatial_dimension()
            ks = tuple(f.formdegree for f in element.factors)
            if ks == (1, 0):
                return [(1.0, ()), None]
            assert ks == (0, 1)
            return [None] * (dim - 1) + [(1.0, ())]
        return cls._VECTOR_ROWS[element.mapping]

    @property
    def fiat_equivalent(self):
        return fe_numeric.Hcurl(self.wrappee.fiat_equivalent)
