"""QuadratureElement in the symbolic layer (counterpart of
``fiat_tpu/symbolic/quadrature_element.py``, role of FInAT's
``finat/quadrature_element.py``): identity tabulation at its own rule's
points (facet rules get a facet axis)."""

import numpy as np

from .base import FiniteElementBase
from .point_set import FacetPointSet, UnknownPointSet
from .quadrature import AbstractQuadratureRule, make_quadrature


def make_quadrature_element(fiat_ref_cell, degree, scheme="default", codim=0):
    """Build a QuadratureElement from (cell, degree, scheme[, codim])."""
    if codim > 0:
        sd = fiat_ref_cell.get_spatial_dimension()
        rule_ref_cell = fiat_ref_cell.construct_subelement(sd - codim)
    else:
        rule_ref_cell = fiat_ref_cell
    if isinstance(scheme, AbstractQuadratureRule):
        rule = scheme
        assert rule.ref_el >= rule_ref_cell
    else:
        rule = make_quadrature(rule_ref_cell, degree, scheme=scheme)
    return QuadratureElement(fiat_ref_cell, rule)


class QuadratureElement(FiniteElementBase):
    """Quadrature points pretending to be a finite element."""

    def __init__(self, fiat_ref_cell, rule):
        self._cell = fiat_ref_cell
        if not isinstance(rule, AbstractQuadratureRule):
            raise TypeError("rule is not an AbstractQuadratureRule")
        self._rule = rule

    @property
    def cell(self):
        return self._cell

    @property
    def complex(self):
        return self._cell

    @property
    def degree(self):
        raise NotImplementedError(
            "QuadratureElement does not represent a polynomial space.")

    @property
    def formdegree(self):
        return None

    def entity_dofs(self):
        try:
            return self._entity_dofs_cache
        except AttributeError:
            pass
        ps = self._rule.point_set
        sd = self.cell.get_spatial_dimension()
        if not isinstance(ps, UnknownPointSet) and ps.dimension == sd:
            result = self.cell.point_entity_ids(ps.points)
        else:
            # facet rule: each entity of the rule's dimension owns one
            # full copy of the point block, in entity order
            n = len(ps.points)
            flat = lambda d: sum(d) if isinstance(d, tuple) else d
            top = self.cell.get_topology()
            owning = [(dim, e) for dim in sorted(top)
                      if flat(dim) == ps.dimension
                      for e in sorted(top[dim])]
            blocks = {de: list(range(i * n, (i + 1) * n))
                      for i, de in enumerate(owning)}
            result = {dim: {e: blocks.get((dim, e), []) for e in top[dim]}
                      for dim in top}
        self._entity_dofs_cache = result
        return result

    def space_dimension(self):
        return int(np.prod(self.index_shape, dtype=int))

    @property
    def _point_set(self):
        ps = self._rule.point_set
        sd = self.cell.get_spatial_dimension()
        return ps if ps.dimension == sd else FacetPointSet(self.cell, ps)

    @property
    def index_shape(self):
        return self._point_set.points_shape

    @property
    def value_shape(self):
        return ()

    @property
    def fiat_equivalent(self):
        from .. import elements as fe_numeric
        ps = self._point_set
        if isinstance(ps, UnknownPointSet):
            raise ValueError(
                "A rule with runtime points has no numerical equivalent!")
        weights = getattr(self._rule, "weights", None)
        return fe_numeric.QuadratureElement(self.cell, ps.points, weights)

    def basis_evaluation(self, order, ps, entity=None, coordinate_mapping=None):
        """Identity tabulation; only point sets matching the rule's own
        points are legal."""
        if entity is not None and entity != (self.cell.get_dimension(), 0):
            raise ValueError("QuadratureElement does not tabulate on subentities.")
        if order:
            raise ValueError("Derivatives are not defined on a QuadratureElement.")
        own = self._point_set
        if not (ps is own or getattr(ps, "almost_equal", lambda o: False)(own)
                or getattr(own, "almost_equal", lambda o: False)(ps)):
            raise ValueError("Mismatch of quadrature points!")
        n = self.space_dimension()
        sd = self.cell.get_spatial_dimension()
        eye = np.eye(n).reshape(self.index_shape + own.points_shape)
        return {(0,) * sd: eye}

    def point_evaluation(self, order, refcoords, entity=None,
                         coordinate_mapping=None):
        raise NotImplementedError(
            "Point evaluation is not defined for QuadratureElements")

    @property
    def dual_basis(self):
        ps = self._point_set
        n = self.space_dimension()
        Q = np.eye(n).reshape(self.index_shape + ps.points_shape)
        return Q, ps

    @property
    def mapping(self):
        return "affine"
