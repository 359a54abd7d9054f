"""QuadratureElement: fixed quadrature points presented as an element,
whose only legal tabulation is the identity at its own points.

Counterpart of ``fiat_tpu/elements/quadrature_element.py``, on the
declarative dual builder."""

import numpy as np

from ..core.dual_builder import DualBuilder
from ..core.finite_element import FiniteElement
from ..core.functionals import PointEvaluation


class QuadratureElement(FiniteElement):
    """Point evaluations at fixed quadrature points."""

    def __init__(self, ref_el, points, weights=None):
        b = DualBuilder(ref_el)
        b.tag(ref_el.get_dimension(), 0,
              (PointEvaluation(ref_el, tuple(p)) for p in points))
        super().__init__(ref_el, b.dual_set(), order=None)
        self._points = points
        self._weights = weights

    def value_shape(self):
        return ()

    def tabulate(self, order, points, entity=None):
        if entity is not None \
                and entity != (self.ref_el.get_dimension(), 0):
            raise ValueError(
                'QuadratureElement does not "tabulate" on subentities.')
        if order:
            raise ValueError(
                "Derivatives are not defined on a QuadratureElement.")
        own = np.asarray(self._points)
        if len(points) != len(own) \
                or abs(np.asarray(points) - own).max() > 1e-12:
            raise AssertionError("Mismatch of quadrature points!")
        sd = self.ref_el.get_spatial_dimension()
        return {(0,) * sd: np.eye(len(own))}

    @staticmethod
    def is_nodal():
        return True
