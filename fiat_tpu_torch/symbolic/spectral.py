"""Spectral shortcut elements (counterpart of
``fiat_tpu/symbolic/spectral.py``, role of FInAT's ``finat/spectral.py``):
when the evaluation point set is tagged as the element's own node family
(GL/GLL/KMV), the 0th-derivative table is replaced by an EXACT identity
-- a structural Kronecker delta (diagonal mass without computation); on
tensor points it is a torch identity on their device, in their dtype.  The modal Legendre / FDM families carry no
shortcut and are stamped out from a name list."""

from abc import ABCMeta, abstractmethod

import numpy as np
import torch

from .. import elements as fe
from .citations import cite
from .fiat_bridge import (DiscontinuousLagrange, Lagrange, ScalarFiatElement)
from .point_set import (GaussLegendrePointSet, GaussLobattoLegendrePointSet,
                        KMVPointSet, _is_traced)


class SpectralElement(metaclass=ABCMeta):
    """Mixin replacing the value table by the identity when points match
    the nodes."""

    @property
    @abstractmethod
    def point_set_family(self):
        """The PointSet subclass on which this element tabulates to a
        delta."""

    def _is_nodal_points(self, ps, entity):
        whole_cell = entity in (None, (self.cell.get_dimension(), 0))
        return (whole_cell and isinstance(ps, self.point_set_family)
                and len(ps.points) == self.space_dimension())

    def basis_evaluation(self, order, ps, entity=None, coordinate_mapping=None):
        tables = super().basis_evaluation(
            order, ps, entity=entity, coordinate_mapping=coordinate_mapping)
        if self._is_nodal_points(ps, entity):
            alpha0 = (0,) * self.cell.get_spatial_dimension()
            pts = ps.points
            tables[alpha0] = (torch.eye(self.space_dimension(), dtype=pts.dtype,
                                        device=pts.device)
                              if _is_traced(pts) else np.eye(self.space_dimension()))
        return tables


class GaussLobattoLegendre(SpectralElement, Lagrange):
    """Continuous spectral element at GLL points."""
    point_set_family = GaussLobattoLegendrePointSet

    def __init__(self, cell, degree):
        super(Lagrange, self).__init__(fe.GaussLobattoLegendre(cell, degree))


class GaussLegendre(SpectralElement, DiscontinuousLagrange):
    """Discontinuous spectral element at GL points."""
    point_set_family = GaussLegendrePointSet

    def __init__(self, cell, degree):
        super(DiscontinuousLagrange, self).__init__(
            fe.GaussLegendre(cell, degree))


class KongMulderVeldhuizen(SpectralElement, ScalarFiatElement):
    """Mass-lumped simplicial spectral element at KMV points."""
    point_set_family = KMVPointSet

    def __init__(self, cell, degree):
        super(ScalarFiatElement, self).__init__(
            fe.KongMulderVeldhuizen(cell, degree))
        for paper in ("ChinJoeKong1999", "Geevers2018"):
            cite(paper)


def _plain_scalar(name, doc, variant_kwarg):
    core_cls = getattr(fe, name)
    if variant_kwarg:
        def __init__(self, cell, degree, variant=None):
            ScalarFiatElement.__init__(self, core_cls(cell, degree,
                                                      variant=variant))
    else:
        def __init__(self, cell, degree):
            ScalarFiatElement.__init__(self, core_cls(cell, degree))
    globals()[name] = type(name, (ScalarFiatElement,), {
        "__init__": __init__, "__doc__": doc, "__module__": __name__})


_plain_scalar("Legendre", "DG modal Legendre element.", True)
_plain_scalar("IntegratedLegendre", "CG integrated-Legendre element.", True)
for _fdm in ("FDMLagrange", "FDMDiscontinuousLagrange", "FDMQuadrature",
             "FDMBrokenH1", "FDMBrokenL2", "FDMHermite"):
    _plain_scalar(_fdm, f"{_fdm} fast-diagonalisation 1D element.", False)
