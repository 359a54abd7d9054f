"""Hdiv / Hcurl wrappers for tensor-product elements.

Counterpart of ``fiat_tpu/elements/hdivcurl.py``: the product's scalar or
vector values are re-read as normal or tangential vector components under
the matching Piola mapping.  Subclasses of ``TensorProductElement``."""

import numpy as np

from ..core import functionals
from .tensor_product import TensorProductElement


def _splat_point_evaluations(dual):
    """PointEvaluation DoFs become undefined under the vector
    reinterpretation (mixed internal/external components)."""
    dual.nodes = [functionals.Functional(None, (), "Undefined", np.zeros((1, 0)))
                  if isinstance(node, functionals.PointEvaluation) else node
                  for node in dual.nodes]


class _VectorizedTP(TensorProductElement):
    """Common machinery: tabulate the underlying TP element and embed the
    values as vector components."""

    def __init__(self, element):
        if not isinstance(element, TensorProductElement):
            raise NotImplementedError("Hdiv/Hcurl expects a TensorProductElement")
        if element.A.get_formdegree() is None or element.B.get_formdegree() is None:
            raise ValueError("Hdiv/Hcurl needs form degrees on both factors")
        super().__init__(element.A, element.B)
        self._oldmapping = self._mapping
        if self._oldmapping == "affine":
            _splat_point_evaluations(self.dual)

    def value_shape(self):
        return (self.get_reference_element().get_spatial_dimension(),)

    def tabulate(self, order, points, entity=None):
        old = super().tabulate(order, points, entity)
        return {alpha: self._vectorize(tab) for alpha, tab in old.items()}


class HdivTensorProduct(_VectorizedTP):
    """H(div) reinterpretation of an (n-1)-form TP element."""

    def __init__(self, element):
        super().__init__(element)
        formdegree = element.A.get_formdegree() + element.B.get_formdegree()
        if formdegree != self.get_reference_element().get_spatial_dimension() - 1:
            raise ValueError("Tried to use Hdiv on a non-(n-1)-form element")
        self.formdegree = formdegree
        self._mapping = "contravariant piola"

    def _vectorize(self, tab):
        sd = self.get_reference_element().get_spatial_dimension()
        Asd = self.A.get_reference_element().get_spatial_dimension()
        out = np.zeros((tab.shape[0], sd, tab.shape[-1]), dtype=tab.dtype)
        if self._oldmapping == "affine":
            # scalar x scalar: put the continuous (0-form) factor's slot
            if self.A.get_formdegree() == 0:
                out[:, 0, :] = -tab      # sign fixes orientation on quads
            elif self.B.get_formdegree() == 0:
                out[:, -1, :] = tab
            else:
                raise ValueError("Hdiv affine/affine form degrees broke")
        elif self._oldmapping == "contravariant piola":
            if self.A.mapping()[0] == "contravariant piola":
                out[:, :Asd, :] = tab
            elif self.B.mapping()[0] == "contravariant piola":
                out[:, Asd:, :] = tab
            else:
                raise ValueError("no contravariant piola factor found")
        elif self._oldmapping == "covariant piola":
            # perp the 2d covariant factor to make it contravariant
            if self.A.mapping()[0] == "covariant piola":
                if self.A.get_reference_element().get_spatial_dimension() != 2:
                    raise ValueError("Need a 2d factor to perp covariant->contravariant")
                out[:, 0, :] = tab[:, 1, :]
                out[:, 1, :] = -tab[:, 0, :]
            elif self.B.mapping()[0] == "covariant piola":
                if self.B.get_reference_element().get_spatial_dimension() != 2:
                    raise ValueError("Need a 2d factor to perp covariant->contravariant")
                out[:, Asd:, :] = tab
            else:
                raise ValueError("no covariant piola factor found")
        return out


class HcurlTensorProduct(_VectorizedTP):
    """H(curl) reinterpretation of a 1-form TP element."""

    def __init__(self, element):
        super().__init__(element)
        formdegree = element.A.get_formdegree() + element.B.get_formdegree()
        if formdegree != 1:
            raise ValueError("Tried to use Hcurl on a non-1-form element")
        self.formdegree = formdegree
        self._mapping = "covariant piola"

    def _vectorize(self, tab):
        sd = self.get_reference_element().get_spatial_dimension()
        Asd = self.A.get_reference_element().get_spatial_dimension()
        out = np.zeros((tab.shape[0], sd, tab.shape[-1]), dtype=tab.dtype)
        if self._oldmapping == "affine":
            if self.A.get_formdegree() == 1:
                out[:, 0, :] = tab
            elif self.B.get_formdegree() == 1:
                out[:, -1, :] = tab
            else:
                raise ValueError("Hcurl affine/affine form degrees broke")
        elif self._oldmapping == "covariant piola":
            if self.A.mapping()[0] == "covariant piola":
                out[:, :Asd, :] = tab
            elif self.B.mapping()[0] == "covariant piola":
                out[:, Asd:, :] = tab
            else:
                raise ValueError("no covariant piola factor found")
        elif self._oldmapping == "contravariant piola":
            if self.A.mapping()[0] == "contravariant piola":
                if self.A.get_reference_element().get_spatial_dimension() != 2:
                    raise ValueError("Need a 2d factor to perp contravariant->covariant")
                out[:, 0, :] = -tab[:, 1, :]
                out[:, 1, :] = tab[:, 0, :]
            elif self.B.mapping()[0] == "contravariant piola":
                if self.B.get_reference_element().get_spatial_dimension() != 2:
                    raise ValueError("Need a 2d factor to perp contravariant->covariant")
                out[:, Asd:, :] = tab
            else:
                raise ValueError("no contravariant piola factor found")
        return out


def Hdiv(element):
    return HdivTensorProduct(element)


def Hcurl(element):
    return HcurlTensorProduct(element)
