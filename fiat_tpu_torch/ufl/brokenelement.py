"""Broken (fully discontinuous) element descriptions.

FInAT's finat/ufl/brokenelement.py; the port's copy of
``fiat_tpu.ufl.brokenelement``."""

from .finiteelementbase import FiniteElementBase
from .mixedelement import MixedElement, TensorElement, VectorElement
from .sobolevspace import L2


class BrokenElement(FiniteElementBase):
    """The discontinuous version of an existing element space."""

    def __new__(cls, element):
        # push the breaking below Mixed/Vector/Tensor
        if isinstance(element, (VectorElement, TensorElement)):
            inner = BrokenElement(element.sub_elements[0])
            return element.reconstruct(sub_element=inner)
        if isinstance(element, MixedElement):
            return MixedElement([BrokenElement(e)
                                 for e in element.sub_elements])
        return super().__new__(cls)

    def __init__(self, element):
        self._element = element
        super().__init__("BrokenElement", element.cell, element.degree(),
                         element.quadrature_scheme(),
                         element.reference_value_shape)

    def __repr__(self):
        return f"BrokenElement({self._element!r})"

    def mapping(self):
        return self.sub_element().mapping()

    def sub_element(self):
        return self._element

    @property
    def sobolev_space(self):
        return L2

    def reconstruct(self, **kwargs):
        return BrokenElement(self.sub_element().reconstruct(**kwargs))

    def __str__(self):
        return f"BrokenElement({self._element!r})"

    def shortstr(self):
        return f"BrokenElement({self._element!r})"

    @property
    def embedded_subdegree(self):
        return self.sub_element().embedded_subdegree

    @property
    def embedded_superdegree(self):
        return self.sub_element().embedded_superdegree
