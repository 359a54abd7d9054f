"""Restriction of an element description to a class of cell entities.
Behavioural parity: FInAT's finat/ufl/restrictedelement.py; the port's
copy of ``fiat_tpu.ufl.restrictedelement``."""

from .finiteelementbase import FiniteElementBase
from .mixedelement import MixedElement, TensorElement, VectorElement

valid_restriction_domains = ("interior", "facet", "ridge", "face", "edge",
                             "vertex", "reduced")


class RestrictedElement(FiniteElementBase):
    """An element restricted to DoFs on a type of cell entity."""

    def __new__(cls, element, restriction_domain):
        # push the restriction below Mixed/Vector/Tensor
        if isinstance(element, (VectorElement, TensorElement)):
            inner = RestrictedElement(element.sub_elements[0],
                                      restriction_domain)
            return element.reconstruct(sub_element=inner)
        if isinstance(element, MixedElement):
            return MixedElement([RestrictedElement(e, restriction_domain)
                                 for e in element.sub_elements])
        return super().__new__(cls)

    def __init__(self, element, restriction_domain):
        if not isinstance(element, FiniteElementBase):
            raise ValueError(f"Not an element description: {element!r}")
        if restriction_domain not in valid_restriction_domains:
            raise ValueError(
                f"Expecting one of: {valid_restriction_domains}")
        super().__init__("RestrictedElement", element.cell,
                         element.degree(), element.quadrature_scheme(),
                         element.reference_value_shape)
        self._element = element
        self._restriction_domain = restriction_domain

    def __repr__(self):
        return (f"RestrictedElement({self._element!r}, "
                f"{self._restriction_domain!r})")

    def __str__(self):
        return f"<{self._element}>|_{{{self._restriction_domain}}}"

    def shortstr(self):
        return (f"<{self._element.shortstr()}>"
                f"|_{{{self._restriction_domain}}}")

    def sub_element(self):
        """The element being restricted."""
        return self._element

    def restriction_domain(self):
        """The entity class the element is restricted to."""
        return self._restriction_domain

    def reconstruct(self, element=None, **kwargs):
        inner = element if element is not None \
            else self._element.reconstruct(**kwargs)
        return RestrictedElement(inner, self._restriction_domain)

    def num_restricted_sub_elements(self):
        return 1

    def restricted_sub_elements(self):
        return (self.sub_element(),)

    # the abstract half of the protocol reads straight off the wrapped
    # element...
    def mapping(self):
        return self.sub_element().mapping()

    @property
    def sobolev_space(self):
        return self.sub_element().sobolev_space


def _forward(name, is_property):
    get = (lambda self: getattr(self._element, name)) if is_property \
        else (lambda self, *a: getattr(self._element, name)(*a))
    get.__name__ = name
    return property(get) if is_property else get


# ... and so does the rest
for _name, _prop in (("num_sub_elements", True), ("sub_elements", True),
                     ("is_cellwise_constant", False), ("_is_linear", False),
                     ("symmetry", False), ("variant", False)):
    setattr(RestrictedElement, _name, _forward(_name, _prop))
