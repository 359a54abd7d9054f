"""HDiv/HCurl conforming wrappers and WithMapping.

Behavioural parity: FInAT's finat/ufl/hdivcurl.py (the port's copy of
``fiat_tpu.ufl.hdivcurl``).  The callable HDiv/HCurl Sobolev-space
instances live in ``sobolevspace``.
Both Piola wrappers share one base class; WithMapping delegates its
whole surface through __getattr__."""

from .finiteelementbase import FiniteElementBase
from .sobolevspace import L2
from .sobolevspace import HCurl as HCurlSobolevSpace
from .sobolevspace import HDiv as HDivSobolevSpace

# the callable space instances double as element constructors:
# HDiv(element) -> HDivElement(element)
HDiv = HDivSobolevSpace
HCurl = HCurlSobolevSpace


class _PiolaWrappedElement(FiniteElementBase):
    """Common shape/degree/delegation logic of the HDiv/HCurl wrappers:
    the wrapped outer-product element acquires a vector value shape and
    a Piola map."""

    _map_name = None
    _space = None

    def __init__(self, element):
        self._element = element
        super().__init__("TensorProductElement", element.cell,
                         element.degree(), element.quadrature_scheme(),
                         (element.cell.topological_dimension,))

    def __repr__(self):
        return f"{type(self).__name__}({self._element!r})"

    __str__ = __repr__

    def shortstr(self):
        return f"{type(self).__name__}({self._element.shortstr()})"

    def mapping(self):
        return self._map_name

    @property
    def sobolev_space(self):
        return self._space

    def reconstruct(self, **kwargs):
        return type(self)(self._element.reconstruct(**kwargs))

    def variant(self):
        return self._element.variant()

    @property
    def embedded_subdegree(self):
        return self._element.embedded_subdegree

    @property
    def embedded_superdegree(self):
        return self._element.embedded_superdegree


class HDivElement(_PiolaWrappedElement):
    """A div-conforming version of an outer-product element."""
    _map_name = "contravariant Piola"
    _space = HDivSobolevSpace


class HCurlElement(_PiolaWrappedElement):
    """A curl-conforming version of an outer-product element."""
    _map_name = "covariant Piola"
    _space = HCurlSobolevSpace


def _piola_shape(mapping, tdim):
    """Value shape a Piola map imposes, or None to defer to the
    wrappee."""
    if mapping in ("covariant Piola", "contravariant Piola"):
        return (tdim,)
    if mapping in ("double covariant Piola", "double contravariant Piola"):
        return (tdim, tdim)
    return None


class WithMapping(FiniteElementBase):
    """Specify an alternative reference mapping for the wrappee, e.g.
    ``WithMapping(E, "identity")`` to drop a Piola map."""

    def __init__(self, wrapee, mapping):
        if mapping == "symmetries":
            raise ValueError("Can't change mapping to 'symmetries'")
        self._mapping = mapping
        self.wrapee = wrapee

    def __getattr__(self, attr):
        if not attr.startswith("_") and attr != "wrapee":
            try:
                return getattr(self.wrapee, attr)
            except AttributeError:
                pass
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {attr!r}")

    def __repr__(self):
        return f"WithMapping({self.wrapee!r}, {self._mapping!r})"

    def __str__(self):
        return f"WithMapping({self.wrapee!r}, {self._mapping})"

    def shortstr(self):
        return f"WithMapping({self.wrapee.shortstr()}, {self._mapping})"

    def mapping(self):
        return self._mapping

    @property
    def cell(self):
        return self.wrapee.cell

    def value_shape(self, domain=None):
        forced = _piola_shape(self.mapping(),
                              self.cell.topological_dimension)
        return self.wrapee.value_shape(domain) if forced is None \
            else forced

    @property
    def reference_value_shape(self):
        forced = _piola_shape(self.mapping(),
                              self.cell.topological_dimension)
        return self.wrapee.reference_value_shape if forced is None \
            else forced

    @property
    def sobolev_space(self):
        if self.wrapee.mapping() == self.mapping():
            return self.wrapee.sobolev_space
        return L2

    def reconstruct(self, **kwargs):
        mapping = kwargs.pop("mapping", self._mapping)
        return type(self)(self.wrapee.reconstruct(**kwargs), mapping)

    def variant(self):
        return self.wrapee.variant()

    def degree(self, component=None):
        return self.wrapee.degree(component)

    def quadrature_scheme(self):
        return self.wrapee.quadrature_scheme()

    def family(self):
        return self.wrapee.family()

    @property
    def embedded_subdegree(self):
        return self.wrapee.embedded_subdegree

    @property
    def embedded_superdegree(self):
        return self.wrapee.embedded_superdegree
