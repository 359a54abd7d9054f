"""Base class for symbolic element descriptions.

Behavioural parity with FInAT's finat/ufl/finiteelementbase.py (the
port's copy of ``fiat_tpu.ufl.finiteelementbase``), with a
self-contained pullback vocabulary replacing
``ufl.pullback`` (the physical value shape is derived directly from the
mapping name)."""

from abc import ABC, abstractmethod
from hashlib import md5

import numpy as np

from .cell import AbstractCell, as_cell


def product(shape):
    return int(np.prod(shape, dtype=int))


def istr(o):
    """Format, with ? for None (pretty-printing helper)."""
    return "?" if o is None else str(o)


# how each mapping turns the reference value shape into the physical one
_SHAPE_RULES = {
    "identity": "reference",
    "L2 Piola": "reference",
    "custom": "reference",
    "physical": "reference",
    "undefined": "reference",
    "covariant Piola": "tdim",
    "contravariant Piola": "tdim",
    "double covariant Piola": "tdim2",
    "double contravariant Piola": "tdim2",
    "covariant contravariant Piola": "tdim2",
    "symmetries": "symmetries",
}


def _physical_value_shape(mapping, element):
    rule = _SHAPE_RULES.get(mapping)
    if rule == "reference":
        return element.reference_value_shape
    cell = element.cell
    tdim = None if cell is None else cell.topological_dimension
    if rule == "tdim":
        return (tdim,)
    if rule == "tdim2":
        return (tdim, tdim)
    if rule == "symmetries":
        # symmetric tensors store a compressed reference vector but
        # expose the full physical shape
        return element._shape + element.sub_elements[0].value_shape()
    raise ValueError(f"Unsupported mapping: {mapping}")


def _as_component(i, shape, kind):
    """Normalise a component index to a tuple and bounds-check it."""
    if isinstance(i, int):
        i = (i,)
    if len(i) != len(shape) or any(int(j) >= k for j, k in zip(i, shape)):
        raise ValueError(
            f"Illegal component index {i} for {kind} shape {shape}.")
    return i


class FiniteElementBase(ABC):
    """Base class for all symbolic element descriptions."""

    def __init__(self, family, cell, degree, quad_scheme,
                 reference_value_shape):
        if degree is not None and not isinstance(degree, (int, tuple)):
            raise ValueError(f"Bad degree: {degree!r}")
        if not isinstance(reference_value_shape, tuple):
            raise ValueError(
                f"Bad reference_value_shape: {reference_value_shape!r}")
        if cell is not None:
            cell = as_cell(cell)
            if not isinstance(cell, AbstractCell):
                raise ValueError(f"Bad cell: {cell!r}")
        self._family = family
        self._cell = cell
        self._degree = degree
        self._reference_value_shape = reference_value_shape
        self._quad_scheme = quad_scheme

    @abstractmethod
    def __repr__(self):
        """Format as string for evaluation as a Python object."""

    @property
    @abstractmethod
    def sobolev_space(self):
        """The underlying Sobolev space."""

    @abstractmethod
    def mapping(self):
        """The reference-to-physical mapping name."""

    def _is_globally_constant(self):
        return False

    def _is_linear(self):
        return False

    # -- identity: descriptions hash/compare by their repr -----------------
    def _ufl_hash_data_(self):
        return repr(self)

    def _ufl_signature_data_(self):
        return repr(self)

    def __hash__(self):
        digest = md5(self._ufl_hash_data_().encode()).digest()
        return int.from_bytes(digest, byteorder="big")

    def __eq__(self, other):
        return (type(self) is type(other)
                and self._ufl_hash_data_() == other._ufl_hash_data_())

    def __ne__(self, other):
        return not (self == other)

    def __lt__(self, other):
        return repr(self) < repr(other)  # canonical text order

    # -- basic metadata -----------------------------------------------------
    def family(self):
        return self._family

    def variant(self):
        return None

    def degree(self, component=None):
        return self._degree

    def quadrature_scheme(self):
        return self._quad_scheme

    @property
    def cell(self):
        return self._cell

    def is_cellwise_constant(self, component=None):
        return self._is_globally_constant() or 0 == self.degree()

    # -- value shapes --------------------------------------------------------
    def value_shape(self, domain=None):
        """Shape of values on a physical domain."""
        return _physical_value_shape(self.mapping(), self)

    def value_size(self, domain=None):
        return product(self.value_shape(domain))

    @property
    def reference_value_shape(self):
        return self._reference_value_shape

    @property
    def reference_value_size(self):
        return product(self.reference_value_shape)

    def symmetry(self, domain=None):
        """Component symmetry map (c0 -> c1: c0 is stored as c1)."""
        return {}

    # -- component extraction ------------------------------------------------
    def extract_subelement_component(self, i, domain=None):
        i = _as_component(i, self.value_shape(domain), "value")
        return (None, i)

    def extract_component(self, i, domain=None):
        i = _as_component(i, self.value_shape(domain), "value")
        return (i, self)

    def extract_subelement_reference_component(self, i):
        i = _as_component(i, self.reference_value_shape, "reference")
        return (None, i)

    def extract_reference_component(self, i):
        i = _as_component(i, self.reference_value_shape, "reference")
        return (i, self)

    def _check_component(self, i, domain=None):
        _as_component(i, self.value_shape(domain), "value")

    def _check_reference_component(self, i):
        _as_component(i, self.reference_value_shape, "reference")

    @property
    def num_sub_elements(self):
        return 0

    @property
    def sub_elements(self):
        return []

    # -- element algebra -----------------------------------------------------
    def __add__(self, other):
        """element + element -> EnrichedElement."""
        if not isinstance(other, FiniteElementBase):
            raise ValueError(f"Cannot enrich element with {type(other)}.")
        from .enrichedelement import EnrichedElement
        return EnrichedElement(self, other)

    def __mul__(self, other):
        """element * element -> MixedElement."""
        if not isinstance(other, FiniteElementBase):
            raise ValueError(f"Cannot mix element with {type(other)}.")
        from .mixedelement import MixedElement
        return MixedElement(self, other)

    def __getitem__(self, index):
        """element["facet"] etc. -> RestrictedElement."""
        from .restrictedelement import valid_restriction_domains
        if index in valid_restriction_domains:
            from .restrictedelement import RestrictedElement
            return RestrictedElement(self, index)
        raise KeyError(f"Invalid index for restriction: {index!r}")

    def __iter__(self):
        raise TypeError(f"'{type(self).__name__}' object is not iterable")

    @property
    def embedded_superdegree(self):
        return self.degree()

    @property
    def embedded_subdegree(self):
        return self.degree()

    @property
    def pullback(self):
        """The reference-to-physical pullback singleton."""
        from .pullback import supported_pullbacks
        name = self.mapping()
        if name not in supported_pullbacks:
            raise ValueError(f"Unsupported mapping: {name}")
        return supported_pullbacks[name]
