"""Mixed, Vector, and Tensor element descriptions.

Covers FInAT's finat/ufl/mixedelement.py (the port's copy of
``fiat_tpu.ufl.mixedelement``): MixedElement (flat
concatenation of subelement values), VectorElement (dim repeated copies),
TensorElement (shaped copies with optional symmetry).  Component
bookkeeping is table-driven: cumulative component offsets and canonical
symmetry slots are precomputed numpy index arrays, and component lookups
are searchsorted / ravel operations on them.
"""

import numpy as np

from .cell import CellSequence, as_cell
from .finiteelement import FiniteElement
from .finiteelementbase import FiniteElementBase, product


def shape_to_strides(sh):
    """Row-major strides of a shape."""
    return tuple(int(np.prod(sh[i + 1:], dtype=int)) for i in range(len(sh)))


def flatten_multiindex(ii, strides):
    return sum(i * s for i, s in zip(ii, strides))


def unflatten_index(i, strides):
    out = []
    for s in strides:
        out.append(int(i) // s)
        i = int(i) % s
    return tuple(out)


def _max_degree(degrees):
    """Max over possibly tuple-valued degrees."""
    if any(isinstance(d, tuple) for d in degrees):
        return tuple(map(max, zip(*(d if isinstance(d, tuple) else (d,)
                                    for d in degrees))))
    return max(degrees)


class MixedElement(FiniteElementBase):
    """A flat concatenation of subelement value components.

    Flat-component queries run against precomputed offset tables:
    ``_ref_offsets[k]`` is the first reference component of subelement k
    (and analogously per-domain physical offsets on demand)."""

    def __init__(self, *elements, **kwargs):
        if type(self) is MixedElement and kwargs:
            raise ValueError("Not expecting keyword arguments to MixedElement.")
        if len(elements) == 1 and isinstance(elements[0], (tuple, list)):
            elements = elements[0]
        elements = [MixedElement(e) if isinstance(e, (tuple, list)) else e
                    for e in elements]
        self._sub_elements = elements

        schemes = {e.quadrature_scheme() for e in elements}
        if len(schemes) > 1:
            raise ValueError("Quadrature scheme mismatch.")
        quad_scheme = schemes.pop() if schemes else None

        self._ref_offsets = np.cumsum(
            [0] + [product(e.reference_value_shape) for e in elements])
        reference_value_shape = kwargs.get("reference_value_shape",
                                           (int(self._ref_offsets[-1]),))

        degrees = {e.degree() for e in elements} - {None}
        degree = _max_degree(degrees) if degrees else None
        FiniteElementBase.__init__(self, "Mixed", self._make_cell(), degree,
                                   quad_scheme, reference_value_shape)

    def _make_cell(self):
        if not self._sub_elements:
            return None
        return CellSequence(tuple(e.cell for e in self._sub_elements))

    def _phys_offsets(self, domain=None):
        return np.cumsum(
            [0] + [e.value_size(domain) for e in self._sub_elements])

    # -- structure -------------------------------------------------------------

    @property
    def num_sub_elements(self):
        return len(self._sub_elements)

    @property
    def sub_elements(self):
        return self._sub_elements

    def value_shape(self, domain=None):
        return (int(self._phys_offsets(domain)[-1]),)

    def reconstruct_from_elements(self, *elements):
        if all(a == b for a, b in zip(elements, self._sub_elements)):
            return self
        return MixedElement(*elements)

    def reconstruct(self, **kwargs):
        cell = kwargs.pop("cell", None)
        if cell is None:
            cells = self.cell.cells
        elif isinstance(cell, CellSequence):
            cells = cell.cells
        else:
            cells = [cell] * self.num_sub_elements
        return type(self)(*[e.reconstruct(cell=c, **kwargs)
                            for c, e in zip(cells, self._sub_elements)])

    # -- component extraction ---------------------------------------------------

    def _locate(self, j, offsets):
        """(subelement index, local flat component) for flat component j."""
        k = int(np.searchsorted(offsets, j, side="right")) - 1
        if not 0 <= k < self.num_sub_elements:
            raise ValueError(f"Component {j} out of range.")
        return k, int(j) - int(offsets[k])

    def extract_subelement_component(self, i, domain=None):
        if isinstance(i, int):
            i = (i,)
        self._check_component(i, domain)
        if len(self.value_shape(domain)) == 1:
            k, j = self._locate(i[0], self._phys_offsets(domain))
            sh = self._sub_elements[k].value_shape(domain)
            return (k, unflatten_index(j, shape_to_strides(sh)))
        k = i[0]
        if k >= self.num_sub_elements:
            raise ValueError(f"Illegal component index {i}.")
        return (k, i[1:])

    def extract_component(self, i, domain=None):
        k, component = self.extract_subelement_component(i, domain)
        return self._sub_elements[k].extract_component(component, domain)

    def extract_subelement_reference_component(self, i):
        if isinstance(i, int):
            i = (i,)
        self._check_reference_component(i)
        assert len(self.reference_value_shape) == 1
        k, j = self._locate(i[0], self._ref_offsets)
        sh = self._sub_elements[k].reference_value_shape
        return (k, unflatten_index(j, shape_to_strides(sh)))

    def extract_reference_component(self, i):
        k, comp = self.extract_subelement_reference_component(i)
        return self._sub_elements[k].extract_reference_component(comp)

    def symmetry(self, domain=None):
        """Flat-component symmetry map, each subelement's shifted by its
        offset."""
        sm = {}
        offsets = self._phys_offsets(domain)
        for off, e in zip(offsets, self._sub_elements):
            st = shape_to_strides(e.value_shape(domain))
            sm.update(
                {(flatten_multiindex(c0, st) + int(off),):
                 (flatten_multiindex(c1, st) + int(off),)
                 for c0, c1 in e.symmetry(domain).items()})
        return sm

    # -- scalar metadata --------------------------------------------------------

    def _is_linear(self):
        return all(e._is_linear() for e in self._sub_elements)

    @property
    def sobolev_space(self):
        return max(e.sobolev_space for e in self._sub_elements)

    def mapping(self):
        if all(e.mapping() == "identity" for e in self._sub_elements):
            return "identity"
        return "undefined"

    def is_cellwise_constant(self, component=None):
        if component is None:
            return all(e.is_cellwise_constant() for e in self._sub_elements)
        i, e = self.extract_component(component)
        return e.is_cellwise_constant()

    def degree(self, component=None):
        if component is None:
            return self._degree
        i, e = self.extract_component(component)
        return e.degree()

    @property
    def embedded_subdegree(self):
        return min(e.embedded_subdegree for e in self._sub_elements)

    @property
    def embedded_superdegree(self):
        return max(e.embedded_superdegree for e in self._sub_elements)

    def variant(self):
        variants = {e.variant() for e in self._sub_elements}
        return variants.pop() if len(variants) == 1 else None

    @property
    def pullback(self):
        from .pullback import MixedPullback
        return MixedPullback(self)

    def __repr__(self):
        return "MixedElement(" + ", ".join(map(repr, self._sub_elements)) + ")"

    def __str__(self):
        return ("<Mixed element: ("
                + ", ".join(map(str, self._sub_elements)) + ")>")

    def shortstr(self):
        return ("Mixed<"
                + ", ".join(e.shortstr() for e in self._sub_elements) + ">")


class _ReplicatedElement(MixedElement):
    """Shared machinery of Vector/Tensor elements: copies of one
    subelement, the copy structure carried by shape tables."""

    def _make_cell(self):
        if not self._sub_elements:
            return None
        cell, = set(e.cell for e in self._sub_elements)
        return cell

    def variant(self):
        return self._sub_element.variant()

    def mapping(self):
        return self._mapping

    def __repr__(self):
        return self._repr


def _resolve_sub_element(family, cell, degree, **kwargs):
    """Accept either a ready element or (family, cell, degree) specs."""
    if isinstance(family, FiniteElementBase):
        return family, family.cell
    if cell is not None:
        cell = as_cell(cell)
    return FiniteElement(family, cell, degree, **kwargs), cell


class VectorElement(_ReplicatedElement):
    """dim copies of one subelement, vector-valued."""

    def __init__(self, family, cell=None, degree=None, dim=None,
                 form_degree=None, quad_scheme=None, variant=None):
        sub_element, cell = _resolve_sub_element(
            family, cell, degree, form_degree=form_degree,
            quad_scheme=quad_scheme, variant=variant)
        if dim is None:
            if cell is None:
                raise ValueError("Cannot infer vector dimension without a cell.")
            dim = cell.topological_dimension

        self._mapping = sub_element.mapping()
        reference_value_shape = (dim,) + sub_element.reference_value_shape
        MixedElement.__init__(self, [sub_element] * dim,
                              reference_value_shape=reference_value_shape)
        FiniteElementBase.__init__(self, sub_element.family(),
                                   sub_element.cell, sub_element.degree(),
                                   sub_element.quadrature_scheme(),
                                   reference_value_shape)
        self._sub_element = sub_element
        self._repr = f"VectorElement({sub_element!r}, dim={dim})"

    def value_shape(self, domain=None):
        return (self.num_sub_elements,) + self._sub_element.value_shape(domain)

    def reconstruct(self, sub_element=None, **kwargs):
        if sub_element is None:
            sub_element = self._sub_element.reconstruct(**kwargs)
        return VectorElement(sub_element, dim=self.num_sub_elements)

    @property
    def pullback(self):
        return self._sub_element.pullback

    def __str__(self):
        return (f"<vector element with {self.num_sub_elements} "
                f"components of {self._sub_element}>")

    def shortstr(self):
        return (f"Vector<{self.num_sub_elements} x "
                f"{self._sub_element.shortstr()}>")


def _canonical_slots(shape, symmetry):
    """Slot table of a symmetric tensor: component index -> slot id, with
    symmetric partners sharing the slot of their canonical component.
    Returns ({index: slot}, num_slots)."""
    slots = {}
    free = 0
    for index in (np.ndindex(*shape) if shape else [()]):
        if index not in symmetry:
            slots[index] = free
            free += 1
    for index, canon in symmetry.items():
        slots[index] = slots[canon]
    return slots, free


class TensorElement(_ReplicatedElement):
    """Shaped copies of one subelement, with optional symmetry."""

    def __init__(self, family, cell=None, degree=None, shape=None,
                 symmetry=None, quad_scheme=None, variant=None):
        sub_element, cell = _resolve_sub_element(
            family, cell, degree, quad_scheme=quad_scheme, variant=variant)
        if shape is None:
            if cell is None:
                raise ValueError("Cannot infer tensor shape without a cell.")
            shape = (cell.topological_dimension,) * 2

        if symmetry is None:
            symmetry = {}
        elif symmetry is True:
            if not (len(shape) == 2 and shape[0] == shape[1]):
                raise ValueError(
                    "Cannot set automatic symmetry for non-square tensor.")
            symmetry = {(i, j): (j, i)
                        for i, j in np.ndindex(shape) if i > j}
        elif not isinstance(symmetry, dict):
            raise ValueError("symmetry must be None, True, or a dict.")

        for i, j in symmetry.items():
            if len(i) != len(j):
                raise ValueError("Non-matching symmetry index lengths.")
            if not all(0 <= a < n and 0 <= b < n
                       for a, b, n in zip(i, j, shape)):
                raise ValueError("Symmetry dimensions out of bounds.")

        slots, num_slots = _canonical_slots(shape, symmetry)

        if symmetry:
            reference_value_shape = (num_slots,)
            self._mapping = "symmetries"
        else:
            reference_value_shape = shape
            self._mapping = sub_element.mapping()
        reference_value_shape += sub_element.reference_value_shape
        MixedElement.__init__(self, [sub_element] * num_slots,
                              reference_value_shape=reference_value_shape)
        self._family = sub_element.family()
        self._degree = sub_element.degree()
        self._sub_element = sub_element
        self._shape = shape
        self._symmetry = symmetry
        self._sub_element_mapping = slots
        self._flattened_sub_element_mapping = [
            slots[index] for index in (np.ndindex(*shape) if shape else [()])]
        self._repr = (f"TensorElement({sub_element!r}, shape={shape}, "
                      f"symmetry={symmetry})")

    def value_shape(self, domain=None):
        return self._shape + self._sub_element.value_shape(domain)

    def symmetry(self, domain=None):
        return self._symmetry

    def flattened_sub_element_mapping(self):
        return self._flattened_sub_element_mapping

    def extract_subelement_component(self, i, domain=None):
        if isinstance(i, int):
            i = (i,)
        self._check_component(i, domain)
        i = self.symmetry(domain).get(i, i)
        rank = len(self._shape)
        ii, jj = i[:rank], i[rank:]
        if ii not in self._sub_element_mapping:
            raise ValueError(f"Illegal component index {i}.")
        return (self._sub_element_mapping[ii], jj)

    def reconstruct(self, sub_element=None, **kwargs):
        if sub_element is None:
            sub_element = self._sub_element.reconstruct(**kwargs)
        return TensorElement(sub_element, shape=self._shape,
                             symmetry=self._symmetry)

    @property
    def pullback(self):
        if self._symmetry:
            from .pullback import SymmetricPullback
            slots, _ = _canonical_slots(self._shape, self._symmetry)
            return SymmetricPullback(self, slots)
        return self._sub_element.pullback

    def _symmetry_str(self):
        if not self._symmetry:
            return ""
        tmp = ", ".join(f"{a} -> {b}" for a, b in self._symmetry.items())
        return f" with symmetries ({tmp})"

    def __str__(self):
        return (f"<tensor element with shape {self.reference_value_shape} "
                f"of {self._sub_element}{self._symmetry_str()}>")

    def shortstr(self):
        return (f"Tensor<{self.reference_value_shape} x "
                f"{self._sub_element.shortstr()}{self._symmetry_str()}>")


# reference-compat alias
_unflatten = unflatten_index
