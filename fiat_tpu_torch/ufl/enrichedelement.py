"""Enriched element descriptions (vector sum of spaces).

FInAT's finat/ufl/enrichedelement.py; the port's copy of
``fiat_tpu.ufl.enrichedelement``."""

from .finiteelementbase import FiniteElementBase


class EnrichedElementBase(FiniteElementBase):
    """The vector sum of several finite element spaces."""

    def __init__(self, *elements):
        self._elements = elements

        def shared(label, values):
            distinct = set(values)
            if len(distinct) != 1:
                raise ValueError(f"{label} mismatch in enriched element.")
            return distinct.pop()

        cell = shared("Cell", (e.cell for e in elements))
        rshape = shared("Element reference value shape",
                        (e.reference_value_shape for e in elements))

        if isinstance(elements[0].degree(), int):
            degrees = {e.degree() for e in elements} - {None}
            degree = max(degrees) if degrees else None
        else:
            degree = tuple(map(max, zip(*[e.degree() for e in elements])))

        schemes = {e.quadrature_scheme() for e in elements} - {None}
        if len(schemes) > 1:
            raise ValueError("Quadrature scheme mismatch.")
        quad_scheme = schemes.pop() if schemes else None

        FiniteElementBase.__init__(self, type(self).__name__, cell,
                                   degree, quad_scheme, rshape)

    def mapping(self):
        return self._elements[0].mapping()

    @property
    def sobolev_space(self):
        spaces = {e.sobolev_space for e in self._elements}
        if len(spaces) == 1:
            return spaces.pop()
        # smallest space every member embeds into: intersect the
        # ancestor closures, then drop anything that is itself an
        # ancestor of another survivor
        shared = set.intersection(*({s} | set(s.parents) for s in spaces))
        for s in list(shared):
            shared -= set(s.parents)
        space, = shared
        return space

    def variant(self):
        try:
            variant, = {e.variant() for e in self._elements}
            return variant
        except ValueError:
            return None

    def reconstruct(self, **kwargs):
        return type(self)(*[e.reconstruct(**kwargs)
                            for e in self._elements])

    @property
    def embedded_subdegree(self):
        return min(e.embedded_subdegree for e in self._elements)

    @property
    def embedded_superdegree(self):
        return max(e.embedded_superdegree for e in self._elements)


class EnrichedElement(EnrichedElementBase):
    """Span of the union of subelement bases; not nodal."""

    def is_cellwise_constant(self):
        return all(e.is_cellwise_constant() for e in self._elements)

    def __repr__(self):
        return ("EnrichedElement("
                + ", ".join(repr(e) for e in self._elements) + ")")

    def __str__(self):
        return "<" + " + ".join(str(e) for e in self._elements) + ">"

    def shortstr(self):
        return "<" + " + ".join(e.shortstr() for e in self._elements) + ">"


class NodalEnrichedElement(EnrichedElementBase):
    """Same space as EnrichedElement but re-orthogonalised to the
    concatenated dual basis, so the result is nodal."""

    def is_cellwise_constant(self):
        return False

    def __repr__(self):
        return ("NodalEnrichedElement("
                + ", ".join(repr(e) for e in self._elements) + ")")

    def __str__(self):
        return ("<Nodal enriched element("
                + ", ".join(str(e) for e in self._elements) + ")>")

    def shortstr(self):
        return ("NodalEnriched("
                + ", ".join(e.shortstr() for e in self._elements) + ")")
