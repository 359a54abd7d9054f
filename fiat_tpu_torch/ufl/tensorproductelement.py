"""Tensor-product element descriptions.

FInAT's finat/ufl/tensorproductelement.py; the port's copy of
``fiat_tpu.ufl.tensorproductelement``."""

from .cell import TensorProductCell, as_cell
from .finiteelementbase import FiniteElementBase
from .sobolevspace import DirectionalSobolevSpace


class TensorProductElement(FiniteElementBase):
    r"""The product space V_1 (x) V_2 (x) ... (x) V_d."""

    def __init__(self, *elements, cell=None, **kwargs):
        if not elements:
            raise ValueError(
                "Cannot create TensorProductElement from empty list.")
        if kwargs:
            raise ValueError(
                f"Unexpected keyword argument {next(iter(kwargs))!r}")

        families = {e.family() for e in elements}
        family = families.pop() if len(families) == 1 \
            else "TensorProductElement"

        cell = TensorProductCell(*[e.cell for e in elements]) \
            if cell is None else as_cell(cell)

        rshape = tuple(c for e in elements
                       for c in e.reference_value_shape)
        if len(rshape) > 1:
            raise ValueError(
                "Product of vector-valued elements not supported")

        FiniteElementBase.__init__(
            self, family, cell, tuple(e.degree() for e in elements),
            None, rshape)
        self._factor_elements = elements
        self._cell = cell

    def __repr__(self):
        return ("TensorProductElement("
                + ", ".join(repr(e) for e in self._factor_elements)
                + f", cell={self._cell!r})")

    def mapping(self):
        maps = {e.mapping() for e in self._factor_elements}
        return maps.pop() if maps in ({"identity"}, {"L2 Piola"}) \
            else "undefined"

    @property
    def sobolev_space(self):
        spaces = {e.sobolev_space for e in self._factor_elements}
        if len(spaces) == 1:
            return spaces.pop()
        orders = [e.sobolev_space._order
                  for e in self._factor_elements
                  for _ in range(e.cell.topological_dimension)]
        return DirectionalSobolevSpace(orders)

    @property
    def num_factor_elements(self):
        return len(self.factor_elements)

    @property
    def factor_elements(self):
        return self._factor_elements

    def reconstruct(self, **kwargs):
        new_cell = kwargs.pop("cell", self.cell)
        factors = [e.reconstruct(**kwargs) for e in self.factor_elements]
        return TensorProductElement(*factors, cell=new_cell)

    def variant(self):
        variants = {e.variant() for e in self.factor_elements}
        return variants.pop() if len(variants) == 1 else None

    def __str__(self):
        return ("TensorProductElement("
                + ", ".join(str(e) for e in self._factor_elements)
                + f", cell={self._cell})")

    def shortstr(self):
        return ("TensorProductElement("
                + ", ".join(e.shortstr() for e in self._factor_elements)
                + f", cell={self._cell})")

    @property
    def embedded_superdegree(self):
        return sum(d for d in self.degree())

    @property
    def embedded_subdegree(self):
        return min(d for d in self.degree())
