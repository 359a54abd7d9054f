"""Symbolic cell descriptions for the element-description layer.

Plays the role of ``ufl.cell`` for the port's UFL-equivalent element
descriptions (FInAT's finat/ufl modules import these from the external
UFL package; the port is self-contained, so the vocabulary lives here,
as in its counterpart ``fiat_tpu.ufl.cell``).

These are *descriptions* only -- lightweight, hashable, comparable --
and are turned into concrete reference cells of ``core.cells`` by
``fiat_tpu_torch.factory.as_fiat_cell``.
"""

import functools


_CELL_PROPERTIES = {
    # cellname: (topological dimension, num_vertices)
    "vertex": (0, 1),
    "interval": (1, 2),
    "triangle": (2, 3),
    "quadrilateral": (2, 4),
    "tetrahedron": (3, 4),
    "prism": (3, 6),
    "pyramid": (3, 5),
    "hexahedron": (3, 8),
    "pentatope": (4, 5),
    "tesseract": (4, 16),
}


class AbstractCell:
    """Base class of all symbolic cells."""

    def __eq__(self, other):
        return type(self) is type(other) and repr(self) == repr(other)

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return hash(repr(self))

    def __lt__(self, other):
        return repr(self) < repr(other)


class Cell(AbstractCell):
    """A basic cell, identified by name (e.g. ``Cell("triangle")``)."""

    def __init__(self, cellname):
        if cellname not in _CELL_PROPERTIES:
            raise ValueError(f"Unknown cellname: {cellname!r}")
        self._cellname = cellname
        tdim, nverts = _CELL_PROPERTIES[cellname]
        self._tdim = tdim
        self._num_vertices = nverts

    @property
    def cellname(self):
        return self._cellname

    @property
    def topological_dimension(self):
        return self._tdim

    @property
    def geometric_dimension(self):
        return self._tdim

    @property
    def num_vertices(self):
        return self._num_vertices

    def __repr__(self):
        return f"Cell({self._cellname!r})"

    def __str__(self):
        return self._cellname

    def reconstruct(self):
        return Cell(self._cellname)


class TensorProductCell(AbstractCell):
    """The product of two or more basic cells."""

    def __init__(self, *cells):
        if not cells:
            raise ValueError("Need at least one cell.")
        self._cells = tuple(as_cell(c) for c in cells)
        self._tdim = sum(c.topological_dimension for c in self._cells)

    @property
    def sub_cells(self):
        return self._cells

    @property
    def cellname(self):
        return "TensorProductCell"

    @property
    def topological_dimension(self):
        return self._tdim

    @property
    def geometric_dimension(self):
        return self._tdim

    @property
    def num_vertices(self):
        n = 1
        for c in self._cells:
            n *= c.num_vertices
        return n

    def __repr__(self):
        return ("TensorProductCell("
                + ", ".join(repr(c) for c in self._cells) + ")")

    def __str__(self):
        return " * ".join(str(c) for c in self._cells)


class CellSequence(AbstractCell):
    """An ordered bag of cells, the 'cell' of a MixedElement whose
    components may live on different cells."""

    def __init__(self, cells):
        self._cells = tuple(cells)

    @property
    def cells(self):
        return self._cells

    @property
    def cellname(self):
        return "CellSequence"

    @property
    def topological_dimension(self):
        dims = {c.topological_dimension for c in self._cells}
        if len(dims) != 1:
            raise ValueError("Cells in sequence have mixed dimension.")
        return dims.pop()

    def __repr__(self):
        return "CellSequence(" + ", ".join(repr(c) for c in self._cells) + ")"

    def __str__(self):
        return repr(self)


@functools.lru_cache(maxsize=None)
def _named_cell(name):
    return Cell(name)


def as_cell(cell):
    """Coerce a cell name, Cell, or tuple-of-cells to an AbstractCell."""
    if isinstance(cell, AbstractCell):
        return cell
    elif isinstance(cell, str):
        return _named_cell(cell)
    elif isinstance(cell, (tuple, list)):
        return TensorProductCell(*cell)
    else:
        raise ValueError(f"Invalid cell: {cell!r}")


# convenience instances (ufl exposes the same names)
vertex = as_cell("vertex")
interval = as_cell("interval")
triangle = as_cell("triangle")
quadrilateral = as_cell("quadrilateral")
tetrahedron = as_cell("tetrahedron")
prism = as_cell("prism")
pyramid = as_cell("pyramid")
hexahedron = as_cell("hexahedron")
pentatope = as_cell("pentatope")
tesseract = as_cell("tesseract")
