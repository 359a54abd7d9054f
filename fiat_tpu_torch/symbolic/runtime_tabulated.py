"""Runtime-tabulated placeholder element (counterpart of
``fiat_tpu/symbolic/runtime_tabulated.py``, role of FInAT's
``finat/runtime_tabulated.py``): tabulations arrive at run time as named
arrays.  Where FInAT emits named gem.Variables for a downstream code
generator, this element asks a ``table_provider`` callback for the array
(numpy, or a torch tensor on the caller's device)."""

from ..core import cells as cl
from ..core.expansions import mis
from .base import FiniteElementBase
from .point_set import _is_traced


class RuntimeTabulated(FiniteElementBase):
    """1D element whose tabulations are supplied at run time."""

    def __init__(self, cell, degree, variant=None, shift_axes=0,
                 restriction=None, continuous=True, table_provider=None):
        if cell.get_shape() != cl.LINE:
            raise NotImplementedError("Runtime tabulated elements are 1D only.")
        assert isinstance(variant, str)
        assert isinstance(shift_axes, int) and 0 <= shift_axes
        assert isinstance(continuous, bool)
        assert restriction in [None, "+", "-"]
        self._cell = cell
        self._degree = degree
        self.variant = variant
        self.shift_axes = shift_axes
        self.restriction = restriction
        self.continuous = continuous
        self.table_provider = table_provider

    @property
    def cell(self):
        return self._cell

    @property
    def complex(self):
        return self._cell

    @property
    def degree(self):
        return self._degree

    @property
    def formdegree(self):
        return 0 if self.continuous else self.cell.get_spatial_dimension()

    def entity_dofs(self):
        raise NotImplementedError("I cannot tell where my DoFs are... :-/")

    def space_dimension(self):
        return self.degree + 1

    def table_name(self, alpha):
        """The canonical kernel-argument name of one derivative table."""
        return "rt_{}_{}_{}_{}_{}_{}".format(
            self.variant, self.degree, "".join(map(str, alpha)),
            self.shift_axes, "c" if self.continuous else "d",
            {None: "", "+": "p", "-": "m"}[self.restriction])

    def basis_evaluation(self, order, ps, entity=None, coordinate_mapping=None):
        if self.table_provider is None:
            raise ValueError(
                "RuntimeTabulated needs a table_provider to tabulate")
        dimension = self.cell.get_spatial_dimension()
        shape = ps.points_shape + self.index_shape + self.value_shape
        result = {}
        for derivative in range(order + 1):
            for alpha in mis(dimension, derivative):
                table = self.table_provider(self.table_name(alpha), shape)
                # reorder to index_shape + value_shape + points_shape
                npts_axes = len(ps.points_shape)
                perm = (tuple(range(npts_axes, len(shape)))
                        + tuple(range(npts_axes)))
                result[alpha] = (table.permute(perm) if _is_traced(table)
                                 else table.transpose(perm))
        return result

    def point_evaluation(self, order, point, entity=None,
                         coordinate_mapping=None):
        raise NotImplementedError(
            "Point evaluation not supported for runtime tabulated elements")

    @property
    def index_shape(self):
        return (self.space_dimension(),)

    @property
    def value_shape(self):
        return ()

    @property
    def mapping(self):
        return "affine"
