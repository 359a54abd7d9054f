"""Mixed element: concatenated subelements with block-diagonal tabulation.

Counterpart of ``fiat_tpu/elements/mixed.py``: each subelement's table
goes into its (dof rows x flattened-component columns) block of the
block grid, which is fixed by the subelement sizes."""

import numpy as np

from ..core.dualset import DualSet
from ..core.finite_element import FiniteElement


def concatenate_entity_dofs(ref_el, elements):
    """Union the parts' entity dof maps, shifting each part's dof numbers
    past the previous parts' spaces (shared with EnrichedElement)."""
    dofs = {dim: {ent: [] for ent in ents}
            for dim, ents in ref_el.get_topology().items()}
    offset = 0
    for e in elements:
        for dim, by_ent in e.entity_dofs().items():
            for ent, ids in by_ent.items():
                dofs[dim][ent].extend(offset + i for i in ids)
        offset += e.space_dimension()
    return dofs


def _block_grid(elements):
    """Row/col slices of each subelement's block in the (dof, flat
    component) plane."""
    slices = []
    row = col = 0
    for e in elements:
        nrow = e.space_dimension()
        ncol = max(int(np.prod(e.value_shape(), dtype=int)), 1)
        slices.append((slice(row, row + nrow), slice(col, col + ncol)))
        row, col = row + nrow, col + ncol
    return slices, row, col


class MixedElement(FiniteElement):
    """Concatenation of elements; tabulation is block-diagonal in the
    (dof, flattened component) plane."""

    def __init__(self, elements, ref_el=None):
        self._elements = tuple(elements)
        cells = set(e.get_reference_element() for e in self._elements)
        if ref_el is not None:
            cells.add(ref_el)
        ref_el, = cells

        # The concatenated nodes act on differently-shaped functions; they
        # are only coherent as labels, mirroring the reference behaviour.
        nodes = [L for e in self._elements for L in e.dual_basis()]
        dofs = concatenate_entity_dofs(ref_el, self._elements)
        super().__init__(ref_el, DualSet(nodes, ref_el, dofs), None,
                         mapping=None)

    def elements(self):
        return self._elements

    def num_sub_elements(self):
        return len(self._elements)

    def value_shape(self):
        _, _, ncols = _block_grid(self._elements)
        return (ncols,)

    def mapping(self):
        return [m for e in self._elements for m in e.mapping()]

    def get_nodal_basis(self):
        raise NotImplementedError("get_nodal_basis not implemented")

    def is_nodal(self):
        return all(e.is_nodal() for e in self._elements)

    def tabulate(self, order, points, entity=None):
        blocks, nrows, ncols = _block_grid(self._elements)
        out = {}
        for (rows, cols), e in zip(blocks, self._elements):
            for alpha, tab in e.tabulate(order, points, entity).items():
                if alpha not in out:
                    out[alpha] = np.zeros((nrows, ncols, len(points)),
                                          dtype=tab.dtype)
                out[alpha][rows, cols] = tab.reshape(
                    rows.stop - rows.start, cols.stop - cols.start, -1)
        return out
