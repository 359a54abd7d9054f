"""HDivTrace: the facet-only DG trace element.

Counterpart of ``fiat_tpu/elements/hdiv_trace.py``.  Tabulation is only
defined on facets; cell-interior or derivative tabulation yields
``TraceError`` markers (or NaN tables when facet identification fails).
Entity-free tabulation (simplices only) bins every point to its facet with
one barycentric solve and pulls each facet's points back in one matmul.
"""

import numpy as np

from ..core import cells as cl
from ..core.barycentric import get_lagrange_points
from ..core.dualset import DualSet
from ..core.expansions import mis
from ..core.finite_element import FiniteElement
from ..core.functionals import IntegralMoment, PointEvaluation
from ..core.quadrature import FacetQuadratureRule
from .discontinuous_lagrange import DiscontinuousLagrange
from .hierarchical import Legendre
from .tensor_product import TensorProductElement

epsilon = 1e-10


class TraceError(Exception):
    """Raised/embedded when tabulating a trace element where it is not
    mathematically defined (cell interiors, derivatives)."""

    def __init__(self, msg):
        super().__init__(msg)
        self.msg = msg


def construct_dg_element(ref_el, degree, variant):
    """The DG element living on a facet cell."""
    DG = Legendre if (variant and variant.startswith("integral")) \
        else DiscontinuousLagrange
    args = (degree,) if variant is None else (degree, variant)
    shape = ref_el.get_shape()
    if shape in (cl.POINT, cl.LINE, cl.TRIANGLE):
        return DG(ref_el, *args)
    if shape == cl.QUADRILATERAL:
        dg_line = DG(cl.ufc_simplex(1), *args)
        return TensorProductElement(dg_line, dg_line)
    if shape == cl.TENSORPRODUCT:
        assert len(degree) == len(ref_el.cells)
        sub_elements = [construct_dg_element(c, d, variant)
                        for c, d in zip(ref_el.cells, degree)
                        if c.get_shape() != cl.POINT]
        if len(sub_elements) > 1:
            return TensorProductElement(*sub_elements)
        element, = sub_elements
        return element
    raise NotImplementedError(
        f"Reference cells of type {type(ref_el)} not currently supported")


def lift_facet_nodes(ells, ref_el, facet_dim, facet_id):
    """Facet functionals, pushed onto the cell entity: point duals map
    their points; moment duals push their (shared) rule forward."""
    try:
        facet_pts = get_lagrange_points(ells)
    except ValueError:
        Q_ref, = set(ell.Q for ell in ells)
        Q = FacetQuadratureRule(ref_el, facet_dim, facet_id, Q_ref)
        return [IntegralMoment(ref_el, Q, ell.f_at_qpts) for ell in ells]
    transform = ref_el.get_entity_transform(facet_dim, facet_id)
    return [PointEvaluation(ref_el, pt) for pt in transform(facet_pts)]


def barycentric_coordinates(points, vertices):
    """Barycentric coordinates of points in the simplex of ``vertices``."""
    T = (np.asarray(vertices[:-1]) - vertices[-1]).T
    invT = np.linalg.inv(T)
    points = np.asarray(points)
    bary = np.einsum("ij,kj->ki", invT, points - vertices[-1])
    return np.concatenate([bary, 1 - bary.sum(axis=1, keepdims=True)], axis=1)


def bin_points_to_facets(bary, tolerance=epsilon):
    """Facet id per point from barycentric coordinates, vectorised.
    Returns (facet_ids (npts,), ok): ok is False when any point does not
    lie on exactly one facet."""
    on_facet = np.abs(bary) < tolerance
    if not np.all(on_facet.sum(axis=1) == 1):
        return None, False
    facet_ids = np.argmax(on_facet, axis=1)
    if bary.shape[1] == 2:
        # interval: vertex i IS facet i, not the excluded coordinate
        facet_ids = 1 - facet_ids
    return facet_ids, True


def map_to_reference_facet(points, vertices, facet):
    """Map on-facet points of an n-simplex to the (n-1) reference simplex:
    drop the facet's barycentric coordinate, recombine with the reference
    vertices in one matmul."""
    bary = barycentric_coordinates(points, vertices)
    keep = np.delete(np.arange(bary.shape[1]), facet)
    R = np.asarray(cl.ufc_simplex(len(vertices) - 2).get_vertices())
    return bary[:, keep] @ R


def map_from_reference_facet(point, vertices):
    """Physical coordinate of a reference-facet point."""
    ref_verts = cl.ufc_simplex(len(vertices) - 1).get_vertices()
    coords = barycentric_coordinates([point], ref_verts)[0]
    return tuple(coords @ np.asarray(vertices))


class HDivTrace(FiniteElement):
    """The trace of an H(div) element: a DG field on the facets."""

    def __init__(self, ref_el, degree, variant=None):
        sd = ref_el.get_spatial_dimension()
        if sd == 0:
            raise ValueError("Cannot take the trace of a 0-dim cell.")

        if ref_el.get_shape() == cl.TENSORPRODUCT:
            try:
                degree = tuple(degree)
            except TypeError:
                degree = (degree,) * len(ref_el.cells)
            assert len(ref_el.cells) == len(degree)
        else:
            if ref_el.get_shape() not in [cl.LINE, cl.TRIANGLE, cl.TETRAHEDRON,
                                          cl.QUADRILATERAL]:
                raise NotImplementedError(
                    f"Trace element on a {type(ref_el)} not implemented")
            if isinstance(degree, tuple):
                raise ValueError(
                    "Need a tensor product cell for multiple degrees")

        facet_sd = sd - 1
        topology = ref_el.get_topology()

        # one DG element per facet dimension (several on TP cells)
        dg_elements = {
            dim: construct_dg_element(ref_el.construct_subelement(dim),
                                      degree, variant)
            for dim in topology
            if (sum(dim) if isinstance(dim, tuple) else dim) == facet_sd}

        nodes = []
        entity_dofs = {dim: {e: [] for e in topology[dim]} for dim in topology}
        # dof layout: facet-major within each facet dimension, giving each
        # facet a contiguous block of its DG element's dofs
        self._block_slices = {}
        for facet_dim in sorted(dg_elements):
            element = dg_elements[facet_dim]
            facet_nodes = element.dual_basis()
            for i in sorted(topology[facet_dim]):
                cur = len(nodes)
                nodes.extend(lift_facet_nodes(facet_nodes, ref_el, facet_dim, i))
                entity_dofs[facet_dim][i] = list(range(cur, len(nodes)))
                self._block_slices[(facet_dim, i)] = slice(cur, len(nodes))

        dual = DualSet(nodes, ref_el, entity_dofs)
        deg = max(e.degree() for e in dg_elements.values())
        super().__init__(ref_el, dual, order=deg, formdegree=facet_sd,
                         mapping="affine")
        self.dg_elements = dg_elements
        self.polydegree = deg

    def degree(self):
        return self.polydegree

    def get_nodal_basis(self):
        raise NotImplementedError("get_nodal_basis not implemented for traces.")

    def get_coeffs(self):
        raise NotImplementedError("get_coeffs not implemented for traces.")

    def _error_table(self, order, msg, npts=None):
        """alpha -> TraceError (or NaN/zero value tables when npts given)."""
        sd = self.ref_el.get_spatial_dimension()
        err = TraceError(msg)
        table = {}
        for i in range(order + 1):
            for alpha in mis(sd, i):
                if npts is None:
                    table[alpha] = err
                else:
                    table[alpha] = np.zeros((self.space_dimension(), npts))
                    if i > 0:
                        table[alpha] = TraceError(
                            "Gradients on trace elements are not well-defined.")
        return table

    def tabulate(self, order, points, entity=None):
        """Tabulate on a facet (by entity id, or by geometric binning when
        ``entity`` is None); non-facet requests yield TraceError/NaN."""
        sd = self.ref_el.get_spatial_dimension()
        facet_sd = sd - 1
        evalkey = (0,) * sd

        if entity is not None and entity != (sd, 0):
            # named entity: one dense block of the requested facet's values
            entity_dim, entity_id = entity
            if entity_dim not in self.dg_elements:
                return self._error_table(
                    order, "The HDivTrace element can only be tabulated on facets.")
            table = self._error_table(
                order, "Gradients on trace elements are not well-defined.",
                npts=len(points))
            element = self.dg_elements[entity_dim]
            vals = element.tabulate(0, points)[(0,) * facet_sd]
            table[evalkey][self._block_slices[(entity_dim, entity_id)]] = vals
            return table

        # entity-free: bin the points to facets geometrically
        if self.ref_el.get_shape() not in [cl.LINE, cl.TRIANGLE, cl.TETRAHEDRON]:
            raise NotImplementedError(
                "Entity-free tabulation is only supported on simplices")
        points = np.asarray(points)
        table = self._error_table(
            order, "Gradients on trace elements are not well-defined.",
            npts=len(points))
        vertices = self.ref_el.vertices
        bary = barycentric_coordinates(points, vertices)
        facet_ids, ok = bin_points_to_facets(bary)
        if not ok:
            if entity is None:
                for key in table:
                    if not isinstance(table[key], TraceError):
                        table[key].fill(np.nan)
            else:
                return self._error_table(
                    order, "The HDivTrace element can only be tabulated on facets.")
            return table

        element = self.dg_elements[facet_sd]
        for facet in np.unique(facet_ids):
            ipts = np.flatnonzero(facet_ids == facet)
            ref_pts = map_to_reference_facet(points[ipts], vertices, facet)
            vals = element.tabulate(order, ref_pts)[(0,) * facet_sd]
            rows = self._block_slices[(facet_sd, int(facet))]
            table[evalkey][rows, ipts] = vals
        return table

    def value_shape(self):
        return ()

    def dmats(self):
        raise NotImplementedError("dmats not implemented for traces.")

    def get_num_members(self, arg):
        raise NotImplementedError("get_num_members not implemented for traces.")

    @staticmethod
    def is_nodal():
        return True
