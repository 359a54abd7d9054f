"""Bridge from the numerical element zoo to the symbolic layer.

Counterpart of ``fiat_tpu/symbolic/fiat_bridge.py`` (role of FInAT's
``finat/fiat_elements.py``), restructured around the package's array
encodings:

* ``FiatElement`` wraps a core (Ciarlet) element.  Its reference-query
  API is *generated* from one delegation table rather than written out
  per attribute -- the core element is the single source of truth.
* ``basis_evaluation`` packs tabulations as arrays shaped
  ``(space_dim, *value_shape, *points_shape)``.  With a static point set
  this is host numpy, the core element's own tabulation; with tensor
  points (an ``UnknownPointSet``) it runs as torch operations on the
  points' device, in their dtype: the affine entity transform, the
  expansion recurrence of ``core.expansions`` (which takes tensors) and
  one ``torch.matmul`` with the coefficients -- fiat_tpu's traced path,
  which XLA runs outside any Pallas kernel; no kernel runs here either.
  Elements without such a basis (Serendipity, the trimmed and BDM cube
  families, Bernstein) expand in an orthonormal basis of their cell by
  collocation on the host once (``_collocated_basis``); the trace element
  bins its points to facets on the device.
* ``dual_basis`` flattens the whole dual set's struct-of-arrays term
  encoding (core.functionals) into one dense weight tensor Q over a
  merged point set, using the same lexsort-group point merging idiom as
  ``core.macro``'s composite quadrature.
* the ~30 per-family wrapper classes FInAT spells out by hand are
  stamped out from name tables at module import.

Derivative tables beyond the polynomial degree are exact zeros."""

import abc
import math
from functools import cached_property

import numpy as np
import torch

from .. import elements as fe
from ..core import cells as cl
from ..core.expansions import ExpansionSet, mis
from ..core.quadrature import GaussLegendreQuadratureLineRule
from ..elements.bernstein import Bernstein as _CoreBernstein
from ..elements.hdiv_trace import HDivTrace as _CoreTrace
from ..elements.hdiv_trace import TraceError
from ..elements.hdiv_trace import epsilon as FACET_TOLERANCE
from ..utils.jets import multiindices
from .base import FiniteElementBase
from .point_set import PointSet, _is_traced, flat_points


class FiatElement(FiniteElementBase):
    """Wrap a core element for symbolic consumption."""

    def __init__(self, fiat_element):
        super().__init__()
        self._element = fiat_element

    @property
    def fiat_equivalent(self):
        return self._element

    @property
    def index_shape(self):
        return (self._element.space_dimension(),)

    @property
    def mapping(self):
        kinds = set(self._element.mapping())
        return kinds.pop() if len(kinds) == 1 else None

    def basis_evaluation(self, order, ps, entity=None, coordinate_mapping=None):
        """{alpha: array (space_dim [+ value axes] + points_shape)}.

        Constrained elements (e.g. Bell) tabulate more rows than the
        space dimension; all rows are kept here and the physically-mapped
        layer restricts after transformation."""
        pts = flat_points(ps)
        tabulate = (self._traced_tabulate if _is_traced(pts)
                    else lambda o, p, e: self._element.tabulate(o, p, e))
        vshape = self.value_shape

        def pack(table):
            if isinstance(table, Exception):
                return table
            return table.reshape(table.shape[:1] + vshape + ps.points_shape)

        return {alpha: pack(t)
                for alpha, t in tabulate(order, pts, entity).items()}

    def _traced_tabulate(self, order, pts, entity):
        """Tabulation at tensor points, on their device in their dtype:
        affine entity transform + the expansion recurrence + the
        coefficient matmul (the trace element: facet binning)."""
        element = self._element
        if isinstance(element, _CoreTrace):
            return _trace_tables(element, order, pts, entity)
        ref_el = element.get_reference_element()
        if entity is None:
            entity = (ref_el.get_spatial_dimension(), 0)
        cell_pts = ref_el.get_entity_transform(*entity)(pts)
        es, degree, coeffs = self._tensor_basis
        raw = es._tabulate(degree, cell_pts, order=order)
        lead = coeffs.shape[:-1]
        flat = pts.new_tensor(coeffs.reshape(-1, coeffs.shape[-1]))
        tables = {alpha: (flat @ tab).reshape(lead + tab.shape[-1:])
                  for alpha, tab in raw.items()}
        if isinstance(element, _CoreBernstein) and degree > 1:
            # the host tables keep FIAT's top-order Bernstein quirk
            # (elements/bernstein.py: D^n reported as 1/n! of the true
            # derivative); the tensor path reports what the host does
            for alpha in tables:
                if sum(alpha) == degree:
                    tables[alpha] = tables[alpha] / math.factorial(degree)
        return tables

    @cached_property
    def _tensor_basis(self):
        """(expansion set, degree, coefficients (rows..., nexp)) of the
        tensor path: the element's nodal basis, else a collocated one."""
        try:
            poly_set = self._element.get_nodal_basis()
        except (AttributeError, NotImplementedError):
            return _collocated_basis(self._element)
        return (poly_set.get_expansion_set(), poly_set.get_embedded_degree(),
                np.asarray(poly_set.get_coeffs()))

    @cached_property
    def _dual_basis(self):
        """(Q dense weights (nnodes, npts, *value_shape), merged points).

        Rides the struct-of-arrays functional encoding: every value term
        of every node is one (node, point-row, component, weight) tuple;
        coincident points across nodes are merged by lexsort grouping and
        Q is built with a single scatter-add."""
        nodes = self._element.dual_basis()[:self._element.space_dimension()]
        if any(n.max_deriv_order for n in nodes):
            raise NotImplementedError(
                "Dual bases with derivative nodes have no pointwise dual")

        counts = [n.weights.size for n in nodes]
        pts = np.concatenate([n.points[n.pt_ids] for n in nodes], axis=0)
        node_of = np.repeat(np.arange(len(nodes)), counts)
        comp_of = np.concatenate([n.comps for n in nodes])
        w = np.concatenate([n.weights for n in nodes])

        # Merge numerically-coincident term points: lexsort rows, open a
        # new group wherever consecutive sorted rows differ beyond atol,
        # then renumber groups in first-occurrence order so the merged
        # point list is stable against node ordering.
        order = np.lexsort(pts.T[::-1])
        sorted_pts = pts[order]
        breaks = np.abs(np.diff(sorted_pts, axis=0)).max(axis=1) > 1e-12
        gid = np.empty(len(pts), dtype=np.intp)
        gid[order] = np.concatenate(([0], np.cumsum(breaks)))
        first_row = np.full(gid.max() + 1, len(pts), dtype=np.intp)
        np.minimum.at(first_row, gid, np.arange(len(pts)))
        rank = np.empty_like(first_row)
        rank[np.argsort(first_row, kind="stable")] = np.arange(len(first_row))
        point_of = rank[gid]
        merged = pts[np.sort(first_row)]

        ncomp = max(int(np.prod(self.value_shape, dtype=int)), 1)
        Q = np.zeros((len(nodes), len(merged), ncomp))
        np.add.at(Q, (node_of, point_of, comp_of), w)
        return Q.reshape(len(nodes), len(merged), *self.value_shape), merged

    @property
    def dual_basis(self):
        Q, pts = self._dual_basis
        return Q, PointSet(pts)


class ScalarFiatElement(FiatElement):
    value_shape = ()


class VectorFiatElement(FiatElement):
    @property
    def value_shape(self):
        return (self.cell.get_spatial_dimension(),)


# The wrapped element answers every reference query; generate the
# pass-throughs instead of hand-writing them.
def _delegate(attr, call, as_property):
    def fwd(self):
        return getattr(self._element, attr)() if call \
            else getattr(self._element, attr)
    fwd.__name__ = attr
    return property(fwd) if as_property else fwd


for _name, _attr in [("cell", "get_reference_element"),
                     ("complex", "get_reference_complex"),
                     ("degree", "degree"),
                     ("formdegree", "get_formdegree"),
                     ("entity_permutations", "entity_permutations"),
                     ("value_shape", "value_shape")]:
    setattr(FiatElement, _name, _delegate(_attr, call=True, as_property=True))
for _name in ["entity_dofs", "entity_closure_dofs", "space_dimension"]:
    setattr(FiatElement, _name, _delegate(_name, call=True, as_property=False))
for _cls in (FiatElement, ScalarFiatElement, VectorFiatElement):
    abc.update_abstractmethods(_cls)


# -- family wrappers (names match FInAT's API), stamped out
#    from name tables: symbolic family == core family + packing policy.

def _stamp(base, families):
    for name in families:
        core_cls = getattr(fe, name)

        def __init__(self, cell, degree, _cls=core_cls, **kwargs):
            FiatElement.__init__(self, _cls(cell, degree, **kwargs))

        globals()[name] = type(name, (base,), {
            "__init__": __init__, "__module__": __name__,
            "__doc__": f"Symbolic wrapper over elements.{name}."})


_stamp(FiatElement, [
    "Regge", "HellanHerrmannJohnson",
    "GopalakrishnanLedererSchoberlFirstKind",
    "GopalakrishnanLedererSchoberlSecondKind",
])
_stamp(ScalarFiatElement, [
    "Bernstein", "Bubble", "FacetBubble", "CrouzeixRaviart", "Lagrange",
    "DiscontinuousLagrange", "Histopolation", "Serendipity", "DPC",
    "DiscontinuousTaylor", "HDivTrace",
])
_stamp(VectorFiatElement, [
    "RaviartThomas", "BrezziDouglasMarini", "TrimmedSerendipityEdge",
    "TrimmedSerendipityFace", "TrimmedSerendipityDiv",
    "TrimmedSerendipityCurl", "BrezziDouglasMariniCubeEdge",
    "BrezziDouglasMariniCubeFace", "BrezziDouglasFortinMarini",
    "Nedelec", "NedelecSecondKind",
])


class Real(DiscontinuousLagrange):  # noqa: F821
    ...


# -- the tensor path's helpers ------------------------------------------------

class _ProductExpansion:
    """The tensor product of the interval's Dubiner bases on the axes of a
    quadrilateral or hexahedron ([0, 1]^d), degree n on each axis: a basis
    of Q_n that tabulates numpy or tensor points with derivatives."""

    def __init__(self, dim):
        self.dim = dim
        self.line = ExpansionSet(cl.ufc_simplex(1))

    def lattice(self, n, extra=0):
        """Gauss-Legendre product grid of (n + 1 + extra)^d points."""
        x = GaussLegendreQuadratureLineRule(cl.ufc_simplex(1), n + 1 + extra).get_points()
        grid = np.meshgrid(*([x[:, 0]] * self.dim), indexing="ij")
        return np.stack([g.ravel() for g in grid], axis=1)

    def _tabulate(self, n, pts, order=0):
        axes = [self.line._tabulate(n, pts[:, u:u + 1], order=order)
                for u in range(self.dim)]
        npts = pts.shape[0]
        out = {}
        for alpha in multiindices(self.dim, order):
            table = axes[0][alpha[:1]]
            for u in range(1, self.dim):
                table = (table[:, None, :] * axes[u][alpha[u:u + 1]][None, :, :]).reshape(-1, npts)
            out[alpha] = table
        return out


def _collocated_basis(element):
    """(expansion set, degree, coefficients) of an element that has no
    expansion basis of its own (``get_nodal_basis`` missing or refused):
    its value table on a unisolvent Gauss-Legendre lattice, solved against
    the orthonormal basis of its cell -- Dubiner on a simplex, the product
    of interval bases on a hypercube -- at its degree (one more where the
    space needs it), and accepted only where the expansion reproduces the
    element's host table at a second lattice to 1e-12 of max(1, max |table|);
    else ``NotImplementedError``."""
    ref_el = element.get_reference_element()
    sd = ref_el.get_spatial_dimension()
    shape = ref_el.get_shape()
    if shape in (cl.QUADRILATERAL, cl.HEXAHEDRON):
        es = _ProductExpansion(sd)
        lattices = lambda n: (es.lattice(n), es.lattice(n, extra=2))  # noqa: E731
    elif shape in (cl.LINE, cl.TRIANGLE, cl.TETRAHEDRON) and not ref_el.is_macrocell():
        es = ExpansionSet(ref_el)
        verts = ref_el.get_vertices()
        lattices = lambda n: (cl.make_lattice(verts, n, variant="gl"),  # noqa: E731
                              cl.make_lattice(verts, n + 2))
    else:
        raise NotImplementedError(
            f"FiatElement: no tensor tabulation of {type(element).__name__} on {type(ref_el).__name__}")
    zero = (0,) * sd
    rows = lambda pts: element.tabulate(0, pts)[zero].reshape(-1, len(pts))  # noqa: E731
    for n in (element.degree(), element.degree() + 1):
        fit, check = lattices(n)
        tgt = es._tabulate(n, fit)[zero]           # square: one point per member
        coeffs = np.linalg.solve(tgt.T, rows(fit).T).T
        host = rows(check)
        err = np.abs(coeffs @ es._tabulate(n, check)[zero] - host).max()
        if err <= 1e-12 * max(1.0, np.abs(host).max()):
            value_shape = element.tabulate(0, fit[:1])[zero].shape[1:-1]
            return es, n, coeffs.reshape((-1,) + value_shape + (coeffs.shape[-1],))
    raise NotImplementedError(
        f"FiatElement: no expansion of degree {element.degree()} or "
        f"{element.degree() + 1} reproduces {type(element).__name__}'s tables")


def _trace_tables(element, order, pts, entity):
    """The trace element at tensor points, as its host tabulation does it:
    on a named facet, that facet's block of the facet element's values;
    entity-free, every point binned to the facet it lies on (on the
    device, by its barycentric coordinates; NaN values when a point lies
    on none); gradients are ``TraceError``s."""
    ref_el = element.get_reference_element()
    sd = ref_el.get_spatial_dimension()
    npts = pts.shape[0]
    gradient = TraceError("Gradients on trace elements are not well-defined.")

    def tables(values):
        return {alpha: values if sum(alpha) == 0 else gradient
                for k in range(order + 1) for alpha in mis(sd, k)}

    values = pts.new_zeros((element.space_dimension(), npts))
    if entity is not None and entity != (sd, 0):
        facet_dim, _ = entity
        if facet_dim not in element.dg_elements:
            return element._error_table(
                order, "The HDivTrace element can only be tabulated on facets.")
        facet = FiatElement(element.dg_elements[facet_dim])
        values[element._block_slices[entity]] = facet._traced_tabulate(0, pts, None)[
            (0,) * facet_dim]
        return tables(values)
    if ref_el.get_shape() not in (cl.LINE, cl.TRIANGLE, cl.TETRAHEDRON):
        raise NotImplementedError("Entity-free tabulation is only supported on simplices")
    verts = np.asarray(ref_el.get_vertices(), dtype=np.float64)
    to_bary = np.linalg.inv((verts[:-1] - verts[-1]).T)
    lam = (pts - pts.new_tensor(verts[-1])) @ pts.new_tensor(to_bary.T)
    bary = torch.cat([lam, 1 - lam.sum(dim=1, keepdim=True)], dim=1)
    on_facet = bary.abs() < FACET_TOLERANCE
    if not bool((on_facet.sum(dim=1) == 1).all()):
        if entity is None:
            return tables(torch.full_like(values, float("nan")))
        return element._error_table(
            order, "The HDivTrace element can only be tabulated on facets.")
    facet_ids = on_facet.to(torch.int8).argmax(dim=1)
    if sd == 1:
        facet_ids = 1 - facet_ids   # interval: vertex i IS facet i
    facet = FiatElement(element.dg_elements[sd - 1])
    R = pts.new_tensor(np.asarray(cl.ufc_simplex(sd - 1).get_vertices(), dtype=np.float64))
    for f in range(sd + 1):
        keep = [i for i in range(sd + 1) if i != f]
        vals = facet._traced_tabulate(0, bary[:, keep] @ R, None)[(0,) * (sd - 1)]
        values[element._block_slices[(sd - 1, f)]] = vals * (facet_ids == f)
    return tables(values)

