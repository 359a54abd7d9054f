"""Tensor-product elements.

Counterpart of ``fiat_tpu/elements/tensor_product.py``: the product cell,
product DoFs (B fastest), the product dual by functional type, and
tabulation as outer products of the factor tabulations, one einsum per
derivative multi-index.  ``FlattenedDimensions`` presents a product of
interval elements on the flat quadrilateral or hexahedron."""

from itertools import product

import numpy as np

from ..core import functionals
from ..core.cells import (TensorProductCell, UFCHexahedron, UFCQuadrilateral,
                          compute_unflattening_map, flatten_entities)
from ..core.dualset import DualSet
from ..core.expansions import mis
from ..core.finite_element import FiniteElement


def _first_point(node):
    return tuple(node.points[0])


def _extrude_node(Anode, Bnode, ref_el, name, pad_component):
    """Lift a vector functional A onto the product cell: every A point is
    extended by B's (single) point, and term components are optionally
    padded with a zero-weight slot in the new (last) direction so the dual
    keeps the full product-cell component stencil."""
    Bpoint = _first_point(Bnode)
    if len(Bpoint) > 1:
        raise NotImplementedError(
            f"{name} x PointEval needs a 1D second factor")
    sd = ref_el.get_spatial_dimension()
    points = np.hstack([Anode.points,
                        np.tile(Bpoint, (Anode.points.shape[0], 1))])
    npad = points.shape[0] if pad_component else 0
    return functionals.Functional(
        ref_el, (sd,), name, points,
        pt_ids=np.concatenate([Anode.pt_ids, np.arange(npad)]),
        weights=np.concatenate([Anode.weights, np.zeros(npad)]),
        comps=np.concatenate([Anode.comps, np.full(npad, sd - 1, np.intp)]))


#: vector functional kinds liftable against a point evaluation:
#: type -> (lifted name, pad a zero-weight component slot)
_LIFTABLE = (
    (functionals.PointScaledNormalEvaluation, "PointScaledNormalEval", True),
    (functionals.PointEdgeTangentEvaluation, "PointEdgeTangent", True),
    (functionals.FrobeniusIntegralMoment, "FrobeniusIntegralMoment", True),
    (functionals.IntegralMoment, "IntegralMoment", False),
)


def _product_node(Anode, Bnode, ref_el):
    """The product functional of two factor functionals, where defined;
    a placeholder 'Undefined' functional otherwise."""
    B_is_point = isinstance(Bnode, functionals.PointEvaluation)
    if isinstance(Anode, functionals.PointEvaluation):
        if B_is_point:
            return functionals.PointEvaluation(
                ref_el, _first_point(Anode) + _first_point(Bnode))
    elif isinstance(Anode, functionals.ComponentPointEvaluation):
        if not B_is_point:
            raise NotImplementedError("unsupported functional type")
        return functionals.ComponentPointEvaluation(
            ref_el, Anode.comp, (ref_el.get_spatial_dimension(),),
            _first_point(Anode) + _first_point(Bnode))
    else:
        for kind, name, pad in _LIFTABLE:
            if isinstance(Anode, kind):
                if not B_is_point:
                    raise NotImplementedError("unsupported functional type")
                return _extrude_node(Anode, Bnode, ref_el, name, pad)
        if not isinstance(Anode, functionals.Functional):
            raise NotImplementedError("unsupported functional type")
    return functionals.Functional(None, (), "Undefined", np.zeros((1, 0)))


def _outer_tables(Atab, Btab, widths, order, npts):
    """Per-multi-index outer products of two factor tabulations, with
    the A/B member axes merged (B fastest) and at most one value axis."""
    result = {}
    for total in range(order + 1):
        for alpha in mis(sum(widths), total):
            a = Atab[alpha[:widths[0]]]
            b = Btab[alpha[widths[0]:]]
            spec = ("a" + "d" * (a.ndim - 2) + "p,"
                    "b" + "e" * (b.ndim - 2) + "p->"
                    "ab" + "d" * (a.ndim - 2) + "e" * (b.ndim - 2) + "p")
            merged = np.einsum(spec, a, b)
            result[alpha] = merged.reshape(-1, *merged.shape[2:])
    return result


class TensorProductElement(FiniteElement):
    """The tensor product of two elements on the product cell."""

    def __init__(self, A, B):
        nonaffine = [m for m in (A.mapping()[0], B.mapping()[0])
                     if m != "affine"]
        if len(nonaffine) > 1:
            raise ValueError("at least one factor must have an affine mapping")
        degrees = (A.get_formdegree(), B.get_formdegree())

        ref_el = TensorProductCell(A.get_reference_element(),
                                   B.get_reference_element())
        nodes = [_product_node(An, Bn, ref_el)
                 for An in A.dual_basis() for Bn in B.dual_basis()]
        dual = DualSet(nodes, ref_el,
                       _product_entity_ids(A.entity_dofs(), B.entity_dofs(),
                                           B.space_dimension()))
        super().__init__(ref_el, dual,
                         min(A.get_order(), B.get_order()),
                         None if None in degrees else sum(degrees),
                         nonaffine[0] if nonaffine else "affine")
        self.A = A
        self.B = B
        self.polydegree = max(A.degree(), B.degree())

    def degree(self):
        return self.polydegree

    def tabulate(self, order, points, entity=None):
        """Tabulate as an outer product of the factor tabulations: one
        einsum per derivative multi-index."""
        if entity is None:
            entity = (self.ref_el.get_dimension(), 0)
        dims, flat_id = entity
        counts = [len(c.get_topology()[d])
                  for c, d in zip(self.ref_el.cells, dims)]
        idA, idB = np.unravel_index(flat_id, tuple(counts))

        pdims = [c.get_spatial_dimension()
                 for c in self.ref_el.construct_subelement(dims).cells]
        points = np.asarray(points)
        Atab = self.A.tabulate(order, points[..., :pdims[0]],
                               (dims[0], idA))
        Btab = self.B.tabulate(order, points[..., pdims[0]:sum(pdims)],
                               (dims[1], idB))

        if len(self.A.value_shape()) + len(self.B.value_shape()) > 1:
            raise NotImplementedError(
                "tabulate does not support two vector-valued factors")
        widths = [c.get_spatial_dimension() for c in self.ref_el.cells]
        return _outer_tables(Atab, Btab, widths, order, len(points))

    def value_shape(self):
        shape = self.A.value_shape() + self.B.value_shape()
        if len(shape) > 1:
            raise NotImplementedError("value_shape not implemented")
        return shape

    def is_nodal(self):
        return self.A.is_nodal() and self.B.is_nodal()


def _product_entity_ids(Adofs, Bdofs, Bsdim):
    """Product entity→dof tables: flat product entities in B-fastest
    order, dof blocks as one broadcast add per entity pair."""
    entity_ids = {}
    for dimA, dimB in product(Adofs, Bdofs):
        pairs = product(Adofs[dimA].values(), Bdofs[dimB].values())
        entity_ids[(dimA, dimB)] = {
            flat: (np.multiply.outer(np.asarray(a, dtype=int), Bsdim)
                   [:, None] + np.asarray(b, dtype=int)).ravel().tolist()
            for flat, (a, b) in enumerate(pairs)}
    return entity_ids


def _unimplemented(name):
    def stub(self, *args):
        raise NotImplementedError(f"{name} not implemented")
    stub.__name__ = name
    return stub


def _via_element(name):
    def fwd(self, *args):
        return getattr(self.element, name)(*args)
    fwd.__name__ = name
    return fwd


for _n in ("get_nodal_basis", "get_coeffs", "dmats", "get_num_members"):
    setattr(TensorProductElement, _n, _unimplemented(_n))


class FlattenedDimensions(FiniteElement):
    """Present a tensor-product-of-intervals element with flattened
    (quadrilateral/hexahedron) entity dimensions."""

    _FLAT_CELLS = {2: UFCQuadrilateral, 3: UFCHexahedron}

    def __init__(self, element):
        dim = element.ref_el.get_spatial_dimension()
        try:
            ref_el = self._FLAT_CELLS[dim]()
        except KeyError:
            raise ValueError(f"Illegal element dimension {dim}")
        dual = DualSet(element.dual.nodes, ref_el,
                       flatten_entities(element.dual.entity_ids))
        super().__init__(ref_el, dual, element.get_order(),
                         element.get_formdegree(), element._mapping)
        self.element = element
        self.unflattening_map = compute_unflattening_map(
            element.ref_el.get_topology())

    def degree(self):
        return self.element.degree()

    def tabulate(self, order, points, entity=None):
        if entity is None:
            entity = (self.ref_el.get_spatial_dimension(), 0)
        return self.element.tabulate(order, points,
                                     self.unflattening_map[entity])


for _n in ("value_shape", "get_nodal_basis", "get_coeffs", "dmats",
           "get_num_members", "is_nodal"):
    setattr(FlattenedDimensions, _n, _via_element(_n))
