"""Declarative dual-set construction.

Counterpart of ``fiat_tpu/core/dual_builder.py``.  ``DualBuilder`` owns
the node list and the entity->dof map, so a family dual is a short
sequence of tagged additions:

    b = DualBuilder(ref_el)
    b.vertex_jets(order=2)
    for e in b.entities(1):
        b.tag(1, e, (PointNormalDerivative(ref_el, e, p)
                     for p in b.lattice(1, e, degree - 3)))
    dual = b.dual_set()

plus pattern helpers for the recurring moment constructions (facet
moments of an orthonormal basis, interior moments, derivative jets).
"""

import numpy as np

from . import functionals as fl
from . import polyset
from .dualset import DualSet
from .expansions import mis
from .quadrature import FacetQuadratureRule
from .variants import parse_quadrature_scheme


class DualBuilder:
    def __init__(self, ref_el):
        self.ref_el = ref_el
        self.top = ref_el.get_topology()
        self.sd = ref_el.get_spatial_dimension()
        self._nodes = []
        self._ids = {dim: {e: [] for e in sorted(ents)}
                     for dim, ents in sorted(self.top.items())}

    # -- core primitives ----------------------------------------------------
    def entities(self, dim):
        """Entity numbers of one dimension, in canonical order."""
        return sorted(self.top[dim])

    def tag(self, dim, entity, nodes):
        """Append functionals, crediting them to (dim, entity)."""
        nodes = list(nodes)
        lo = len(self._nodes)
        self._nodes += nodes
        self._ids[dim][entity] += range(lo, lo + len(nodes))
        return self

    def ids_of(self, dim, entity):
        """Dof ids tagged to one entity so far."""
        return list(self._ids[dim][entity])

    def also_tag(self, dim, entity, ids):
        """Credit ALREADY-tagged dof ids to another entity as well (a few
        fiat_tpu duals list overlapping entity ids)."""
        self._ids[dim][entity] += list(ids)
        return self

    def dual_set(self, cls=DualSet, permutations=None, **kw):
        return cls(self._nodes, self.ref_el, self._ids,
                   entity_permutations=permutations, **kw)

    # -- point-type helpers -------------------------------------------------
    def lattice(self, dim, entity, degree, **kw):
        """Interior lattice points of an entity."""
        return self.ref_el.make_points(dim, entity, degree, **kw)

    def point_evals(self, dim, entity, degree, **kw):
        """Point evaluations on the entity's interior lattice."""
        return self.tag(dim, entity,
                        (fl.PointEvaluation(self.ref_el, p)
                         for p in self.lattice(dim, entity, degree, **kw)))

    def vertex_jets(self, order):
        """Per-vertex derivative jets: value + all derivatives of orders
        1..order, in graded multi-index order."""
        verts = self.ref_el.get_vertices()
        alphas = [a for k in range(1, order + 1) for a in mis(self.sd, k)]
        for v in self.entities(0):
            self.tag(0, v, [fl.PointEvaluation(self.ref_el, verts[v])]
                     + [fl.PointDerivative(self.ref_el, verts[v], a)
                        for a in alphas])
        return self

    def midpoint_jet(self, first, last):
        """Derivative jet of orders first..last at the cell barycenter,
        tagged to the interior."""
        verts = np.asarray(self.ref_el.get_vertices())
        center = tuple(verts.mean(axis=0))
        return self.tag(self.sd, 0,
                        (fl.PointDerivative(self.ref_el, center, a)
                         for k in range(first, last + 1)
                         for a in mis(self.sd, k)))

    # -- moment-type helpers ------------------------------------------------
    def facet_basis(self, dim, degree, qdegree, scheme=None, scale=None,
                    variant=None, shape=()):
        """(Q_ref, phis): a quadrature on the reference entity of ``dim``
        exact to qdegree, and the orthonormal basis of P_degree tabulated
        at its points.  The building blocks of every moment helper."""
        facet = self.ref_el.construct_subelement(dim)
        Q_ref = parse_quadrature_scheme(facet, qdegree, scheme)
        kw = {} if scale is None else {"scale": scale}
        if variant is not None:
            kw["variant"] = variant
        P = polyset.ONPolynomialSet(facet, degree, shape, **kw)
        phis = P.tabulate(Q_ref.get_points())[(0,) * dim]
        return Q_ref, phis

    def map_rule(self, dim, entity, Q_ref, avg=True):
        """Push a reference-entity rule onto one entity of the cell."""
        return FacetQuadratureRule(self.ref_el, dim, entity, Q_ref, avg=avg)

    def moments(self, dim, degree, qdegree, scheme=None, scale=None,
                avg=True, variant=None, entity_filter=None):
        """IntegralMoments of the ON basis of P_degree over every entity
        of ``dim``."""
        Q_ref, phis = self.facet_basis(dim, degree, qdegree, scheme,
                                       scale, variant)
        for e in self.entities(dim):
            if entity_filter is not None and not entity_filter(e):
                continue
            Q = self.map_rule(dim, e, Q_ref, avg=avg)
            self.tag(dim, e, (fl.IntegralMoment(self.ref_el, Q, phi)
                              for phi in phis))
        return self

    def interior_moments(self, degree, qdegree, **kw):
        return self.moments(self.sd, degree, qdegree, **kw)
