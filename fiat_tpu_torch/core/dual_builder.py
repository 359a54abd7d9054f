"""Declarative dual-set construction.

Counterpart of ``fiat_tpu/core/dual_builder.py`` (the point-type part).
``DualBuilder`` owns the node list and the entity->dof map, so a family
dual is a short sequence of tagged additions:

    b = DualBuilder(ref_el)
    for dim in sorted(b.top):
        for e in b.entities(dim):
            b.point_evals(dim, e, degree)
    dual = b.dual_set()

The moment helpers, which need quadrature, are not ported yet.
"""

from . import functionals as fl
from .dualset import DualSet


class DualBuilder:
    def __init__(self, ref_el):
        self.ref_el = ref_el
        self.top = ref_el.get_topology()
        self.sd = ref_el.get_spatial_dimension()
        self._nodes = []
        self._ids = {dim: {e: [] for e in sorted(ents)}
                     for dim, ents in sorted(self.top.items())}

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

    def dual_set(self, permutations=None):
        return DualSet(self._nodes, self.ref_el, self._ids,
                       entity_permutations=permutations)

    def lattice(self, dim, entity, degree, **kw):
        """Interior lattice points of an entity."""
        return self.ref_el.make_points(dim, entity, degree, **kw)

    def point_evals(self, dim, entity, degree, **kw):
        """Point evaluations on the entity's interior lattice."""
        return self.tag(dim, entity,
                        (fl.PointEvaluation(self.ref_el, p)
                         for p in self.lattice(dim, entity, degree, **kw)))
