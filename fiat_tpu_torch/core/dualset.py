"""Dual sets: the functionals of an element plus entity->DoF maps.

Counterpart of ``fiat_tpu/core/dualset.py`` on simplices and their split
complexes and on tensor-product cells.  ``to_riesz`` (the
generalized-Vandermonde assembly) delegates to the segment-sum program in
``functionals.riesz_representers``.  A dual set built on a split complex
collects its DoFs onto the parent cell's entities (``merge_entities``);
one given flat (integer-dimension) entity ids on a product cell re-keys
them onto its tuple dimensions (``unflatten_entity_ids``).
"""

import numpy as np

from . import functionals
from .cells import compute_unflattening_map, tuple_sum


class DualSet:
    def __init__(self, nodes, ref_el, entity_ids, entity_permutations=None):
        if ref_el.get_dimension() != max(entity_ids):
            entity_ids = unflatten_entity_ids(ref_el, entity_ids)
        nodes, ref_el, entity_ids, entity_permutations = merge_entities(
            nodes, ref_el, entity_ids, entity_permutations)
        self.nodes = nodes
        self.ref_el = ref_el
        self.entity_ids = entity_ids
        self.entity_permutations = entity_permutations
        self.entity_closure_ids = make_entity_closure_ids(ref_el, entity_ids)

    def __iter__(self):
        return iter(self.nodes)

    def __len__(self):
        return len(self.nodes)

    def get_nodes(self):
        return self.nodes

    def get_entity_closure_ids(self):
        return self.entity_closure_ids

    def get_entity_ids(self):
        return self.entity_ids

    def get_entity_permutations(self):
        """{dim: {entity: {orientation: dof permutation}}} mapping entity-
        local DoF order to canonical order per orientation."""
        if self.entity_permutations is None:
            raise NotImplementedError(
                f"entity_permutations not yet implemented for {type(self)}")
        return self.entity_permutations

    def get_reference_element(self):
        return self.ref_el

    def to_riesz(self, poly_set):
        """Action of every functional on every expansion member:
        array (num_nodes, *target_shape, num_exp)."""
        return functionals.riesz_representers(self.nodes, poly_set)

    def get_indices(self, restriction_domain, take_closure=True):
        """DoF indices supported on a restriction domain ('interior',
        'vertex', 'edge', 'face', 'facet', 'ridge')."""
        dofs = self.get_entity_ids()
        if restriction_domain == "interior":
            return [i for _, ids in sorted_by_key(dofs[max(dofs)]) for i in ids]
        csd = self.get_reference_element().get_spatial_dimension()
        named = {"vertex": 0, "edge": 1, "face": 2, "facet": csd - 1, "ridge": csd - 2}
        if restriction_domain not in named:
            raise RuntimeError("Invalid restriction domain")
        dim = named[restriction_domain]
        wanted = range(0 if take_closure else dim, dim + 1)
        return [i for edim in sorted(dofs, key=tuple_sum) if tuple_sum(edim) in wanted
                for _, ids in sorted_by_key(dofs[edim]) for i in ids]


def sorted_by_key(mapping):
    """Items sorted with heterogeneous keys grouped by type name (int
    entity numbers vs tuple tensor-product keys)."""
    return sorted(mapping.items(), key=lambda kv: (type(kv[0]).__name__, kv[0]))


def unflatten_entity_ids(ref_el, entity_ids):
    """Re-key flat (integer-dim) entity ids onto a tensor-product
    topology."""
    where = compute_unflattening_map(ref_el.get_topology())
    out = {dim: {} for dim in sorted(ref_el.get_topology())}
    for flat_key, ids_of in sorted(entity_ids.items()):
        for entity in sorted(ids_of):
            d, e = where[(flat_key, entity)]
            out[d][e] = ids_of[entity]
    return out


def make_entity_closure_ids(ref_el, entity_ids):
    """{dim: {entity: sorted dof ids of the entity's closure}}."""
    return {dim: {e: sorted(i for d, se in subs for i in entity_ids[d][se])
                  for e, subs in entities.items()}
            for dim, entities in ref_el.sub_entities.items()}


def lexsort_nodes(ref_el, nodes, offset=0):
    """Order PointEvaluation nodes lexicographically by barycentric
    coordinates: their indices, shifted by ``offset``."""
    if len(nodes) < 2:
        return list(range(offset, offset + len(nodes)))
    bary = ref_el.compute_barycentric_coordinates([tuple(node.points[0]) for node in nodes])
    return list(offset + np.lexsort(bary.T))


def merge_entities(nodes, ref_el, entity_ids, entity_permutations):
    """Collect the DoFs of a split complex onto the parent cell's entities.

    Pure point-evaluation duals are re-sorted lexicographically per parent
    entity (so the parent ordering is canonical); any other functional mix
    keeps the child ordering.  The merged dual lives on the parent."""
    parent = ref_el.get_parent()
    if parent is None:
        return nodes, ref_el, entity_ids, entity_permutations
    children_of = ref_el.get_parent_to_children()
    lagrange = all(isinstance(node, functionals.PointEvaluation) for node in nodes)

    parent_ids = {dim: {} for dim in sorted(children_of)}
    parent_nodes = [] if lagrange else nodes
    for dim in sorted(children_of):
        for entity in sorted(children_of[dim]):
            child_ids = [i for cd, ce in children_of[dim][entity] for i in entity_ids[cd][ce]]
            if lagrange:
                lo = len(parent_nodes)
                parent_nodes += [nodes[i] for i in child_ids]
                child_ids = lexsort_nodes(parent, parent_nodes[lo:], offset=lo)
            parent_ids[dim][entity] = child_ids
    return parent_nodes, parent, parent_ids, None
