"""Dual sets: the functionals of an element plus entity->DoF maps.

Counterpart of ``fiat_tpu/core/dualset.py`` on single cells.  ``to_riesz``
(the generalized-Vandermonde assembly) delegates to the segment-sum
program in ``functionals.riesz_representers``.
"""

from . import functionals


class DualSet:
    def __init__(self, nodes, ref_el, entity_ids, entity_permutations=None):
        if ref_el.get_parent() is not None:
            raise NotImplementedError("Dual sets on split complexes are not ported yet")
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


def make_entity_closure_ids(ref_el, entity_ids):
    """{dim: {entity: sorted dof ids of the entity's closure}}."""
    return {dim: {e: sorted(i for d, se in subs for i in entity_ids[d][se])
                  for e, subs in entities.items()}
            for dim, entities in ref_el.sub_entities.items()}
