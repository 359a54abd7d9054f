"""Extended Bernardi-Raugel element: (P_order + exterior-facet bubbles)^d
with lattice component evaluations, one normal facet moment and (unless
``reduced``) the d-1 tangential bubble constraints.  Counterpart of
``fiat_tpu/elements/bernardi_raugel.py``: a mask-selected vector subspace
plus a declarative dual builder program.
"""

import math

import numpy as np

from ..core import expansions, finite_element, polyset
from ..core.dual_builder import DualBuilder
from ..core.functionals import (ComponentPointEvaluation,
                                FrobeniusIntegralMoment)
from ..core.variants import parse_quadrature_scheme
from .hierarchical import make_dual_bubbles


def BernardiRaugelSpace(ref_el, order):
    """(P_order + FacetBubble)^d as a masked slice of the C0 bubble
    expansion: per scalar member, keep the first comb(order-1, dim)
    members of every low-dimensional entity plus every exterior-facet
    bubble, then replicate the mask over the d vector components."""
    sd = ref_el.get_spatial_dimension()
    if order > sd:
        raise ValueError("The Bernardi-Raugel space needs order <= dim")
    Pd = polyset.ONPolynomialSet(ref_el, sd, shape=(sd,), scale=1,
                                 variant="bubble")
    layout = expansions.polynomial_entity_ids(ref_el, sd, continuity="C0")
    nscalar = expansions.polynomial_dimension(ref_el, sd, continuity="C0")

    lattice = np.zeros(nscalar, dtype=bool)   # P_order block
    bubbles = np.zeros(nscalar, dtype=bool)   # exterior facet bubbles
    interior = set(ref_el.get_interior_facets(sd - 1) or ())
    for dim, ents in layout.items():
        if dim == sd - 1:
            for f, ids in ents.items():
                if f not in interior:
                    bubbles[ids] = True
        elif dim < order:
            head = math.comb(order - 1, dim)
            for ids in ents.values():
                lattice[list(ids)[:head]] = True
    # bubbles LAST and components interleaved per scalar member: the
    # Guzman-Neilan projection peels the trailing bubble block
    scalars = np.concatenate([np.flatnonzero(lattice),
                              np.flatnonzero(bubbles)])
    take = scalars[:, None] + nscalar * np.arange(sd)[None, :]
    return Pd.take(take.ravel().tolist())


def _tangential_weight(facet, degree):
    """(Q_ref, w): the top dual bubble on the reference facet as the
    tangential-constraint weight.  On macro facets at degree 1 the
    bubble lives on the split and is rescaled to unit mean then shifted
    to zero mean (a pure constraint); otherwise it is scaled by
    +-area/2 with the parity sign of the facet dimension."""
    area = facet.volume()
    dim = facet.get_spatial_dimension()
    split_bubble = degree == 1 and facet.is_macrocell()
    Q, phis = make_dual_bubbles(facet, degree,
                                codim=dim if split_bubble else 0, scale=1)
    w = phis[-1]
    if split_bubble:
        qw = Q.get_weights()
        w = w * (area / np.dot(w, qw))
        w = w - np.dot(w, qw) / area
    else:
        w = w * ((-1) ** dim * 0.5 * area)
    return Q, w


def _facet_frame(ref_el, f):
    """Moment directions for one facet: outward-ish normal first, then
    the tangential constraint directions (t in 2D, n x t_j in 3D)."""
    sd = ref_el.get_spatial_dimension()
    t = ref_el.compute_tangents(sd - 1, f)
    if sd == 2:
        n = np.array([t[0][1], -t[0][0]])
        return [n, t[0]]
    n = np.cross(*t)
    return [n] + [np.cross(n, tj) for tj in t]


def BernardiRaugelDualSet(ref_el, order=1, degree=None, reduced=False,
                          ref_complex=None, hierarchical=False,
                          quad_scheme=None):
    """Lattice component evaluations + facet normal/tangential moments
    (also the dual grammar of Arnold-Qin / Christiansen-Hu /
    Guzman-Neilan, which call in with their own spaces)."""
    sd = ref_el.get_spatial_dimension()
    if degree is None:
        degree = sd
    if order > sd:
        raise ValueError("BernardiRaugelDualSet needs order <= dim")

    b = DualBuilder(ref_el)
    if order > 0:
        for dim in sorted(ref_el.get_topology()):
            for e in b.entities(dim):
                b.tag(dim, e, (ComponentPointEvaluation(ref_el, c, (sd,), pt)
                               for pt in b.lattice(dim, e, order)
                               for c in range(sd)))

    if order < sd:
        facet = (ref_complex or ref_el).construct_subcomplex(sd - 1)
        Qt, wt = _tangential_weight(facet, degree)
        if hierarchical:
            Qn, wn = Qt, wt
        else:
            Qn = parse_quadrature_scheme(facet, degree,
                                         quad_scheme=quad_scheme)
            wn = np.full(len(Qn.get_weights()), 1 / facet.volume())

        interior = set(ref_el.get_interior_facets(sd - 1) or ())
        exterior = [f for f in b.entities(sd - 1) if f not in interior]
        frames = {f: _facet_frame(ref_el, f) for f in exterior}
        rules = {f: (b.map_rule(sd - 1, f, Qn), b.map_rule(sd - 1, f, Qt))
                 for f in exterior}
        # direction-major emission (normals for every facet, then each
        # tangential constraint) fixes the dof order of the family
        for i in range(1 if reduced else sd):
            Qs, w = (0, wn) if i == 0 else (1, wt)
            for f in exterior:
                b.tag(sd - 1, f, [FrobeniusIntegralMoment(
                    ref_el, rules[f][Qs], np.outer(frames[f][i], w))])
    return b.dual_set()


class BernardiRaugel(finite_element.CiarletElement):
    """The extended Bernardi-Raugel element (inf-sup stable with DG_{k-1})."""

    def __init__(self, ref_el, order=1, hierarchical=False, quad_scheme=None):
        degree = ref_el.get_spatial_dimension()
        if order >= degree:
            raise ValueError("BernardiRaugel only defined for order < dim")
        poly_set = BernardiRaugelSpace(ref_el, order)
        dual = BernardiRaugelDualSet(ref_el, order, degree=degree,
                                     hierarchical=hierarchical,
                                     quad_scheme=quad_scheme)
        super().__init__(poly_set, dual, degree, 0,
                         mapping="contravariant piola")
