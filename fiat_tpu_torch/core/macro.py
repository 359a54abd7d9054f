"""Macro elements: split simplicial complexes and polynomial spaces on
them.

Counterpart of ``fiat_tpu/core/macro.py``: the Alfeld / Worsey-Farin /
Powell-Sabin(6/12) / Iso(k) splits with child<->parent entity maps and
interior-facet lists, the composite quadrature rule, C^k-continuous
polynomial spaces as the null space of weighted derivative-jump
functionals on interior facets, the H(div)-conforming vector and
symmetric-tensor sets (vanishing normal jumps), the Piola pullbacks, and
``MacroPolynomialSet``, which tiles an element over every subcell of a
complex.  Host float64 numpy throughout, in fiat_tpu's order of
operations; tabulation of macro spaces on the device bins points to
subcells (``expansions.partition_of_unity_masks``).
"""

from itertools import chain, combinations

import numpy as np

from . import cells as cl
from . import expansions, polyset
from .quadrature import FacetQuadratureRule, QuadratureRule


def bary_to_xy(verts, bary, result=None):
    """Barycentric coordinates -> physical points."""
    return np.dot(bary, verts, out=result)


def xy_to_bary(verts, pts, result=None):
    """Physical points -> barycentric coordinates.

    One affine solve for all points: [V^T; 1] b = [x^T; 1]."""
    verts = np.asarray(verts, dtype=float)
    pts = np.asarray(pts, dtype=float)
    nv = verts.shape[0]
    lhs = np.vstack([verts.T, np.ones((1, nv))])
    rhs = np.vstack([pts.T, np.ones((1, pts.shape[0]))])
    out = np.linalg.solve(lhs, rhs).T
    if result is None:
        return out.copy()
    result[:, :] = out
    return result


def facet_support(facet_coords, tol=1e-12):
    """Parent vertex ids supporting a child facet (nonzero barycentric)."""
    mask = np.abs(np.asarray(facet_coords)).max(axis=0) > tol
    return tuple(np.flatnonzero(mask).tolist())


def invert_cell_topology(T):
    """{dim: {vertex tuple: entity id}}."""
    return {dim: {verts: e for e, verts in T[dim].items()} for dim in T}


def make_topology(sd, num_verts, edges):
    """Complete a topology from vertices + edges.

    Entities of dimension d+1 are found with one boolean matrix product
    per dimension: vertex v extends facet f iff v is adjacent to every
    vertex of f (and v < min(f), for uniqueness)."""
    edges = np.asarray(sorted(edges), dtype=int)
    adj = np.zeros((num_verts, num_verts), dtype=bool)
    adj[edges[:, 0], edges[:, 1]] = True
    adj[edges[:, 1], edges[:, 0]] = True

    topology = {0: {i: (i,) for i in range(num_verts)},
                1: dict(enumerate(map(tuple, edges)))}
    for dim in range(1, sd):
        facets = np.asarray(list(topology[dim].values()), dtype=int)
        extends = adj[facets].all(axis=1)            # (nfacets, num_verts)
        extends &= np.arange(num_verts)[None, :] < facets.min(axis=1)[:, None]
        fids, verts = np.nonzero(extends)
        new = sorted((v, *facets[f]) for f, v in zip(fids, verts))
        topology[dim + 1] = dict(enumerate(new))
    return topology


class SplitSimplicialComplex(cl.SimplicialComplex):
    """A split of a simplex, with child<->parent entity maps, per-cell
    reference-ordered connectivity, and interior-facet lists."""

    def __init__(self, parent, vertices, topology):
        self._parent_complex = parent
        root = parent
        while root.get_parent() is not None:
            root = root.get_parent()
        self._parent_simplex = root
        dim_cell = root.get_spatial_dimension()

        # one barycentric solve classifies every child vertex at once;
        # a child entity's parent is the entity spanned by the union of
        # its vertices' supports
        bary = xy_to_bary(root.get_vertices(), vertices)
        vert_support = np.abs(bary) > 1e-12            # (nverts, sd+1)
        parent_inv_top = invert_cell_topology(root.get_topology())

        child_to_parent = {}
        parent_to_children = {dim: {e: [] for e in parent_inv_top[dim].values()}
                              for dim in parent_inv_top}
        for dim in topology:
            ents = np.asarray([topology[dim][e] for e in sorted(topology[dim])])
            supports = vert_support[ents].any(axis=1)  # (nents, sd+1)
            pdims = supports.sum(axis=1) - 1
            child_to_parent[dim] = {}
            for entity, (pdim, sup) in enumerate(zip(pdims, supports)):
                pdim = int(pdim)
                pent = parent_inv_top[pdim][tuple(np.flatnonzero(sup).tolist())]
                child_to_parent[dim][entity] = (pdim, pent)
                parent_to_children[pdim][pent].append((dim, entity))

        # order children of each parent entity lexicographically by their
        # barycentre's coordinates on that entity
        verts_arr = np.asarray(vertices)
        for dim in parent_to_children:
            for entity, children in parent_to_children[dim].items():
                if len(children) > 1:
                    mids = np.stack([verts_arr[list(topology[cd][ce])].mean(axis=0)
                                     for cd, ce in children])
                    b = root.compute_barycentric_coordinates(
                        mids, entity=(dim, entity))
                    children = [children[j] for j in np.lexsort(b.T)]
                parent_to_children[dim][entity] = tuple(children)

        self._child_to_parent = child_to_parent
        self._parent_to_children = parent_to_children
        self._interior_facets = {
            dim: [e for e, (pd, _) in child_to_parent[dim].items()
                  if pd == dim_cell]
            for dim in sorted(child_to_parent)}

        super().__init__(root.shape, vertices, topology)

    def get_interior_facets(self, dimension):
        return self._interior_facets[dimension]

    def construct_subelement(self, dimension):
        return self.get_parent().construct_subelement(dimension)

    def is_macrocell(self):
        return True


def _attr_reader(attr):
    get = lambda self: getattr(self, attr)  # noqa: E731
    return get


for _name, _attr in (("get_child_to_parent", "_child_to_parent"),
                     ("get_parent_to_children", "_parent_to_children"),
                     ("get_parent", "_parent_simplex"),
                     ("get_parent_complex", "_parent_complex")):
    setattr(SplitSimplicialComplex, _name, _attr_reader(_attr))


class IsoSplit(SplitSimplicialComplex):
    """Uniform split along a regular degree-k lattice (P2:P1 iso etc.)."""

    def __init__(self, ref_el, degree=2, variant=None):
        self.degree = degree
        self.variant = variant
        sd = ref_el.get_spatial_dimension()
        new_verts = cl.make_lattice(ref_el.vertices, degree, variant=variant)

        # edges of the refined lattice: every unit-box diagonal chain
        flat_index = {alpha: i for i, alpha in
                      enumerate(cl.lattice_iter(0, degree + 1, sd))}
        edges = set()
        corners = list(cl.lattice_iter(0, 2, sd))
        for alpha in cl.lattice_iter(0, degree, sd):
            box = [flat_index[tuple(a + b for a, b in zip(alpha, beta))]
                   for beta in corners]
            edges.update((min(u, v), max(u, v))
                         for i, u in enumerate(box) for v in box[i + 1:])
        if sd == 3:
            # cut the central octahedron along one diagonal
            if degree != 2:
                raise NotImplementedError("3D IsoSplit needs degree 2")
            diag = sorted((flat_index[(1, 0, 0)], flat_index[(0, 1, 1)]))
            edges.add(tuple(diag))
        topology = make_topology(sd, len(new_verts), edges)
        super().__init__(ref_el, tuple(new_verts), topology)

    def construct_subcomplex(self, dimension):
        if dimension == self.get_dimension():
            return self
        sub = self.construct_subelement(dimension)
        return sub if dimension == 0 else IsoSplit(sub, self.degree, self.variant)


class PowellSabinSplit(SplitSimplicialComplex):
    """Connect barycentres of entities of dimension >= ``dimension`` to all
    subsimplices beneath them."""

    def __init__(self, ref_el, dimension=1):
        self.split_dimension = dimension
        cell_dim = ref_el.get_spatial_dimension()
        topo = ref_el.get_topology()
        conn = ref_el.get_connectivity()
        verts_out = list(ref_el.get_vertices())

        # grow simplices dimension by dimension: each entity's barycentre
        # cones over the simplices of its codim-1 children
        cones = {dimension - 1: {e: [v] for e, v in topo[dimension - 1].items()}}
        for d in range(dimension, cell_dim + 1):
            level = {}
            for entity in topo[d]:
                apex = len(verts_out)
                verts_out.extend(ref_el.make_points(d, entity, d + 1))
                level[entity] = [(*simp, apex)
                                 for child in conn[(d, d - 1)][entity]
                                 for simp in cones[d - 1][child]]
            cones[d] = level

        cells = list(chain.from_iterable(cones[cell_dim].values()))
        topology = {0: {i: (i,) for i in range(len(verts_out))},
                    cell_dim: dict(enumerate(cells))}
        for d in range(1, cell_dim):
            faces = chain.from_iterable(combinations(simp, d + 1)
                                        for simp in cells)
            if d < self.split_dimension:
                faces = chain(topo[d].values(), faces)
            topology[d] = dict(enumerate(dict.fromkeys(faces)))

        parent = (ref_el if dimension == cell_dim
                  else PowellSabinSplit(ref_el, dimension=dimension + 1))
        super().__init__(parent, tuple(verts_out), topology)

    def construct_subcomplex(self, dimension):
        if dimension == self.get_dimension():
            return self
        sub = self.get_parent_complex().construct_subcomplex(dimension)
        return sub if dimension < self.split_dimension else \
            PowellSabinSplit(sub, dimension=self.split_dimension)


class _CachedSplit(PowellSabinSplit):
    """Split variants cached on the cell being split."""

    def __new__(cls, ref_el):
        try:
            return ref_el._split_cache[cls]
        except KeyError:
            self = super().__new__(cls)
            return ref_el._split_cache.setdefault(cls, self)


class AlfeldSplit(_CachedSplit):
    """Barycentric (Alfeld/Clough-Tocher) split."""

    def __init__(self, ref_el):
        super().__init__(ref_el, dimension=ref_el.get_spatial_dimension())


class WorseyFarinSplit(_CachedSplit):
    """Barycentres of cells AND facets (PS on triangles, Alfeld on lines)."""

    def __init__(self, ref_el):
        super().__init__(ref_el, dimension=ref_el.get_spatial_dimension() - 1)


class PowellSabin12Split(SplitSimplicialComplex):
    """The 12-triangle Powell-Sabin split of a triangle."""

    _BARY = np.array(
        [[1/3, 1/3, 1/3],
         [1/2, 1/2, 0], [1/2, 0, 1/2], [0, 1/2, 1/2],
         [1/2, 1/4, 1/4], [1/4, 1/2, 1/4], [1/4, 1/4, 1/2]])
    _EDGES = [(0, 4), (0, 7), (0, 5),
              (1, 4), (1, 8), (1, 6),
              (2, 5), (2, 9), (2, 6),
              (3, 4), (3, 5), (3, 6), (3, 7), (3, 8), (3, 9),
              (4, 7), (4, 8), (5, 7), (5, 9), (6, 8), (6, 9)]

    def __init__(self, ref_el):
        if ref_el.get_shape() != cl.TRIANGLE:
            raise ValueError("PowellSabin12Split is triangle-only")
        verts = ref_el.get_vertices()
        new_verts = np.vstack([verts, bary_to_xy(verts, self._BARY)])
        parent = PowellSabinSplit(ref_el)
        super().__init__(parent, tuple(map(tuple, new_verts)),
                         make_topology(2, len(new_verts), self._EDGES))

    def construct_subcomplex(self, dimension):
        if dimension not in (0, 1, 2):
            raise ValueError("Illegal dimension")
        if dimension == 2:
            return self
        sub = self.construct_subelement(dimension)
        return AlfeldSplit(sub) if dimension == 1 else sub


def merge_coincident(pts, wts, atol=1e-10):
    """Deduplicate near-coincident rows of pts, accumulating weights:
    lexsort, chain-merge consecutive rows within atol, segment-sum."""
    pts = np.asarray(pts)
    wts = np.asarray(wts)
    order = np.lexsort(pts.T)
    p = pts[order]
    new_group = np.r_[True, ~np.all(np.abs(np.diff(p, axis=0)) <= atol, axis=1)]
    starts = np.flatnonzero(new_group)
    return p[starts], np.add.reduceat(wts[order], starts)


class MacroQuadratureRule(QuadratureRule):
    """Composite rule: a reference rule mapped to every subcell of the
    complex, with the points shared by several subcells merged."""

    def __init__(self, ref_el, Q_ref):
        qdim = Q_ref.ref_el.get_spatial_dimension()
        child_rules = [FacetQuadratureRule(ref_el, qdim, e, Q_ref)
                       for e in ref_el.get_topology()[qdim]]
        pts = np.concatenate([Q.pts for Q in child_rules])
        wts = np.concatenate([Q.wts for Q in child_rules])

        # points shared by several children (on interior facets) coincide
        # physically: merge them globally
        pts, wts = merge_coincident(pts, wts)
        super().__init__(ref_el, pts, wts)


class CkPolynomialSet(polyset.PolynomialSet):
    """C^k-continuous polynomials on a complex, as the null space (SVD) of
    weighted derivative-jump functionals on interior facets (plus optional
    vertex super-smoothness)."""

    def __init__(self, ref_el, degree, order=1, vorder=None, shape=(), **kwargs):
        from .quadrature_schemes import create_quadrature
        if not isinstance(order, (int, dict)):
            raise TypeError("'order' must be an int or a dict")
        dim = ref_el.get_spatial_dimension()
        fdim = dim - 1
        if isinstance(order, int):
            order = {fdim: dict.fromkeys(ref_el.get_interior_facets(fdim),
                                         order)}
        if vorder is not None:
            order[0] = dict.fromkeys(ref_el.get_interior_facets(0), vorder)
        order.setdefault(0, {})
        if set(order) - {0, fdim}:
            raise NotImplementedError(
                "Only facet or vertex constraints supported")

        es = expansions.ExpansionSet(ref_el, **kwargs)
        k = 1 if es.continuity == "C0" else 0

        facet_cell = ref_el.construct_subelement(fdim)
        mdeg = 0 if dim == 1 else degree - k
        moments = polyset.ONPolynomialSet(facet_cell, mdeg)
        rule = create_quadrature(facet_cell, 2 * mdeg)
        qp = rule.get_points()
        wtab = moments.tabulate(qp)[(0,) * fdim] * rule.get_weights()

        # facet continuity: weighted normal-derivative jumps must vanish
        rows = []
        for facet, forder in order[fdim].items():
            jumps = es.tabulate_normal_jumps(degree, qp, facet, order=forder)
            for r in range(k, forder + 1):
                nw = (1 if dim == 1 else
                      expansions.polynomial_dimension(facet_cell, degree - r))
                rows.append(np.tensordot(wtab[:nw], jumps[r], axes=(-1, -1)))

        # vertex super-smoothness beyond what facet continuity implies
        verts = np.asarray(ref_el.get_vertices())
        for vo in set(order[0].values()):
            vids = [i for i in order[0] if order[0][i] == vo]
            touching = chain.from_iterable(ref_el.connectivity[(0, fdim)][v]
                                           for v in vids)
            implied = min(order[fdim][f] for f in touching) + fdim
            if vo > implied:
                jumps = es.tabulate_jumps(degree, verts[vids], order=vo)
                rows.extend(np.vstack(jumps[r].T)
                            for r in range(implied + 1, vo + 1))

        if rows:
            rows = [row / max(np.max(abs(row)), 1) for row in rows]
            coeffs = polyset.spanning_basis(np.vstack(rows), nullspace=True)
        else:
            coeffs = np.eye(es.get_num_members(degree))

        if shape != ():
            m, n = coeffs.shape
            ncomp = int(np.prod(shape))
            coeffs = np.kron(coeffs, np.eye(ncomp)).reshape(m * ncomp,
                                                            *shape, n)
        super().__init__(ref_el, degree, degree, es, coeffs)


def hdiv_conforming_coefficients(U, order=0):
    """Constrain a (vector/tensor) PolynomialSet to vanishing normal jumps
    on interior facets (null-space SVD)."""
    from .quadrature_schemes import create_quadrature
    degree = U.degree
    cell = U.get_reference_element()
    coeffs = U.get_coeffs()
    shape = U.get_shape()
    es = U.get_expansion_set()
    k = 1 if es.continuity == "C0" else 0

    fdim = cell.get_spatial_dimension() - 1
    facet_cell = cell.construct_subelement(fdim)
    mdeg = 0 if fdim == 0 else degree - k
    moments = polyset.ONPolynomialSet(facet_cell, mdeg, shape=shape[1:])
    rule = create_quadrature(facet_cell, 2 * mdeg)
    qp = rule.get_points()
    wtab = moments.tabulate(qp)[(0,) * fdim] * rule.get_weights()
    ax = tuple(range(1, wtab.ndim))

    rows = []
    for facet in cell.get_interior_facets(fdim):
        normal = cell.compute_scaled_normal(facet)
        ncoeffs = np.tensordot(coeffs, normal, axes=(len(shape), 0))
        jumps = es.tabulate_normal_jumps(degree, qp, facet, order=order)
        for r in range(k, order + 1):
            rows.append(np.tensordot(wtab, np.dot(ncoeffs, jumps[r]),
                                     axes=(ax, ax)))

    if rows:
        nsp = polyset.spanning_basis(np.vstack(rows), nullspace=True)
        coeffs = np.tensordot(nsp, coeffs, axes=(1, 0))
    return coeffs


class HDivPolynomialSet(polyset.PolynomialSet):
    """Vector polynomials with continuous normal components on a complex."""

    def __init__(self, ref_el, degree, order=0, **kwargs):
        U = polyset.ONPolynomialSet(
            ref_el, degree, shape=(ref_el.get_spatial_dimension(),),
            **kwargs)
        super().__init__(ref_el, degree, degree, U.expansion_set,
                         hdiv_conforming_coefficients(U, order=order))


class HDivSymPolynomialSet(polyset.PolynomialSet):
    """Symmetric-tensor polynomials with continuous normal components."""

    def __init__(self, ref_el, degree, order=0, **kwargs):
        U = polyset.ONSymTensorPolynomialSet(ref_el, degree, **kwargs)
        super().__init__(ref_el, degree, degree, U.expansion_set,
                         hdiv_conforming_coefficients(U, order=order))


_FORM_DEGREES = {
    "affine": (0,),
    "covariant piola": (1,),
    "contravariant piola": (2,),
    "double covariant piola": (1, 1),
    "double contravariant piola": (2, 2),
    "covariant contravariant piola": (1, 2),
    "contravariant covariant piola": (2, 1)}


def pullback(phi, mapping, J=None, Jinv=None, Jdet=None):
    """Push reference tabulations to physical space by the named Piola
    pullback.  ``phi`` may carry leading batch axes: the value axes are the
    len(formdegree) axes after the first, and each is hit with one
    tensordot against J^-T (1-forms) or J/detJ (2-forms)."""
    if mapping not in _FORM_DEGREES:
        raise ValueError(f"Unrecognized mapping {mapping}")
    formdegree = _FORM_DEGREES[mapping]
    if J is None:
        J = np.linalg.pinv(Jinv)
    if Jinv is None:
        Jinv = np.linalg.pinv(J)
    if Jdet is None:
        Jdet = np.linalg.det(J)
    factor = {0: None, 1: Jinv.T, 2: J / Jdet}
    for axis, k in enumerate(formdegree, start=1):
        if k:
            phi = np.moveaxis(np.tensordot(phi, factor[k], axes=(axis, 1)), -1, axis)
    return phi


class MacroPolynomialSet(polyset.PolynomialSet):
    """Tile a CiarletElement over every subcell of a complex (with the
    appropriate Piola pullback per subcell)."""

    def __init__(self, ref_el, element):
        topo = ref_el.get_topology()
        dim = ref_el.get_spatial_dimension()
        mapping, = set(element.mapping())
        base_cell = element.get_reference_element()
        base_ids = element.entity_dofs()
        n = element.degree()

        es = element.get_nodal_basis().get_expansion_set().reconstruct(ref_el=ref_el)

        shp = element.value_shape()
        nbf = expansions.polynomial_dimension(ref_el, n, base_ids)
        coeffs = np.zeros((nbf, *shp, es.get_num_members(n)))
        base_coeffs = element.get_coeffs()

        rmap = expansions.polynomial_cell_node_map(ref_el, n, base_ids)
        cmap = es.get_cell_node_map(n)
        cells = sorted(topo[dim])
        # all subcell affine maps in one stacked build, pullbacks per cell
        As = np.stack([cl.make_affine_mapping(
            base_cell.vertices, ref_el.get_vertices_of_subcomplex(topo[dim][c]))[0]
            for c in cells])
        for c, A in zip(cells, As):
            block = np.ix_(rmap[c], *map(range, shp), cmap[c])
            coeffs[block] = pullback(base_coeffs, mapping, J=A)
        super().__init__(ref_el, n, n, es, coeffs)
