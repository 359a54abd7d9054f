"""Reference simplices and simplicial complexes: geometry and topology,
host-side and static.

Counterpart of the simplex part of ``fiat_tpu/core/cells.py`` (UFC
conventions): ``Cell`` (topology, sub/super entities, connectivity,
parents), ``SimplicialComplex`` (normals, tangents, barycentric maps,
L1 distances, subentity transforms, orientation maps) and the reference
simplices (UFC, default, symmetric and Intrepid numberings);
``TensorProductCell`` (products of cells, tuple entity dimensions) and
the hypercubes presented with flat dimensions (``Hypercube``,
``UFCQuadrilateral``, ``UFCHexahedron``) with the flattening maps between
the two numberings.  Split complexes subclass
``SimplicialComplex`` in ``core/macro.py``.  A cell is ``<=`` another when
it lies on the other's parent-complex chain (a split complex is ``>`` its
parent); products compare factor by factor.  Cells are plain Python
objects whose data parameterise the tabulation kernels; everything here is
float64 numpy.
"""

import math
import operator
from collections import defaultdict
from functools import reduce
from itertools import chain, count, product

import numpy as np
import torch

from . import orientation as ornt
from .recursive_nodes import recursive_node

POINT = "point"
LINE = "line"
TRIANGLE = "triangle"
TETRAHEDRON = "tetrahedron"
QUADRILATERAL = "quadrilateral"
HEXAHEDRON = "hexahedron"
TENSORPRODUCT = "tensorproduct"

HYPERCUBE_SHAPES = {0: POINT, 1: LINE, 2: QUADRILATERAL, 3: HEXAHEDRON}


# Lattice utilities --------------------------------------------------------

def multiindex_equal(d, total, imin=0):
    """All d-tuples of integers >= imin summing to ``total``, last
    component growing slowest."""
    if d <= 0:
        return
    imax = total - (d - 1) * imin
    if imax < imin:
        return
    for i in range(imin, imax):
        for rest in multiindex_equal(d - 1, total - i, imin=imin):
            yield rest + (i,)
    yield (imin,) * (d - 1) + (imax,)


def lattice_iter(start, finish, depth):
    """The depth-dimensional simplex lattice of integers in [start,
    finish)."""
    if depth == 0:
        yield ()
        return
    for i in range(start, finish):
        for rest in lattice_iter(start, finish - i, depth - 1):
            yield rest + (i,)


_LATTICE_FAMILIES = {"equispaced": "equi",
                     "equispaced_interior": "equi_interior",
                     "gll": "lgl"}


def make_lattice(verts, n, interior=0, variant=None):
    """Points of the degree-n lattice on the simplex spanned by ``verts``,
    omitting ``interior`` layers from the boundary."""
    family = _LATTICE_FAMILIES.get(variant or "equispaced", variant or "equispaced")
    X = np.asarray(verts, dtype=np.float64)
    d = len(verts) - 1
    return [tuple(recursive_node(d, n, alpha, family) @ X)
            for alpha in multiindex_equal(d + 1, n, interior)]


# Affine maps --------------------------------------------------------------

def make_affine_mapping(xs, ys):
    """(A, b) with A @ x + b mapping simplex vertices xs onto ys."""
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    if xs.shape[0] != ys.shape[0]:
        raise ValueError("Vertex count mismatch in affine mapping")
    npts, dim_x = xs.shape
    X = np.hstack([xs, np.ones((npts, 1))])
    if npts == dim_x + 1:
        sol = np.linalg.solve(X, ys)
    else:
        sol, *_ = np.linalg.lstsq(X, ys, rcond=None)
    return sol[:-1].T.copy(), sol[-1].copy()


def simplex_volume(verts):
    """Intrinsic volume of the simplex spanned by ``verts``."""
    verts = np.asarray(verts, dtype=np.float64)
    d = len(verts) - 1
    if d == 0:
        return 1.0
    edges = verts[1:] - verts[:1]
    sv = np.linalg.svd(edges, compute_uv=False)
    return float(np.prod(sv[sv > 1e-10])) / math.factorial(d)


volume = simplex_volume


# Cells --------------------------------------------------------------------

class Cell:
    """A reference cell: vertices plus an entity->vertex topology dict
    ``topology[dim][entity] = (vertex ids...)``.  Derived connectivity
    (sub/super entities, dim0->dim1 adjacency) is computed eagerly."""

    def __init__(self, shape, vertices, topology):
        self.shape = shape
        self.vertices = tuple(map(tuple, vertices))
        self.topology = topology

        # sub_entities[dim][e] = sorted [(dim', e')] contained in (dim, e)
        self.sub_entities = {}
        for dim, ents in topology.items():
            self.sub_entities[dim] = {}
            for e, verts in ents.items():
                vset = frozenset(verts)
                self.sub_entities[dim][e] = sorted(
                    (d2, e2) for d2, ents2 in topology.items()
                    for e2, verts2 in ents2.items() if vset.issuperset(verts2))

        self.super_entities = {d: {e: [] for e in topology[d]} for d in topology}
        for dim, ents in self.sub_entities.items():
            for e, subs in ents.items():
                for d2, e2 in subs:
                    self.super_entities[d2][e2].append((dim, e))

        # connectivity[(dim0, dim1)][entity] = tuple of dim1 neighbours
        self.connectivity = {}
        for dim0 in sorted(topology):
            for dim1 in sorted(topology):
                self.connectivity[(dim0, dim1)] = []
            for e in sorted(topology[dim0]):
                for dim1 in sorted(topology):
                    nbrs = (self.sub_entities[dim0][e] if dim1 < dim0
                            else self.super_entities[dim0][e])
                    self.connectivity[(dim0, dim1)].append(
                        tuple(e2 for d2, e2 in nbrs if d2 == dim1))

        self._split_cache = {}

    def __repr__(self):
        return f"{type(self).__name__}({self.shape!r}, {self.vertices!r})"

    def __hash__(self):
        return hash(type(self))

    def __eq__(self, other):
        if self is other:
            return True
        if not isinstance(other, Cell):
            return NotImplemented
        mine, theirs = self.vertices, other.vertices
        return (len(mine) == len(theirs) and np.allclose(mine, theirs)
                and all(set(self.topology[d].values())
                        == set(other.topology[d].values())
                        for d in self.topology))

    def get_shape(self):
        return self.shape

    def get_vertices(self):
        return self.vertices

    def get_topology(self):
        return self.topology

    def get_connectivity(self):
        return self.connectivity

    def get_spatial_dimension(self):
        return len(self.vertices[0])

    def get_dimension(self):
        return self.get_spatial_dimension()

    def get_vertices_of_subcomplex(self, ids):
        return tuple(self.vertices[i] for i in ids)

    def construct_subelement(self, dimension):
        raise NotImplementedError

    def construct_subcomplex(self, dimension):
        """The subentity of ``dimension`` as a complex: the subelement of
        an unsplit cell (split complexes override it)."""
        if self.get_parent() is None:
            return self.construct_subelement(dimension)
        raise NotImplementedError

    def is_simplex(self):
        return False

    def is_macrocell(self):
        return False

    def get_interior_facets(self, dim):
        return ()

    def get_parent(self):
        return None

    def get_parent_complex(self):
        return None

    def is_parent(self, other, strict=False):
        """Whether ``self`` appears in ``other``'s parent-complex chain
        (including ``other`` itself unless ``strict``)."""
        link = other.get_parent_complex() if strict else other
        while link is not None:
            if self == link:
                return True
            link = link.get_parent_complex()
        return False

    def __ne__(self, other):
        return not self.__eq__(other)

    def __ge__(self, other):
        return other.is_parent(self)

    def __gt__(self, other):
        return other.is_parent(self, strict=True)

    def __le__(self, other):
        return self.is_parent(other)

    def __lt__(self, other):
        return self.is_parent(other, strict=True)


class SimplicialComplex(Cell):
    """A cell made of simplices (a single simplex, or a split complex)."""

    def __init__(self, shape, vertices, topology):
        for dim, ents in topology.items():
            for verts in ents.values():
                if len(verts) != dim + 1:
                    raise ValueError("Entity has wrong vertex count for a simplex")
        super().__init__(shape, vertices, topology)

    # -- geometry -------------------------------------------------------------

    def compute_normal(self, facet_i, cell=None):
        """Outward unit normal to a codimension-1 facet (seen from ``cell``,
        the first cell holding the facet by default; UFC cells override the
        sign convention)."""
        top = self.topology
        sd = self.get_spatial_dimension()
        if cell is None:
            cell = next(k for k, fs in enumerate(self.connectivity[(sd, sd - 1)])
                        if facet_i in fs)
        facet_verts = top[sd - 1][facet_i]
        off_vertex, = set(top[sd][cell]) - set(facet_verts)
        V = np.asarray(self.get_vertices_of_subcomplex(facet_verts))
        r = V[0] - np.asarray(self.vertices[off_vertex])
        if sd == 1 or len(facet_verts) == 1:
            return r / np.linalg.norm(r)
        # component of r orthogonal to the facet span
        T = V[1:] - V[:1]
        coef, *_ = np.linalg.lstsq(T.T, r, rcond=None)
        n = r - T.T @ coef
        return n / np.linalg.norm(n)

    def compute_tangents(self, dim, i):
        vs = np.asarray(self.get_vertices_of_subcomplex(self.topology[dim][i]))
        return vs[1:] - vs[:1]

    def compute_normalized_tangents(self, dim, i):
        ts = self.compute_tangents(dim, i)
        return ts / np.linalg.norm(ts, axis=1)[:, None]

    def compute_edge_tangent(self, edge_i):
        vs = np.asarray(self.get_vertices_of_subcomplex(self.topology[1][edge_i]))
        return vs[1] - vs[0]

    def compute_normalized_edge_tangent(self, edge_i):
        t = self.compute_edge_tangent(edge_i)
        return t / np.linalg.norm(t)

    def compute_face_tangents(self, face_i):
        if self.get_spatial_dimension() != 3:
            raise ValueError("Face tangents only defined in 3D")
        vs = np.asarray(self.get_vertices_of_subcomplex(self.topology[2][face_i]))
        return vs[1:] - vs[:1]

    def compute_face_edge_tangents(self, dim, entity_id):
        """The edge vectors v_b - v_a (a < b) of an entity's vertices."""
        vs = np.asarray(self.get_vertices_of_subcomplex(self.topology[dim][entity_id]))
        pairs = [(a, b) for a in range(dim) for b in range(a + 1, dim + 1)]
        if not pairs:
            return np.zeros((0, vs.shape[1]))
        src, dst = zip(*pairs)
        return vs[list(dst)] - vs[list(src)]

    def compute_scaled_normal(self, facet_i):
        """Normal to facet_i scaled by the facet volume (UFC sign rules in
        2D/3D via tangent rotation / cross product)."""
        sd = self.get_spatial_dimension()
        if sd == 2:
            t, = self.compute_tangents(1, facet_i)
            return np.array([t[1], -t[0]])
        if sd == 3:
            t = self.compute_tangents(2, facet_i)
            return -np.cross(t[0], t[1])
        v = self.volume_of_subcomplex(sd - 1, facet_i)
        return self.compute_normal(facet_i) * v

    def compute_reference_normal(self, facet_dim, facet_i):
        """The outward normal of a facet (no UFC sign override), scaled to
        unit max norm."""
        assert facet_dim == self.get_spatial_dimension() - 1
        n = SimplicialComplex.compute_normal(self, facet_i)
        return n / np.linalg.norm(n, np.inf)

    def volume(self):
        sd = self.get_spatial_dimension()
        return sum(self.volume_of_subcomplex(sd, k) for k in self.topology[sd])

    def volume_of_subcomplex(self, dim, facet_no):
        return simplex_volume(self.get_vertices_of_subcomplex(self.topology[dim][facet_no]))

    # -- points and subentity maps ---------------------------------------------

    def make_points(self, dim, entity_id, order, variant=None, interior=1):
        if dim == 0:
            return (self.get_vertices()[entity_id],)
        if 0 < dim <= self.get_spatial_dimension():
            verts = self.get_vertices_of_subcomplex(self.topology[dim][entity_id])
            return make_lattice(verts, order, interior=interior, variant=variant)
        raise ValueError("Illegal entity dimension")

    def get_cell_connectivity(self):
        """{cell: {dim: [entity ids]}} listing, for each top-level cell,
        its subentities in the reference ordering of the cell's own vertex
        tuple (unlike ``connectivity[(sd, dim)]``, which is sorted)."""
        try:
            return self._cell_connectivity
        except AttributeError:
            pass
        sd = self.get_spatial_dimension()
        top = self.topology
        ref_top = self.construct_subelement(sd).get_topology()
        inv_top = {dim: {top[dim][e]: e for e in top[dim]} for dim in top}
        conn = {}
        for cell in top[sd]:
            cell_verts = top[sd][cell]
            conn[cell] = {dim: [inv_top[dim][tuple(cell_verts[v] for v in ref_top[dim][ref_e])]
                                for ref_e in sorted(ref_top[dim])]
                          for dim in top}
        self._cell_connectivity = conn
        return conn

    def get_entity_transform(self, dim, entity):
        """Map from subentity reference coordinates into this cell."""
        top = self.topology
        sd = self.get_spatial_dimension()
        if dim == 0:
            i, = top[0][entity]
            offset = np.asarray(self.vertices[i])
            C = np.zeros((0, len(offset)))
        elif dim == sd and len(top[sd]) == 1:
            assert entity == 0
            return lambda x: x
        else:
            subcell = self.construct_subelement(dim)
            v_e = np.asarray(subcell.get_vertices())
            v_c = np.asarray(self.get_vertices_of_subcomplex(top[dim][entity]))
            C = np.linalg.solve(v_e[1:] - v_e[:1], v_c[1:] - v_c[:1])
            offset = v_c[0] - v_e[0] @ C

        def transform(point):
            if isinstance(point, torch.Tensor):
                # runtime points: on their device, in their dtype
                if dim == 0:
                    return point.new_tensor(offset).expand(*point.shape[:-1], len(offset))
                return point @ point.new_tensor(C) + point.new_tensor(offset)
            point = np.asarray(point)
            if dim == 0 and point.ndim >= 1 and point.shape[-1] == 0:
                return np.broadcast_to(offset, point.shape[:-1] + offset.shape).copy()
            return point @ C + offset

        return transform

    # -- barycentric machinery -------------------------------------------------

    def barycentric_map(self, entity=None, rescale=False):
        """The affine map (A, b) with barycentric coords = points @ A.T + b
        for the given entity (host f64 numpy); ``rescale`` divides each row
        by its gradient's norm (distances become Euclidean to first order)."""
        sd = self.get_spatial_dimension()
        if entity is None:
            entity = (sd, 0)
        edim, eid = entity
        restrict = slice(None)
        verts_ids = self.topology[edim][eid]
        if edim != sd:
            cell_id = self.connectivity[(edim, sd)][eid][0]
            cell_verts = self.topology[sd][cell_id]
            restrict = [i for i, v in enumerate(cell_verts) if v in verts_ids]
            verts_ids = cell_verts
        A, b = make_affine_mapping(self.get_vertices_of_subcomplex(verts_ids), np.eye(sd + 1))
        A, b = A[restrict], b[restrict]
        if rescale:
            h = 1.0 / np.linalg.norm(A, axis=1)
            A, b = A * h[:, None], b * h
        return A, b

    def compute_barycentric_coordinates(self, points, entity=None, rescale=False):
        """Barycentric coordinates of numpy points (host f64), or of a
        torch tensor on its device in its dtype."""
        if len(points) == 0:
            return points
        A, b = self.barycentric_map(entity=entity, rescale=rescale)
        if hasattr(points, "new_tensor"):
            return points @ points.new_tensor(A.T) + points.new_tensor(b)
        return np.asarray(points, dtype=np.float64) @ A.T + b

    def distance_to_point_l1(self, points, entity=None, rescale=False):
        """L1 distance from points to an entity; 0 inside (sum of negative
        barycentric parts)."""
        bary = self.compute_barycentric_coordinates(points, entity=entity, rescale=rescale)
        return 0.5 * abs((abs(bary) - bary).sum(-1))

    def contains_point(self, point, epsilon=0.0, entity=None):
        return self.distance_to_point_l1(point, entity=entity) <= epsilon

    def point_entity_ids(self, points, tol=1e-10):
        """{dim: {entity: [indices of the points interior to it]}}, each
        point credited to the lowest-dimensional entity holding it."""
        top = self.topology
        sd = self.get_spatial_dimension()
        entity_ids = {d: {e: [] for e in top[d]} for d in top}
        by_verts = {top[d][e]: (d, e) for d in top for e in top[d]}
        seen = []
        for cell in top[sd]:
            cell_verts = top[sd][cell]
            bary = self.compute_barycentric_coordinates(points, entity=(sd, cell))
            dist = 0.5 * abs(np.sum(abs(bary) - bary, axis=-1))
            cand = np.setdiff1d(np.flatnonzero(dist <= tol), seen)
            cand = cand[np.lexsort(bary[cand].T)]
            for i in cand.tolist():
                key = tuple(cell_verts[v] for v in np.flatnonzero(bary[i] > tol))
                d, e = by_verts[key]
                entity_ids[d][e].append(i)
                seen.append(i)
            if len(seen) == len(points):
                break
        return entity_ids


class Simplex(SimplicialComplex):
    """A single reference simplex."""

    def is_simplex(self):
        return True

    def symmetry_group_size(self, dim):
        return math.factorial(dim + 1)

    def cell_orientation_reflection_map(self):
        return ornt.make_cell_orientation_reflection_map_simplex(self.get_dimension())

    def get_facet_element(self):
        return self.construct_subelement(self.get_spatial_dimension() - 1)


class UFCSimplex(Simplex):
    def construct_subelement(self, dimension):
        return ufc_simplex(dimension)


class DefaultSimplex(Simplex):
    def construct_subelement(self, dimension):
        return default_simplex(dimension)


class SymmetricSimplex(Simplex):
    def construct_subelement(self, dimension):
        return symmetric_simplex(dimension)


class Point(Simplex):
    def __init__(self):
        super().__init__(POINT, ((),), {0: {0: (0,)}})

    def construct_subelement(self, dimension):
        assert dimension == 0
        return self


class DefaultLine(DefaultSimplex):
    """Interval [-1, 1]."""
    def __init__(self):
        super().__init__(LINE, ((-1.0,), (1.0,)),
                         {0: {0: (0,), 1: (1,)}, 1: {0: (0, 1)}})


class UFCInterval(UFCSimplex):
    """Interval [0, 1]."""
    def __init__(self):
        super().__init__(LINE, ((0.0,), (1.0,)),
                         {0: {0: (0,), 1: (1,)}, 1: {0: (0, 1)}})


class DefaultTriangle(DefaultSimplex):
    def __init__(self):
        super().__init__(TRIANGLE,
                         ((-1.0, -1.0), (1.0, -1.0), (-1.0, 1.0)),
                         {0: {0: (0,), 1: (1,), 2: (2,)},
                          1: {0: (1, 2), 1: (2, 0), 2: (0, 1)},
                          2: {0: (0, 1, 2)}})


class UFCTriangle(UFCSimplex):
    def __init__(self):
        super().__init__(TRIANGLE,
                         ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0)),
                         {0: {0: (0,), 1: (1,), 2: (2,)},
                          1: {0: (1, 2), 1: (0, 2), 2: (0, 1)},
                          2: {0: (0, 1, 2)}})

    def compute_normal(self, i):
        # UFC-consistent: rotate the edge tangent, no outwardness guarantee
        t = self.compute_tangents(1, i)[0]
        n = np.array([t[1], -t[0]])
        return n / np.linalg.norm(n)


class IntrepidTriangle(Simplex):
    """The UFC triangle's vertices with Intrepid's (Trilinos) edge order."""

    def __init__(self):
        super().__init__(TRIANGLE,
                         ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0)),
                         {0: {0: (0,), 1: (1,), 2: (2,)},
                          1: {0: (0, 1), 1: (1, 2), 2: (2, 0)},
                          2: {0: (0, 1, 2)}})

    def get_facet_element(self):
        return UFCInterval()


class DefaultTetrahedron(DefaultSimplex):
    def __init__(self):
        super().__init__(TETRAHEDRON,
                         ((-1.0, -1.0, -1.0), (1.0, -1.0, -1.0),
                          (-1.0, 1.0, -1.0), (-1.0, -1.0, 1.0)),
                         {0: {i: (i,) for i in range(4)},
                          1: {0: (1, 2), 1: (2, 0), 2: (0, 1),
                              3: (0, 3), 4: (1, 3), 5: (2, 3)},
                          2: {0: (1, 3, 2), 1: (2, 3, 0),
                              2: (3, 1, 0), 3: (0, 1, 2)},
                          3: {0: (0, 1, 2, 3)}})


class IntrepidTetrahedron(Simplex):
    """The UFC tetrahedron's vertices with Intrepid's (Trilinos) edge and
    face order."""

    def __init__(self):
        super().__init__(TETRAHEDRON,
                         ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0),
                          (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)),
                         {0: {i: (i,) for i in range(4)},
                          1: {0: (0, 1), 1: (1, 2), 2: (2, 0),
                              3: (0, 3), 4: (1, 3), 5: (2, 3)},
                          2: {0: (0, 1, 3), 1: (1, 2, 3),
                              2: (0, 3, 2), 3: (0, 2, 1)},
                          3: {0: (0, 1, 2, 3)}})

    def get_facet_element(self):
        return IntrepidTriangle()


class UFCTetrahedron(UFCSimplex):
    def __init__(self):
        super().__init__(TETRAHEDRON,
                         ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0),
                          (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)),
                         {0: {i: (i,) for i in range(4)},
                          1: {0: (2, 3), 1: (1, 3), 2: (1, 2),
                              3: (0, 3), 4: (0, 2), 5: (0, 1)},
                          2: {0: (1, 2, 3), 1: (0, 2, 3),
                              2: (0, 1, 3), 3: (0, 1, 2)},
                          3: {0: (0, 1, 2, 3)}})

    def compute_normal(self, i):
        # UFC-consistent normals: length 2, tangent-cross-product sign
        t = self.compute_tangents(2, i)
        n = np.cross(t[0], t[1])
        return -2.0 * n / np.linalg.norm(n)


# Tensor products ------------------------------------------------------------

class TensorProductCell(Cell):
    """Product of reference cells; entities are products of factor entities,
    numbered lexicographically within each dimension tuple."""

    def __init__(self, *cells):
        vertices = tuple(tuple(chain(*coords))
                         for coords in product(*[c.get_vertices() for c in cells]))
        vshape = tuple(len(c.get_vertices()) for c in cells)
        topology = {}
        for dim in product(*[c.get_topology().keys() for c in cells]):
            tops = [c.get_topology()[d] for c, d in zip(cells, dim)]
            ents = {}
            for key in product(*[sorted(t) for t in tops]):
                vert_tuples = list(product(*[t[e] for t, e in zip(tops, key)]))
                ents[key] = tuple(np.ravel_multi_index(np.transpose(vert_tuples), vshape))
            topology[dim] = dict(enumerate(ents[k] for k in sorted(ents)))
        super().__init__(TENSORPRODUCT, vertices, topology)
        self.cells = tuple(cells)

    def __repr__(self):
        return f"{type(self).__name__}({self.cells!r})"

    def __hash__(self):
        return hash((type(self), self.cells))

    @staticmethod
    def _split_slices(lengths):
        offs = np.cumsum([0, *lengths])
        return [slice(a, b) for a, b in zip(offs[:-1], offs[1:])]

    def get_dimension(self):
        return tuple(c.get_dimension() for c in self.cells)

    def construct_subelement(self, dimension):
        return TensorProductCell(*[c.construct_subelement(d)
                                   for c, d in zip(self.cells, dimension)])

    def construct_subcomplex(self, dimension):
        return TensorProductCell(*[c.construct_subcomplex(d)
                                   for c, d in zip(self.cells, dimension)])

    def get_entity_transform(self, dim, entity_i):
        """Map from the product subentity's coordinates into this cell:
        each factor's transform on its own slice of the coordinates."""
        shape = tuple(len(c.get_topology()[d]) for c, d in zip(self.cells, dim))
        alpha = np.unravel_index(entity_i, shape)
        maps = [c.get_entity_transform(d, i) for c, d, i in zip(self.cells, dim, alpha)]
        slices = self._split_slices(dim)

        def transform(point):
            if isinstance(point, torch.Tensor):
                return torch.cat([t(point[..., s]) for t, s in zip(maps, slices)], dim=-1)
            point = np.asarray(point)
            return np.concatenate([t(point[..., s]) for t, s in zip(maps, slices)], axis=-1)
        return transform

    def volume(self):
        return float(np.prod([c.volume() for c in self.cells]))

    def compute_reference_normal(self, facet_dim, facet_i):
        assert len(facet_dim) == len(self.get_dimension())
        diff = np.array(self.get_dimension()) - np.array(facet_dim)
        (which,), = np.nonzero(diff)
        n = []
        for i, c in enumerate(self.cells):
            if i == which:
                n.extend(c.compute_reference_normal(facet_dim[i], facet_i))
            else:
                n.extend([0] * c.get_spatial_dimension())
        return np.asarray(n)

    def contains_point(self, point, epsilon=0.0):
        slices = self._split_slices(self.get_dimension())
        point = np.asarray(point)
        return reduce(lambda a, b: a & b,
                      (c.contains_point(point[..., s], epsilon=epsilon)
                       for c, s in zip(self.cells, slices)), True)

    def distance_to_point_l1(self, point, rescale=False):
        slices = self._split_slices(self.get_dimension())
        point = np.asarray(point)
        return sum(c.distance_to_point_l1(point[..., s], rescale=rescale)
                   for c, s in zip(self.cells, slices))

    def point_entity_ids(self, points, tol=1e-10):
        points = np.asarray(points)
        slices = self._split_slices(self.get_dimension())
        factor_ids = [c.point_entity_ids(points[..., s], tol=tol)
                      for c, s in zip(self.cells, slices)]
        top = self.get_topology()
        out = {dim: {e: [] for e in top[dim]} for dim in top}
        for dims in product(*factor_ids):
            pieces = [A[d] for A, d in zip(factor_ids, dims)]
            for entity, ents in enumerate(product(*pieces)):
                sets = [set(A[d][e]) for A, d, e in zip(factor_ids, dims, ents)]
                out[dims][entity].extend(sorted(set.intersection(*sets)))
        return out

    def symmetry_group_size(self, dim):
        return tuple(c.symmetry_group_size(d) for d, c in zip(dim, self.cells))

    def cell_orientation_reflection_map(self):
        return ornt.make_cell_orientation_reflection_map_tensorproduct(self.cells)

    def extract_extrinsic_orientation(self, o):
        return o // 2 ** len(self.cells)

    def extract_intrinsic_orientation(self, o, axis):
        dim = len(self.cells)
        if axis >= dim:
            raise ValueError(f"axis must be < {dim}")
        return o % 2 ** dim // 2 ** (dim - 1 - axis) % 2

    @property
    def extrinsic_orientation_permutation_map(self):
        dim = len(self.cells)
        a = np.zeros((math.factorial(dim), dim, dim), dtype=int)
        perms = ornt.make_entity_permutations_simplex(dim - 1, 2)
        ai = np.array(list(perms.values()), dtype=int).reshape((math.factorial(dim), dim, 1))
        np.put_along_axis(a, ai, 1, axis=2)
        return a

    def is_macrocell(self):
        return any(c.is_macrocell() for c in self.cells)

    def _compare(self, op, other):
        if hasattr(other, "product"):
            other = other.product
        if isinstance(other, TensorProductCell):
            return all(op(a, b) for a, b in zip(self.cells, other.cells))
        return op(self, other)

    def __gt__(self, other):
        return self._compare(operator.gt, other)

    def __lt__(self, other):
        return self._compare(operator.lt, other)

    def __ge__(self, other):
        return self._compare(operator.ge, other)

    def __le__(self, other):
        return self._compare(operator.le, other)


# Hypercubes (flattened tensor products) ----------------------------------------

class Hypercube(Cell):
    """A tensor-product cell of intervals presented with flat (integer)
    entity dimensions."""

    def __init__(self, dimension, tp):
        self.dimension = dimension
        super().__init__(HYPERCUBE_SHAPES[dimension], tp.get_vertices(),
                         flatten_entities(tp.get_topology()))
        self.product = tp
        self.unflattening_map = compute_unflattening_map(tp.get_topology())

    def construct_subelement(self, dimension):
        sd = self.get_spatial_dimension()
        if dimension > sd:
            raise ValueError("Invalid subentity dimension")
        if dimension == sd:
            return self
        sub = self.product.construct_subelement((dimension,) + (0,) * (len(self.product.cells) - 1))
        return flatten_reference_cube(sub)

    def get_entity_transform(self, dim, entity_i):
        d, e = self.unflattening_map[(dim, entity_i)]
        return self.product.get_entity_transform(d, e)

    def volume(self):
        return self.product.volume()

    def compute_reference_normal(self, facet_dim, facet_i):
        assert facet_dim == self.get_spatial_dimension() - 1
        d, i = self.unflattening_map[(facet_dim, facet_i)]
        return self.product.compute_reference_normal(d, i)

    def contains_point(self, point, epsilon=0.0):
        return self.product.contains_point(point, epsilon=epsilon)

    def distance_to_point_l1(self, point, rescale=False):
        return self.product.distance_to_point_l1(point, rescale=rescale)

    def point_entity_ids(self, points, tol=1e-10):
        product_ids = self.product.point_entity_ids(points, tol=tol)
        where = self.unflattening_map
        return {dim: {e: product_ids[where[(dim, e)][0]][where[(dim, e)][1]]
                      for e in self.topology[dim]}
                for dim in self.topology}

    def symmetry_group_size(self, dim):
        return math.factorial(dim) * 2 ** dim

    def cell_orientation_reflection_map(self):
        return self.product.cell_orientation_reflection_map()

    def __gt__(self, other):
        return self.product > other

    def __lt__(self, other):
        return self.product < other

    def __ge__(self, other):
        return self.product >= other

    def __le__(self, other):
        return self.product <= other


class UFCHypercube(Hypercube):
    """[0, 1]^d, vertices in lexicographic order."""

    def __init__(self, dim):
        super().__init__(dim, TensorProductCell(*[UFCInterval()] * dim))

    def construct_subelement(self, dimension):
        sd = self.get_spatial_dimension()
        if dimension > sd:
            raise ValueError("Invalid subentity dimension")
        if dimension == sd:
            return self
        return ufc_hypercube(dimension)


class UFCQuadrilateral(UFCHypercube):
    def __init__(self):
        super().__init__(2)


class UFCHexahedron(UFCHypercube):
    def __init__(self):
        super().__init__(3)


# Factories --------------------------------------------------------------------

def default_simplex(spatial_dim):
    return {0: Point, 1: DefaultLine, 2: DefaultTriangle, 3: DefaultTetrahedron}[spatial_dim]()


def ufc_simplex(spatial_dim):
    return {0: Point, 1: UFCInterval, 2: UFCTriangle, 3: UFCTetrahedron}[spatial_dim]()


def symmetric_simplex(spatial_dim):
    """The simplex centred at the origin with all edges of length 2."""
    A = np.array([[2.0, 1.0, 1.0],
                  [0.0, np.sqrt(3.0), np.sqrt(3.0) / 3],
                  [0.0, 0.0, np.sqrt(6.0) * (2.0 / 3)]])
    A = A[:spatial_dim, :spatial_dim]
    b = A.sum(axis=1) * (-1.0 / (1 + spatial_dim))
    ref = ufc_simplex(spatial_dim)
    verts = np.dot(ref.get_vertices(), A.T) + b[None, :]
    return SymmetricSimplex(ref.get_shape(), tuple(map(tuple, verts)), ref.get_topology())


def ufc_hypercube(spatial_dim):
    return {0: Point, 1: UFCInterval, 2: UFCQuadrilateral, 3: UFCHexahedron}[spatial_dim]()


def ufc_cell(cell):
    """The UFC cell of a name ("triangle", "quadrilateral", ...; products
    spelled "interval * interval") or of an object with ``cellname``."""
    name = cell if isinstance(cell, str) else cell.cellname
    if " * " in name:
        return TensorProductCell(*map(ufc_cell, name.split(" * ")))
    table = {"quadrilateral": UFCQuadrilateral, "hexahedron": UFCHexahedron,
             "vertex": Point, "interval": UFCInterval,
             "triangle": UFCTriangle, "tetrahedron": UFCTetrahedron}
    if name not in table:
        raise ValueError(f"Unknown UFC cell {name!r}")
    return table[name]()


# Flattening helpers ---------------------------------------------------------------

def tuple_sum(tree):
    if isinstance(tree, tuple):
        return sum(map(tuple_sum, tree))
    return tree


def is_ufc(cell):
    if isinstance(cell, (Point, UFCInterval, UFCHypercube, UFCSimplex)):
        return True
    if isinstance(cell, TensorProductCell):
        return all(is_ufc(c) for c in cell.cells)
    return False


def is_hypercube(cell):
    if isinstance(cell, (DefaultLine, UFCInterval, Hypercube)):
        return True
    if isinstance(cell, TensorProductCell):
        return all(is_hypercube(c) for c in cell.cells)
    return False


def flatten_reference_cube(ref_el):
    """Present a tensor product of intervals as the flat UFC hypercube."""
    if ref_el.get_spatial_dimension() <= 1:
        return ref_el
    if isinstance(ref_el, TensorProductCell):
        if is_ufc(ref_el):
            return ufc_hypercube(ref_el.get_spatial_dimension())
        return Hypercube(ref_el.get_spatial_dimension(), ref_el)
    if is_hypercube(ref_el):
        return ref_el
    raise TypeError("Not a hypercube-like cell")


def flatten_entities(topology_dict):
    """Flatten a tensor-product topology (tuple dims) to integer dims."""
    flat = defaultdict(list)
    for dim in sorted(topology_dict):
        flat[tuple_sum(dim)] += [v for _, v in sorted(topology_dict[dim].items())]
    return {dim: dict(enumerate(ents)) for dim, ents in flat.items()}


def flatten_permutations(perm_dict):
    """Flatten tensor-product entity permutations (tuple dims, tuple
    orientations) to integer dims and orientations."""
    flat = defaultdict(list)
    for dim in sorted(perm_dict):
        flat[tuple_sum(dim)] += [{o: v[o_tuple] for o, o_tuple in enumerate(sorted(v))}
                                 for _, v in sorted(perm_dict[dim].items())]
    return {dim: dict(enumerate(perms)) for dim, perms in flat.items()}


def compute_unflattening_map(topology_dict):
    """{(flat dim, flat entity): (tuple dim, entity)} of a product topology."""
    counters = defaultdict(count)
    out = {}
    for dim, ents in sorted(topology_dict.items()):
        flat_dim = tuple_sum(dim)
        for e in ents:
            out[(flat_dim, next(counters[flat_dim]))] = (dim, e)
    return out


def max_complex(complexes):
    """The complex that refines every other one of ``complexes``."""
    biggest = max(complexes)
    if all(biggest >= c for c in complexes):
        return biggest
    raise ValueError("No maximal complex")
