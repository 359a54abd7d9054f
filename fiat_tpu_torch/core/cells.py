"""Reference simplices: geometry and topology, host-side and static.

Counterpart of the simplex part of ``fiat_tpu/core/cells.py`` (UFC
conventions).  Cells are plain Python objects whose data (vertices,
entity->vertex topology, lattices, affine entity transforms) parameterise
the tabulation kernels; everything here is float64 numpy.
Tensor-product cells, hypercubes and split complexes are not ported yet.
"""

import math

import numpy as np

from .recursive_nodes import recursive_node

POINT = "point"
LINE = "line"
TRIANGLE = "triangle"
TETRAHEDRON = "tetrahedron"


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


# Cells --------------------------------------------------------------------

class Simplex:
    """A reference simplex: vertices plus an entity->vertex topology dict
    ``topology[dim][entity] = (vertex ids...)``, with the sub-entities of
    every entity derived eagerly."""

    def __init__(self, shape, vertices, topology):
        for dim, ents in topology.items():
            for verts in ents.values():
                if len(verts) != dim + 1:
                    raise ValueError("Entity has wrong vertex count for a simplex")
        self.shape = shape
        self.vertices = tuple(map(tuple, vertices))
        self.topology = topology

        self.sub_entities = {}
        for dim, ents in topology.items():
            self.sub_entities[dim] = {}
            for e, verts in ents.items():
                vset = frozenset(verts)
                self.sub_entities[dim][e] = sorted(
                    (d2, e2) for d2, ents2 in topology.items()
                    for e2, verts2 in ents2.items() if vset.issuperset(verts2))

    def __repr__(self):
        return f"{type(self).__name__}({self.shape!r}, {self.vertices!r})"

    def __eq__(self, other):
        if self is other:
            return True
        if not isinstance(other, Simplex):
            return NotImplemented
        mine, theirs = self.vertices, other.vertices
        return (len(mine) == len(theirs) and np.allclose(mine, theirs)
                and all(set(self.topology[d].values())
                        == set(other.topology[d].values())
                        for d in self.topology))

    def __hash__(self):
        return hash(type(self))

    # -- accessors ----------------------------------------------------------

    def get_shape(self):
        return self.shape

    def get_vertices(self):
        return self.vertices

    def get_topology(self):
        return self.topology

    def get_spatial_dimension(self):
        return len(self.vertices[0])

    def get_dimension(self):
        return self.get_spatial_dimension()

    def get_vertices_of_subcomplex(self, ids):
        return tuple(self.vertices[i] for i in ids)

    def is_macrocell(self):
        return False

    def get_parent(self):
        return None

    def symmetry_group_size(self, dim):
        return math.factorial(dim + 1)

    def construct_subelement(self, dimension):
        raise NotImplementedError

    # -- geometry -----------------------------------------------------------

    def volume(self):
        sd = self.get_spatial_dimension()
        return sum(self.volume_of_subcomplex(sd, k) for k in self.topology[sd])

    def volume_of_subcomplex(self, dim, facet_no):
        return simplex_volume(self.get_vertices_of_subcomplex(self.topology[dim][facet_no]))

    def make_points(self, dim, entity_id, order, variant=None, interior=1):
        if dim == 0:
            return (self.get_vertices()[entity_id],)
        if 0 < dim <= self.get_spatial_dimension():
            verts = self.get_vertices_of_subcomplex(self.topology[dim][entity_id])
            return make_lattice(verts, order, interior=interior, variant=variant)
        raise ValueError("Illegal entity dimension")

    def get_entity_transform(self, dim, entity):
        """Map from subentity reference coordinates into this cell."""
        top = self.topology
        sd = self.get_spatial_dimension()
        if dim == sd:
            assert entity == 0
            return lambda x: x
        if dim == 0:
            i, = top[0][entity]
            offset = np.asarray(self.vertices[i])
            C = np.zeros((0, len(offset)))
        else:
            subcell = self.construct_subelement(dim)
            v_e = np.asarray(subcell.get_vertices())
            v_c = np.asarray(self.get_vertices_of_subcomplex(top[dim][entity]))
            C = np.linalg.solve(v_e[1:] - v_e[:1], v_c[1:] - v_c[:1])
            offset = v_c[0] - v_e[0] @ C

        def transform(point):
            point = np.asarray(point)
            if dim == 0 and point.ndim >= 1 and point.shape[-1] == 0:
                return np.broadcast_to(offset, point.shape[:-1] + offset.shape).copy()
            return point @ C + offset

        return transform


class Point(Simplex):
    def __init__(self):
        super().__init__(POINT, ((),), {0: {0: (0,)}})

    def construct_subelement(self, dimension):
        assert dimension == 0
        return self


class DefaultSimplex(Simplex):
    def construct_subelement(self, dimension):
        return default_simplex(dimension)


class UFCSimplex(Simplex):
    def construct_subelement(self, dimension):
        return ufc_simplex(dimension)


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


def default_simplex(spatial_dim):
    return {0: Point, 1: DefaultLine, 2: DefaultTriangle, 3: DefaultTetrahedron}[spatial_dim]()


def ufc_simplex(spatial_dim):
    return {0: Point, 1: UFCInterval, 2: UFCTriangle, 3: UFCTetrahedron}[spatial_dim]()
