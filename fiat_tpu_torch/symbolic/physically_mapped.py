"""Physical-geometry-aware ("zany") element machinery.

Counterpart of ``fiat_tpu/symbolic/physically_mapped.py`` (role of FInAT's
``finat/physically_mapped.py``): the basis transformation matrix M is
assembled as a numpy OBJECT array whose entries are scalars -- python
floats for constants, and for geometry-dependent entries whatever the
geometry callbacks return: numpy scalars for static geometry, 0-d torch
tensors on the geometry's device for tensor geometry (also under
``torch.func.vmap`` over a mesh's cells, where fiat_tpu traces jnp
scalars under ``jax.jit`` / ``jax.vmap``).  Once assembled it is
densified -- numpy f64, or one float64 tensor on the geometry's device --
and applied as one dense product; the dual transformation inverts the
*dense* matrix with real linalg.  Only the tiny Jacobian-sized object
matrices (built before densification) keep scalar-level algebra, done by
Leibniz expansion.

No entry of M ever leaves its device: numpy cannot take a CUDA tensor (nor
any tensor under vmap), so tensors enter object arrays entrywise
(``assign``, ``as_scalar``) and never through numpy's conversion."""

from abc import ABCMeta, abstractmethod
from collections.abc import Mapping
from itertools import permutations

import numpy as np
import torch

from .base import _tensordot
from .citations import cite
from .point_set import _is_traced


def as_scalar(s):
    """A geometry scalar as an operand of object-array arithmetic: a tensor
    is wrapped in a 0-d object array (an object ndarray times a tensor
    raises ``TypeError``, in place or not); anything else passes as it is."""
    if not _is_traced(s):
        return s
    out = np.empty((), dtype=object)
    out[()] = s
    return out


def assign(V, index, value):
    """``V[index] = value`` on an object array, entrywise where ``value`` is
    a tensor or a sequence holding tensors: numpy would convert those to
    host arrays to broadcast them.  A tensor scalar fills every selected
    entry (a single entry takes it as it is); a sequence fills them in
    order."""
    seq = isinstance(value, (list, tuple))
    src = np.empty(np.shape(V[index]), dtype=object)
    if src.ndim == 0 or not (_is_traced(value) or (seq and any(_is_traced(v) for v in value))):
        V[index] = value
        return
    for k, idx in enumerate(np.ndindex(src.shape)):
        src[idx] = value[k] if seq else value
    V[index] = src


def to_dense(M):
    """Densify an object matrix of scalars: numpy f64 if every entry is
    static, else one float64 tensor on the device of the first tensor
    entry (the constants go there in one copy).  Real arrays and tensors
    pass through untouched."""
    if _is_traced(M):
        return M
    M = np.asarray(M)
    if M.dtype != object:
        return M.astype(np.float64)
    flat = M.ravel()
    live = [k for k, v in enumerate(flat) if _is_traced(v)]
    if not live:
        return M.astype(np.float64)
    like = flat[live[0]]
    consts = np.array([0.0 if _is_traced(v) else v for v in flat], dtype=np.float64)
    # entry k of M is entry k of consts, or, for the j-th tensor entry,
    # entry M.size + j of consts followed by the stacked tensor entries:
    # one gather on the device
    order = np.arange(flat.size)
    order[live] = flat.size + np.arange(len(live))
    values = torch.stack([flat[k].to(torch.float64) for k in live])
    both = torch.cat([torch.as_tensor(consts, device=like.device), values])
    return both[torch.as_tensor(order, device=like.device)].reshape(M.shape)


class NeedsCoordinateMappingElement(metaclass=ABCMeta):
    """Elements that require physical information to map or construct
    their basis."""

    def dual_transformation(self, Q, coordinate_mapping=None):
        raise NotImplementedError(
            f"Dual evaluation for {type(self).__name__} is not implemented.")


class MappedTabulation(Mapping):
    """Lazy tabulation view applying a (dense, row-restricted) basis
    transformation per requested derivative table.  A numpy operand joins
    a tensor operand on its device; a tensor never goes to the host."""

    def __init__(self, M, ref_tabulation, indices=None):
        M = to_dense(M)
        self.M = M if indices is None else M[list(indices)]
        self.tables = ref_tabulation
        self._cache = {}

    def __getitem__(self, alpha):
        if alpha not in self._cache:
            self._cache[alpha] = _tensordot(self.M, self.tables[alpha], ((1,), (0,)))
        return self._cache[alpha]

    def __iter__(self):
        return iter(self.tables)

    def __len__(self):
        return len(self.tables)


class PhysicallyMappedElement(NeedsCoordinateMappingElement):
    """Mixin applying a physical basis transformation to tabulations."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for paper in ("Kirby2018zany", "Kirby2019zany"):
            cite(paper)
        self.restriction_indices = None

    @abstractmethod
    def basis_transformation(self, coordinate_mapping):
        """Object matrix M (entries: floats, numpy or tensor scalars)."""

    def map_tabulation(self, ref_tabulation, coordinate_mapping):
        assert coordinate_mapping is not None
        return MappedTabulation(self.basis_transformation(coordinate_mapping),
                                ref_tabulation,
                                indices=self.restriction_indices)

    def basis_evaluation(self, order, ps, entity=None, coordinate_mapping=None):
        return self.map_tabulation(
            super().basis_evaluation(order, ps, entity=entity),
            coordinate_mapping)

    def dual_transformation(self, Q, coordinate_mapping=None):
        """Dual weights transform by inv(M).T -- computed densely: constrained
        columns (beyond the square part) drop first, then one real matrix
        inverse (``torch.linalg.inv`` on the geometry's device for a tensor
        M) instead of FInAT's symbolic block inversion."""
        M = to_dense(self.basis_transformation(coordinate_mapping))
        square = M[:, :M.shape[0]]
        if _is_traced(square):
            M_dual = torch.linalg.inv(square.T)
        else:
            M_dual = np.linalg.inv(np.transpose(square))
        keep = self.restriction_indices
        if keep is not None:
            M_dual = M_dual[list(keep)][:, list(keep)]
        return MappedTabulation(M_dual, {None: Q})[None]


class DirectlyDefinedElement(NeedsCoordinateMappingElement):
    """Elements defined directly in physical space (direct serendipity)."""


class PhysicalGeometry(metaclass=ABCMeta):
    """Geometry callback protocol: each method returns an ARRAY (numpy for
    static geometry, a torch tensor on its device otherwise)."""

    @abstractmethod
    def cell_size(self):
        """Cell size at each vertex, shape (nvertex,)."""

    @abstractmethod
    def jacobian_at(self, point):
        """Jacobian of physical coordinates at a reference point,
        shape (gdim, tdim)."""

    @abstractmethod
    def detJ_at(self, point):
        """Jacobian determinant at a reference point (scalar)."""

    @abstractmethod
    def reference_normals(self):
        """Unit reference facet normals, shape (nfacet, tdim)."""

    @abstractmethod
    def physical_normals(self):
        """Unit physical facet normals, shape (nfacet, gdim)."""

    @abstractmethod
    def physical_tangents(self):
        """Unit physical facet tangents, shape (nfacet, gdim)."""

    @abstractmethod
    def physical_edge_lengths(self):
        """Physical edge lengths, shape (nfacet,)."""

    @abstractmethod
    def physical_points(self, point_set, entity=None):
        """Physical locations of reference points, shape
        points_shape + (gdim,)."""

    @abstractmethod
    def physical_vertices(self):
        """Physical vertex locations, shape (nvertex, gdim)."""

    def normalized_reference_edge_tangents(self):
        """Unit reference edge tangents, shape (nedge, tdim)."""
        raise NotImplementedError(
            f"normalized_reference_edge_tangents not provided by {type(self)}")


# -- scalar-level algebra for tiny (Jacobian-sized) object matrices ----------
#
# Only determinants/adjugates of 2x2 and 3x3 geometry matrices are ever
# formed symbolically (inside basis_transformation assembly, before
# densification), so Leibniz expansion over signed permutations is both
# the simplest and an exactly-sized algorithm.

def identity(*shape):
    V = np.empty(shape * 2 if len(shape) == 1 else shape, dtype=object)
    for ij in np.ndindex(V.shape):
        V[ij] = 1.0 if ij[0] == ij[1] else 0.0
    return V


def _signed_perms(n):
    for p in permutations(range(n)):
        inversions = sum(a > b for k, a in enumerate(p) for b in p[k + 1:])
        yield (-1.0) ** inversions, p


def determinant(A):
    """det(A) by Leibniz expansion (entries are scalars, n is tiny)."""
    n = A.shape[0]
    det = 1.0 if n == 0 else 0.0
    for sgn, p in _signed_perms(n):
        term = sgn
        for row, col in enumerate(p):
            term = term * A[row, col]
        det = det + term
    return det


def adjugate(A):
    """adj(A), via the entrywise derivative of the Leibniz sum:
    d det / dA[i, j] is the (i, j) cofactor, i.e. adj(A)[j, i]."""
    n = A.shape[0]
    C = np.full((n, n), 0.0, dtype=object)
    for sgn, p in _signed_perms(n):
        for hole in range(n):
            term = sgn
            for row, col in enumerate(p):
                if row != hole:
                    term = term * A[row, col]
            C[p[hole], hole] = C[p[hole], hole] + term
    return C
