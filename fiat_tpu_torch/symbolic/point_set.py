"""Point set abstractions for the symbolic element layer.

Counterpart of ``fiat_tpu/symbolic/point_set.py`` (role of FInAT's
``finat/point_set.py``): where FInAT attaches GEM free indices and
expressions, a point set carries an ARRAY of points -- host numpy for
points known at construction, or a torch tensor (``UnknownPointSet``) for
runtime points, on its device and in its dtype, where fiat_tpu traces a
jnp array inside ``jax.jit``.  The "expression" of a point set is the
array itself; structure (tensor product, facet batches) lives in
``points_shape``.

Design notes vs the reference: equality/matching goes through one
``almost_equal`` protocol on the base class with a per-subclass
``_matches`` hook; the tensor-product point grid is built by iterated
kron-style repeat/tile instead of a python cartesian product; the tagged
spectral point families are stamped out from a name list."""

import abc
import zlib
from functools import cached_property

import numpy as np
import torch

from ..ops.kernels import resolve_device


def _is_traced(x):
    """Is x a runtime (torch) array, as opposed to host numpy?  fiat_tpu's
    test for a traced jax array."""
    return isinstance(x, torch.Tensor)


def flat_points(ps):
    """The (N, dim) flattened point array of any point set."""
    pts = ps.points
    # explicit leading size: reshape(-1, 0) is ambiguous for 0-dim cells
    npts = int(np.prod(pts.shape[:-1], dtype=int))
    return pts.reshape(npts, pts.shape[-1])


class AbstractPointSet(abc.ABC):
    """A set of evaluation points, possibly structured.

    ``points`` has shape points_shape + (dimension,)."""

    @abc.abstractmethod
    def __repr__(self):
        pass

    def __hash__(self):
        # deterministic across processes (feeds persistent cache keys)
        return zlib.crc32(repr(self).encode())

    @property
    @abc.abstractmethod
    def points(self):
        """Array of points, shape (num points, point dimension)."""

    @property
    def dimension(self):
        return self.points.shape[-1]

    @property
    def points_shape(self):
        """The structural shape of the point batch (excluding the
        coordinate axis); tabulations carry these as trailing axes."""
        return self.points.shape[:-1]

    @property
    def expression(self):
        """The points array itself (the TPU-native 'symbolic' form)."""
        return self.points

    def almost_equal(self, other, tolerance=1e-12):
        """Same structure and (numerically) the same points."""
        return type(self) is type(other) and self._matches(other, tolerance)

    def _matches(self, other, tol):
        mine, theirs = self.points, other.points
        return (mine.shape == theirs.shape
                and not _is_traced(mine) and not _is_traced(theirs)
                and np.allclose(mine, theirs, rtol=0, atol=tol))


class PointSingleton(AbstractPointSet):
    """A single point; tabulations have no point axis."""

    def __init__(self, point):
        if not _is_traced(point):
            point = np.asarray(point)
        assert point.ndim == 1
        self.point = point

    def __repr__(self):
        return f"{type(self).__name__}({self.point!r})"

    @cached_property
    def points(self):
        return self.point.reshape(1, -1)

    points_shape = ()


class PointSet(AbstractPointSet):
    """An unstructured vector of known points."""

    def __init__(self, points):
        if not _is_traced(points):
            points = np.asarray(points)
        assert points.ndim == 2
        self._points = points

    def __repr__(self):
        return f"{type(self).__name__}({self._points!r})"

    @property
    def points(self):
        return self._points


class UnknownPointSet(PointSet):
    """Runtime points: a torch tensor on a device.  Tabulating an element on
    an UnknownPointSet runs the tabulation at runtime points as torch
    operations on that device, in the points' dtype (the role of FInAT's
    runtime gem.Variable points; fiat_tpu traces a jnp array under jit).

    ``device``: where the points go -- the current CUDA card when None
    (raising without one), the CPU only where the caller asks for it
    (``ops.kernels.resolve_device``).  A tensor keeps its dtype; host
    points become float64."""

    def __init__(self, points_expr, device=None):
        device = resolve_device(device)
        if isinstance(points_expr, torch.Tensor):
            points_expr = points_expr.to(device)
        else:
            points_expr = torch.as_tensor(np.asarray(points_expr, dtype=np.float64),
                                          device=device)
        assert points_expr.ndim == 2
        self._points = points_expr

    def __repr__(self):
        return f"{type(self).__name__}(shape={self._points.shape})"

    def almost_equal(self, other, tolerance=1e-12):
        return self is other


class KMVPointSet(PointSet):
    """Tagged KMV lumped points on a simplex."""


class _IntervalPointSet(PointSet):
    """Tagged 1D point family (spectral-identity shortcut marker)."""

    def __init__(self, points):
        super().__init__(points)
        assert self.dimension == 1


class GaussLegendrePointSet(_IntervalPointSet):
    """Tagged interval Gauss-Legendre points (spectral DG shortcut)."""


class GaussLobattoLegendrePointSet(_IntervalPointSet):
    """Tagged interval GLL points (spectral CG shortcut)."""


class TensorPointSet(AbstractPointSet):
    """Product-structured points: the TP tabulation path evaluates each
    factor on its own axis (explicit sum factorisation)."""

    def __init__(self, factors):
        self.factors = tuple(factors)

    def __repr__(self):
        return f"{type(self).__name__}({self.factors!r})"

    @cached_property
    def points(self):
        """Full grid by iterated repeat/tile: rows of the running grid
        repeat over each new factor's rows, coordinates concatenate (on the
        factors' device when their points are tensors)."""
        rows = [flat_points(factor) for factor in self.factors]
        tensors = [r for r in rows if _is_traced(r)]
        if not tensors:
            grid = np.zeros((1, 0))
            for r in rows:
                grid = np.hstack([np.repeat(grid, len(r), axis=0),
                                  np.tile(r, (len(grid), 1))])
            return grid
        grid = tensors[0].new_zeros((1, 0))
        for r in rows:
            r = torch.as_tensor(r, dtype=grid.dtype, device=grid.device)
            grid = torch.cat([grid.repeat_interleave(len(r), dim=0),
                              r.repeat(len(grid), 1)], dim=1)
        return grid

    @property
    def points_shape(self):
        return sum((f.points_shape for f in self.factors), ())

    def _matches(self, other, tol):
        return (len(self.factors) == len(other.factors)
                and all(a.almost_equal(b, tolerance=tol)
                        for a, b in zip(self.factors, other.factors)))


class FacetPointSet(AbstractPointSet):
    """A reference point set mapped onto every same-dimension facet;
    tabulations get a leading facet axis in their point shape."""

    def __init__(self, cell, ps):
        self.cell = cell
        self.ps = ps

    def __repr__(self):
        return f"{type(self).__name__}({self.ps!r})"

    @cached_property
    def entities(self):
        """All (dim, entity) of the cell whose dimension matches the
        reference points (TP dims count by their sum)."""
        want = self.ps.dimension
        return [(dim, ent)
                for dim, ents in sorted(self.cell.topology.items())
                for ent in sorted(ents)
                if (sum(dim) if isinstance(dim, tuple) else dim) == want]

    @cached_property
    def points(self):
        ref = self.ps.points
        return np.concatenate([self.cell.get_entity_transform(*e)(ref)
                               for e in self.entities])

    @property
    def points_shape(self):
        return (len(self.entities),) + self.ps.points_shape

    def _matches(self, other, tol):
        return (self.cell == other.cell
                and self.ps.almost_equal(other.ps, tolerance=tol))
