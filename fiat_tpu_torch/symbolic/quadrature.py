"""Quadrature for the symbolic layer: tensor-product aware rule
construction with spectrally-tagged point sets; weights are plain host
arrays (product-structured for TP rules).  Counterpart of
``fiat_tpu/symbolic/quadrature.py`` (role of FInAT's
``finat/quadrature.py``), on the port's ``core.quadrature`` and
``core.quadrature_schemes``."""

import hashlib
from abc import ABCMeta, abstractmethod
from functools import cached_property, reduce

import numpy as np

from ..core import cells as cl
from ..core.quadrature import GaussLegendreQuadratureLineRule
from ..core.quadrature_schemes import create_quadrature as fiat_scheme
from .point_set import (GaussLegendrePointSet, GaussLobattoLegendrePointSet,
                        KMVPointSet, PointSet, TensorPointSet)


def make_quadrature(ref_el, degree, scheme="default"):
    """A rule exact to ``degree`` with the appropriately tagged point set
    (tensor products of rules on tensor-product cells)."""
    shape = ref_el.get_shape()
    if shape == cl.TENSORPRODUCT:
        degrees = tuple(degree) if np.ndim(degree) else \
            (degree,) * len(ref_el.cells)
        assert len(ref_el.cells) == len(degrees)
        return TensorProductQuadratureRule(
            [make_quadrature(c, d, scheme)
             for c, d in zip(ref_el.cells, degrees)], ref_el=ref_el)
    if shape == cl.QUADRILATERAL:
        return make_quadrature(ref_el.product, degree, scheme)
    if degree < 0:
        raise ValueError(f"Need positive degree, not {degree}")

    # pick the numeric rule and the point-set TAG together: spectral
    # tags let consumers collapse tabulations to deltas
    if scheme.lower() in {"kmv", "lump"}:
        rule = fiat_scheme(ref_el, degree, "KMV")
        tag = GaussLobattoLegendrePointSet if shape == cl.LINE \
            else KMVPointSet
    elif shape == cl.LINE and not ref_el.is_macrocell():
        rule = GaussLegendreQuadratureLineRule(ref_el, (degree + 2) // 2)
        tag = GaussLegendrePointSet
    else:
        rule = fiat_scheme(ref_el, degree, scheme)
        tag = PointSet
    return QuadratureRule(
        tag(rule.get_points()), rule.get_weights(), ref_el=ref_el,
        io_ornt_map_tuple=rule._intrinsic_orientation_permutation_map_tuple)


class AbstractQuadratureRule(metaclass=ABCMeta):
    """A point set plus weights."""

    def __hash__(self):
        digest = hashlib.md5(repr(self).encode()).digest()
        return int.from_bytes(digest, byteorder="big")

    def __eq__(self, other):
        return type(other) is type(self) and repr(other) == repr(self)

    @abstractmethod
    def __repr__(self):
        pass

    @property
    @abstractmethod
    def point_set(self):
        pass

    @property
    @abstractmethod
    def weight_expression(self):
        """Weights array, shaped like the point set's points_shape."""

    @cached_property
    def extrinsic_orientation_permutation_map(self):
        if self.ref_el is None:
            raise ValueError("Must set ref_el")
        return self.ref_el.extrinsic_orientation_permutation_map

    @cached_property
    def intrinsic_orientation_permutation_map_tuple(self):
        maps = self._intrinsic_orientation_permutation_map_tuple
        if any(m is None for m in maps):
            raise ValueError("intrinsic orientation maps not set")
        return maps


class QuadratureRule(AbstractQuadratureRule):
    """An unstructured rule."""

    def __init__(self, point_set, weights, ref_el=None,
                 io_ornt_map_tuple=(None,)):
        weights = np.asarray(weights)
        assert len(point_set.points) == len(weights)
        self.ref_el = ref_el
        self.point_set = point_set
        self.weights = weights
        self._intrinsic_orientation_permutation_map_tuple = io_ornt_map_tuple

    def __repr__(self):
        return (f"{type(self).__name__}({self.point_set!r}, "
                f"{self.weights!r}, {self.ref_el!r})")

    @cached_property
    def point_set(self):
        pass  # set at initialisation

    @property
    def weight_expression(self):
        return self.weights


class TensorProductQuadratureRule(AbstractQuadratureRule):
    """A product of rules; weights stay factored (outer product applied
    lazily, so integrations can ride the factored structure)."""

    def __init__(self, factors, ref_el=None):
        self.ref_el = ref_el
        self.factors = tuple(factors)
        self._intrinsic_orientation_permutation_map_tuple = tuple(
            m for q in factors
            for m in q._intrinsic_orientation_permutation_map_tuple)

    def __repr__(self):
        return f"{type(self).__name__}({self.factors!r}, {self.ref_el!r})"

    @cached_property
    def point_set(self):
        return TensorPointSet(q.point_set for q in self.factors)

    @property
    def weight_expression(self):
        """Dense outer product of the factor weights (points_shape)."""
        return reduce(np.multiply.outer, self.factor_weights)

    @property
    def factor_weights(self):
        """The factored weights, one vector per factor."""
        return tuple(np.asarray(q.weight_expression)
                     for q in self.factors)
