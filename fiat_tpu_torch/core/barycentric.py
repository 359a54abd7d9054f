"""Exact 1D nodal (Lagrange) bases via barycentric interpolation.

Counterpart of ``fiat_tpu/core/barycentric.py`` (Berrut & Trefethen 2004):
values from the second barycentric formula, derivatives from the spectral
differentiation matrix.  Host-side numpy, and torch for tensor points (the
symbolic layer's tensor path); the 1D Lagrange and DG elements use it as
their nodal basis.
"""

import numpy as np
import torch

from . import cells as cl
from . import expansions
from . import polyset


def get_lagrange_points(nodes):
    """The (single) support point of each point-evaluation node."""
    points = []
    for node in nodes:
        pt, = node.get_point_dict()
        points.append(pt)
    return points


def make_dmat(x):
    """(differentiation matrix, barycentric weights) for nodes x."""
    diff = np.add.outer(-x, x)
    np.fill_diagonal(diff, 1.0)
    wts = 1.0 / np.prod(diff, axis=0)
    dmat = np.divide.outer(wts, wts) / diff
    np.fill_diagonal(dmat, 0.0)
    np.fill_diagonal(dmat, -np.sum(dmat, axis=0))
    return dmat, wts


def barycentric_interpolation(nodes, wts, dmat, pts, order=0):
    """dict (k,) -> k-th derivative tabulation (num_nodes, npts) of the
    Lagrange basis on ``nodes`` by the second barycentric formula; a torch
    tensor of points runs the same formula on its device, in its dtype."""
    if isinstance(pts, torch.Tensor):
        diff = pts.reshape(1, -1) - pts.new_tensor(nodes)[:, None]
        phi = pts.new_tensor(wts)[:, None] / diff
        phi = phi / phi.sum(dim=0)
        phi = torch.where(torch.isnan(phi), 1.0, phi).reshape(-1, *pts.shape[:-1])
        D = pts.new_tensor(dmat)
        results = {(0,): phi}
        for r in range(1, order + 1):
            phi = D @ phi
            results[(r,)] = phi
        return results
    pts = np.asarray(pts)
    diff = np.add.outer(-nodes, pts.flatten())
    with np.errstate(divide="ignore", invalid="ignore"):
        phi = wts[:, None] / diff
        phi = phi / np.sum(phi, axis=0)
    # at a node the formula is 0/0: the basis function is 1 there, others 0
    phi = np.where(np.isnan(phi), 1.0, phi)
    phi = phi.reshape(-1, *pts.shape[:-1])
    results = {(0,): phi}
    for r in range(1, order + 1):
        phi = np.dot(dmat, phi)
        results[(r,)] = phi
    return results


class LagrangeLineExpansionSet(expansions.LineExpansionSet):
    """Nodal expansion set on given 1D points of an interval or of a split
    interval: the nodes are binned to the subintervals that hold them
    (``cell_node_map``), each subinterval with its own nodes, weights and
    differentiation matrix.  Where neighbouring subintervals share a node
    the basis is C0 (``continuity``)."""

    def __init__(self, ref_el, pts):
        self.points = pts
        self.x = np.asarray(pts, dtype=np.float64).flatten()
        self.cell_node_map = expansions.compute_cell_point_map(ref_el, pts, unique=False)
        self.dmats = [None] * len(self.cell_node_map)
        self.weights = [None] * len(self.cell_node_map)
        self.nodes = [None] * len(self.cell_node_map)
        for cell, ibfs in self.cell_node_map.items():
            self.nodes[cell] = self.x[ibfs if ibfs is not Ellipsis else slice(None)]
            self.dmats[cell], self.weights[cell] = make_dmat(self.nodes[cell])
        self.degree = max(len(w) for w in self.weights) - 1
        self.recurrence_order = self.degree + 1
        super().__init__(ref_el)
        self.continuity = (None if len(self.x) == sum(len(xk) for xk in self.nodes)
                           else "C0")

    def get_num_members(self, n):
        return len(self.points)

    def get_cell_node_map(self, n):
        return self.cell_node_map

    def get_points(self):
        return self.points

    def get_dmats(self, degree, cell=0):
        return [self.dmats[cell].T]

    def _tabulate_on_cell(self, n, pts, order=0, cell=0):
        return barycentric_interpolation(self.nodes[cell], self.weights[cell],
                                         self.dmats[cell], pts, order=order)


class LagrangePolynomialSet(polyset.PolynomialSet):
    """The 1D nodal basis itself as a PolynomialSet (identity coefficients),
    avoiding any Vandermonde round-off."""

    def __init__(self, ref_el, pts, shape=()):
        if ref_el.get_shape() != cl.LINE:
            raise ValueError("Invalid reference element type.")
        expansion_set = LagrangeLineExpansionSet(ref_el, pts)
        degree = expansion_set.degree
        coeffs = polyset._component_identity_coeffs(shape, expansion_set.get_num_members(degree))
        super().__init__(ref_el, degree, degree, expansion_set, coeffs)
